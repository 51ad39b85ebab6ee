"""DoNeRF-style single-trunk radiance MLP (``netarch = 'donerf'``): one
D-layer trunk over the encoded position with the encoded view direction
re-injected at a skip layer, a final linear layer emitting [rgb, sigma],
ReLU elsewhere, Kaiming-normal weights.

Counterpart of ``pronerf_tpu/models/donerf.py``, with the reference's
skip-grammar parser (``"0::63-7:63:"``: entries ``layer::end`` /
``layer:start:end`` name the input-feature range a layer consumes;
``'auto'`` injects the view features at layer D*7//8). The nets are
``nn.Linear``s (``weight`` [out, in]); ``convert.donerf_from_numpy``
carries the JAX package's ``{'layers': [{'w', 'b'} x D]}`` over.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from pronerf_tpu_torch.models.mlp import _linear


def parse_skip_grammar(skip: str, n_in: int) -> Dict[int, Tuple[int, int]]:
    """``"0::63-7:63:"`` -> {0: (0, 63), 7: (63, n_in)}."""
    locations: Dict[int, Tuple[int, int]] = {}
    if not skip:
        return {0: (0, n_in)}
    for part in skip.split("-"):
        m = re.search(r"^([0-9]+)(:?)([0-9]*)(:?)([0-9]*)$", part)
        if not m:
            raise ValueError(f"bad skip entry {part!r}")
        loc = int(m.group(1))
        has_first, start, has_mid, end = (
            m.group(2), m.group(3), m.group(4), m.group(5)
        )
        if has_first == "" and has_mid == "":
            locations[loc] = (0, n_in)
        elif has_first == ":" and has_mid == "":
            single = int(start + end)
            locations[loc] = (single, single + 1)
        else:
            locations[loc] = (
                int(start) if start else 0,
                int(end) if end else n_in,
            )
    locations.setdefault(0, (0, n_in))
    return locations


def auto_skip(D: int, pos_ch: int = 63, skip_layer: int = 7) -> str:
    return f"0::{pos_ch}-{D * skip_layer // 8}:{pos_ch}:"


class DoNeRFMLP(nn.Module):
    """[..., pos_ch], [..., dir_ch] -> [..., n_out] (rgb logits, sigma).

    ``skip`` is the layer that takes ``[h | d_pe]``: D * skip_layer // 8
    (the reference's 'auto' rule). Weights ~ N(0, 2 / fan_in) (torch's
    ``kaiming_normal_`` default: fan-in mode, the ReLU gain), drawn on the
    CPU from ``generator``, layer by layer; biases zero."""

    def __init__(self, D: int = 8, W: int = 256, pos_ch: int = 63,
                 dir_ch: int = 27, n_out: int = 4, skip_layer: int = 7,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.skip = D * skip_layer // 8
        layers, in_dim = [], pos_ch
        for i in range(D):
            if i == self.skip and i != 0:
                in_dim += dir_ch
            out_dim = n_out if i == D - 1 else W
            std = (2.0 / in_dim) ** 0.5
            lin = nn.Linear(in_dim, out_dim, device="meta")
            lin.weight = nn.Parameter(
                (std * torch.randn(out_dim, in_dim, generator=g)).to(device))
            lin.bias = nn.Parameter(torch.zeros(out_dim, device=device))
            layers.append(lin)
            in_dim = out_dim
        self.layers = nn.ModuleList(layers)

    def forward(self, x_pe, d_pe, compute_dtype=None):
        """``d_pe`` per point ([..., S, Cd], matching ``x_pe``).
        ``compute_dtype=torch.bfloat16``: bf16 operands, f32 accumulation,
        each product rounded to bf16, as the NeRF MLP's serving path."""
        h = x_pe
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            if i == self.skip and i != 0:
                h = torch.cat([h, d_pe.to(h.dtype)], dim=-1)
            h = _linear(layer, h, compute_dtype)
            if i + 1 < n:
                h = torch.relu(h)
        return h if compute_dtype is None else h.to(x_pe.dtype)


def init_donerf(generator: Optional[torch.Generator] = None, D: int = 8,
                W: int = 256, pos_ch: int = 63, dir_ch: int = 27,
                n_out: int = 4, skip_layer: int = 7,
                device=None) -> DoNeRFMLP:
    """Kaiming-normal weights from ``generator``, zero biases."""
    return DoNeRFMLP(D, W, pos_ch, dir_ch, n_out, skip_layer, generator,
                     device)


def donerf_apply(net: DoNeRFMLP, x_pe, d_pe, compute_dtype=None):
    """The JAX package's ``donerf_apply``: ``net`` on [..., pos_ch] and
    [..., dir_ch] -> [..., n_out]."""
    return net(x_pe, d_pe, compute_dtype)
