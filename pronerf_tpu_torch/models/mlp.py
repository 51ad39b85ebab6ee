"""The three ProNeRF MLPs as ``nn.Module``s.

Architectures:
- NeRF MLP: D=8, W=256, ReLU, skip re-injecting the encoded position after
  layer 4; separate alpha head, feature head, one 128-wide view branch, rgb
  head.
- MinMaxRay MLP (used for BOTH the sampler and the refine net, different
  in/out widths): D=6, W=256, ELU, linear output; release configs set skips
  to [1000]/[10000], i.e. effectively none.

Weights are ``nn.Linear``s, so ``weight`` is stored [out, in] (the JAX
package stores ``w`` as [in, out]; ``convert.params_from_numpy`` transposes).
Init matches ``torch.nn.Linear``'s bound, U(-1/sqrt(fan_in), +1/sqrt(fan_in))
for weights and biases, drawn from an explicit ``torch.Generator``.

``compute_dtype=None`` is the f32 parity path (full-precision matmuls: the
package switches TF32 off). ``compute_dtype=torch.bfloat16`` is the serving
path: bf16 operands, f32 accumulation, every dot rounded to bf16, f32 master
weights.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def init_linear(fan_in: int, fan_out: int, generator: torch.Generator,
                device=None) -> nn.Linear:
    """An ``nn.Linear`` with weight and bias ~ U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), drawn on the CPU from ``generator``."""
    bound = 1.0 / (fan_in ** 0.5)
    lin = nn.Linear(fan_in, fan_out, device="meta")
    w = (torch.rand(fan_out, fan_in, generator=generator) * 2 - 1) * bound
    b = (torch.rand(fan_out, generator=generator) * 2 - 1) * bound
    lin.weight = nn.Parameter(w.to(device))
    lin.bias = nn.Parameter(b.to(device))
    return lin


def _dot(x, lin_w, cdt):
    """x [..., in] times an [out, in] weight: operands in ``cdt``, f32
    accumulation, rounded to ``cdt``."""
    return (x.to(cdt).float() @ lin_w.to(cdt).float().T).to(cdt)


def _linear(lin: nn.Linear, x, cdt):
    if cdt is None:
        return F.linear(x, lin.weight, lin.bias)
    return _dot(x, lin.weight, cdt) + lin.bias.to(cdt)


class NeRFMLP(nn.Module):
    """Radiance field: [..., 63], [..., 27] -> [..., 4] (rgb logits, sigma)."""

    def __init__(self, D: int = 8, W: int = 256, input_ch: int = 63,
                 input_ch_views: int = 27, skips: Sequence[int] = (4,),
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.skips = tuple(skips)
        self.W = W
        pts, in_dim = [], input_ch
        for i in range(D):
            pts.append(init_linear(in_dim, W, g, device))
            # Layer i's output is concatenated with the input when i is a
            # skip, so layer i+1 consumes W + input_ch.
            in_dim = W + input_ch if i in self.skips else W
        self.pts = nn.ModuleList(pts)
        self.alpha = init_linear(W, 1, g, device)
        self.feature = init_linear(W, W, g, device)
        self.views = init_linear(W + input_ch_views, W // 2, g, device)
        self.rgb = init_linear(W // 2, 3, g, device)

    def forward(self, x_pe, d_pe, compute_dtype=None):
        """``d_pe`` may be per-point ([..., S, Cd], matching x_pe) or, on the
        ``compute_dtype`` path, per-ray ([..., Cd], one rank lower), in which
        case the direction term of the view branch is computed once a ray."""
        if compute_dtype is not None:
            return self._forward_serving(x_pe, d_pe, compute_dtype)
        h = x_pe
        for i, layer in enumerate(self.pts):
            h = torch.relu(_linear(layer, h, None))
            if i in self.skips:
                h = torch.cat([x_pe, h], dim=-1)
        alpha = _linear(self.alpha, h, None)
        feature = _linear(self.feature, h, None)
        h = torch.relu(_linear(self.views, torch.cat([feature, d_pe], -1), None))
        return torch.cat([_linear(self.rgb, h, None), alpha], dim=-1)

    def _forward_serving(self, x_pe, d_pe, cdt):
        """bf16 serving forward: same math with the skip concatenation as
        two split dots (``x @ w[:C] + h @ w[C:]``, each rounded) and a per-ray
        ``d_pe`` driving the view branch once per ray."""
        x = x_pe.to(cdt)
        C = x.shape[-1]
        h = x
        for i, layer in enumerate(self.pts):
            if i - 1 in self.skips:
                w = layer.weight  # [out, C + W]
                h = _dot(x, w[:, :C], cdt) + _dot(h, w[:, C:], cdt) \
                    + layer.bias.to(cdt)
            else:
                h = _dot(h, layer.weight, cdt) + layer.bias.to(cdt)
            h = torch.relu(h)
        alpha = _linear(self.alpha, h, cdt)
        feature = _linear(self.feature, h, cdt)
        wv = self.views.weight  # [128, W + Cd]
        W_ = feature.shape[-1]
        d = d_pe.to(cdt)
        hd = _dot(d, wv[:, W_:], cdt)
        if d.dim() == x.dim() - 1:
            hd = hd[..., None, :]
        hv = torch.relu(
            _dot(feature, wv[:, :W_], cdt) + hd + self.views.bias.to(cdt)
        )
        rgb = _linear(self.rgb, hv, cdt)
        return torch.cat([rgb, alpha], dim=-1).to(x_pe.dtype)


class MinMaxMLP(nn.Module):
    """Sampler/refine net: [..., in] -> [..., out] (linear output)."""

    def __init__(self, D: int = 6, W: int = 256, input_ch: int = 288,
                 output_ch: int = 27, skips: Sequence[int] = (),
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.skips = tuple(skips)
        layers, in_dim = [], input_ch
        for i in range(D):
            layers.append(init_linear(in_dim, W, g, device))
            in_dim = W + input_ch if i in self.skips else W
        self.layers = nn.ModuleList(layers)
        self.out = init_linear(W, output_ch, g, device)

    def forward(self, x, compute_dtype=None):
        cdt = compute_dtype
        x_in = x if cdt is None else x.to(cdt)
        h = x_in
        for i, layer in enumerate(self.layers):
            h = F.elu(_linear(layer, h, cdt))
            if i in self.skips:
                h = torch.cat([x_in, h], dim=-1)
        out = _linear(self.out, h, cdt)
        return out if cdt is None else out.to(x.dtype)


def minmax_mlp_apply_folded(net: MinMaxMLP, x_rep, reps: int, x_rest,
                            compute_dtype):
    """Serving-path MinMax forward whose input is ``[tile(x_rep, reps) |
    x_rest]`` WITHOUT materializing the tiling: the first layer's columns for
    the repeated block are pre-summed (``tile(v, k) @ w == v @ sum_k
    w_block`` in exact arithmetic), so the [N, reps*C] input never exists.

    Used because the ProNeRF Pluecker ray signature is constant along a ray
    (m = p x d_hat is invariant under p -> p + t d), making the 48-point
    (sampler) / 8-point (refine) encodings exact tilings.

    Args:
      x_rep: [N, C] the repeated block (one Pluecker signature per ray).
      reps: tile count (48 sampler, 8 refine).
      x_rest: [N, R] trailing non-repeated features (refine's warped
        colors), or None.
    """
    if net.skips:
        raise ValueError("folded path supports the release no-skip nets")
    cdt = compute_dtype
    layers = list(net.layers)
    w0 = layers[0].weight  # [256, reps*C + rest]
    C = x_rep.shape[-1]
    w_rep = w0[:, : reps * C].reshape(-1, reps, C).sum(1)  # [256, C]

    h = _dot(x_rep, w_rep, cdt)
    if x_rest is not None:
        h = h + _dot(x_rest, w0[:, reps * C:], cdt)
    h = F.elu(h + layers[0].bias.to(cdt))
    for layer in layers[1:]:
        h = F.elu(_linear(layer, h, cdt))
    return _linear(net.out, h, cdt).to(x_rep.dtype)
