"""Carry parameters and scenes from the JAX package into the port, as numpy
arrays (the port imports nothing of ``pronerf_tpu`` and no ``jax``; the
caller turns its pytree into numpy first, e.g. with ``jax.tree_util.tree_map(
np.asarray, params)``).

Layout of the JAX parameter pytree::

    {'nerf': {'pts': [{'w', 'b'} x 8], 'alpha', 'feature', 'views', 'rgb'},
     'sampler': {'layers': [{'w', 'b'} x 6], 'out'},
     'refine':  {'layers': [{'w', 'b'} x 6], 'out'}}

and with ``netarch = 'donerf'`` the radiance net is ``{'layers': [{'w',
'b'} x D]}`` (``models.donerf``), told apart by its keys.

There ``w`` is stored ``[in, out]`` (``y = x @ w + b``). The port's nets are
``nn.Linear``s, whose ``weight`` is stored ``[out, in]`` (``y = x @
weight.T + b``), so every ``w`` is transposed on the way in. Both then
compute the same function.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pronerf_tpu_torch.models.donerf import DoNeRFMLP
from pronerf_tpu_torch.models.mlp import MinMaxMLP, NeRFMLP
from pronerf_tpu_torch.render.raygen import prepare_scene


def _load_linear(lin: nn.Linear, p, device) -> None:
    w = np.asarray(p["w"], np.float32)  # [in, out]
    b = np.asarray(p["b"], np.float32)
    if tuple(lin.weight.shape) != (w.shape[1], w.shape[0]):
        raise ValueError(
            f"layer shape [in, out] = {w.shape} does not fit a Linear "
            f"with weight {tuple(lin.weight.shape)}"
        )
    lin.weight = nn.Parameter(torch.from_numpy(w.T.copy()).to(device))
    lin.bias = nn.Parameter(torch.from_numpy(b.copy()).to(device))


def _skips_of(layers, input_ch: int):
    """Layers whose successor consumes [input | hidden]: the skips."""
    W = np.asarray(layers[0]["w"]).shape[1]
    return tuple(
        i - 1 for i, layer in enumerate(layers)
        if i > 0 and np.asarray(layer["w"]).shape[0] == W + input_ch
    )


def nerf_from_numpy(tree, device="cpu") -> NeRFMLP:
    pts = tree["pts"]
    W = np.asarray(pts[0]["w"]).shape[1]
    input_ch = np.asarray(pts[0]["w"]).shape[0]
    input_ch_views = np.asarray(tree["views"]["w"]).shape[0] - W
    net = NeRFMLP(len(pts), W, input_ch, input_ch_views,
                  _skips_of(pts, input_ch), device=device)
    for lin, p in zip(net.pts, pts):
        _load_linear(lin, p, device)
    for name in ("alpha", "feature", "views", "rgb"):
        _load_linear(getattr(net, name), tree[name], device)
    return net


def donerf_from_numpy(tree, device="cpu") -> DoNeRFMLP:
    """A DoNeRF tree ``{'layers': [{'w', 'b'} x D]}``: widths from the
    first and last layers, the view width from the one layer that takes
    more inputs than its predecessor gives (it must sit where the 'auto'
    rule puts the skip, D * 7 // 8)."""
    layers = tree["layers"]
    shapes = [np.asarray(p["w"]).shape for p in layers]
    D, (pos_ch, W), n_out = len(shapes), shapes[0], shapes[-1][1]
    grown = [i for i in range(1, D) if shapes[i][0] != shapes[i - 1][1]]
    if len(grown) != 1 or grown[0] != D * 7 // 8:
        raise ValueError(f"DoNeRF layers of shapes {shapes}: the view "
                         f"features must enter at layer {D * 7 // 8} alone")
    dir_ch = shapes[grown[0]][0] - shapes[grown[0] - 1][1]
    net = DoNeRFMLP(D, W, pos_ch, dir_ch, n_out, device=device)
    for lin, p in zip(net.layers, layers):
        _load_linear(lin, p, device)
    return net


def radiance_from_numpy(tree, device="cpu"):
    """The radiance net of either family, by its keys: the NeRF MLP
    (``pts``, heads) or DoNeRF (``layers`` alone)."""
    if "pts" not in tree and "layers" in tree:
        return donerf_from_numpy(tree, device)
    return nerf_from_numpy(tree, device)


def minmax_from_numpy(tree, device="cpu") -> MinMaxMLP:
    layers = tree["layers"]
    W = np.asarray(layers[0]["w"]).shape[1]
    input_ch = np.asarray(layers[0]["w"]).shape[0]
    output_ch = np.asarray(tree["out"]["w"]).shape[1]
    net = MinMaxMLP(len(layers), W, input_ch, output_ch,
                    _skips_of(layers, input_ch), device=device)
    for lin, p in zip(net.layers, layers):
        _load_linear(lin, p, device)
    _load_linear(net.out, tree["out"], device)
    return net


def params_from_numpy(tree, device="cpu"):
    """The JAX package's parameter pytree (numpy leaves, ``w`` as
    [in, out]) as the port's ``{'nerf', 'sampler', 'refine'}`` modules."""
    return {
        "nerf": radiance_from_numpy(tree["nerf"], device),
        "sampler": minmax_from_numpy(tree["sampler"], device),
        "refine": minmax_from_numpy(tree["refine"], device),
    }


def ranges_from_numpy(ranges, device="cpu"):
    """The JAX package's int8 calibration ranges (``calibrate_nerf_ranges``:
    name -> (min [C], max [C]), numpy leaves) as float32 tensors, for
    ``kernels.fused_nerf_q.pack_nerf_params_int8(net, ranges=...)``."""
    return {
        name: tuple(
            torch.from_numpy(np.array(a, np.float32)).to(device) for a in pair
        )
        for name, pair in ranges.items()
    }


def packed_q_from_numpy(packed, device="cpu"):
    """The JAX package's int8 pack (``pack_nerf_params_int8``, numpy leaves)
    as the port's: int8 panels stay int8, float32 columns float32, and the
    PE panels (bfloat16 there, which numpy holds as an extension type) cross
    through float32, which holds every bfloat16 value exactly."""
    out = {}
    for name, a in packed.items():
        a = np.asarray(a)
        if a.dtype in (np.int8, np.float32):
            out[name] = torch.from_numpy(a.copy()).to(device)
        else:
            out[name] = torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
    return out


def scene_from_numpy(images, poses, K, pack_corners="u8", device="cpu"):
    """The port's scene bundle from the arrays the JAX package's
    ``prepare_scene`` takes: images [T, H, W, 3], poses [T, 3, 4], K [3, 3]."""
    return prepare_scene(
        np.asarray(images, np.float32), np.asarray(poses, np.float32),
        np.asarray(K, np.float32), pack_corners=pack_corners, device=device,
    )
