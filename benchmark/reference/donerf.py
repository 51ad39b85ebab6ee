"""A plain float32 ProNeRF with the DoNeRF radiance net, in PyTorch: the
reference of the configuration that serves ``netarch = donerf``.

The release's ``infer --use-trt`` driver (``run_S_eS_eN_alter_trt.py``)
builds its radiance net as ``DoNeRFTRT`` (``run_nerf_helpers.py``) with the
skip ``'auto'``, which is the grammar ``"0::63-7:63:"``: layer 0 reads the
63 channels of the encoded point, layers 1..6 are 256 -> 256, and layer 7
reads ``[h ‖ d_pe]`` (256 + 27) and returns 4 channels, ``[rgb logits,
sigma]``; ReLU after every layer but the last. The rest of the frame is
``reference/pronerf.py``'s: the sampler, the sort, the windowed epipolar
gather, the refine net, the compositing with the sampler's corrections.

Departures from ``DoNeRFTRT``:
- weights: the release serves an fp16 engine (``nerf_fp16.trt``) built from
  trained weights, which the repo does not hold (its stage-2 checkpoint
  holds a NeRF MLP); here ``DoNeRFTRT``'s own init, Kaiming normal with zero
  biases, drawn from a seed with NumPy (``draw_weights``);
- precision: every product is a float32 matrix product with TF32 off, not
  the engine's fp16; ``quant`` rounds both operands of every MLP product,
  as in ``reference.pronerf``;
- the encodings, which ``DoNeRFTRT``'s two-argument forward takes from
  outside: ``reference.pronerf.posenc`` (``[x, sin 2^k x, cos 2^k x]``, 10
  octaves for the point, 4 for the direction), the direction's once a ray
  and handed to each of its samples.

Weights are a dict ``'<net>.<layer>.weight|bias'`` of tensors, ``weight``
stored [out, in]: ``donerf.layers.<i>`` beside the sampler and refine nets
of ``reference.pronerf.weights_from_tree``. It imports nothing of the
program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import pronerf as ref
from .scene import ndc_rays, rays_for_pose

DEPTH, WIDTH, SKIP, POS_CH, DIR_CH, OUT = 8, 256, 7, 63, 27, 4


def draw_weights(seed: int, D: int = DEPTH, W: int = WIDTH,
                 skip: int = SKIP, outputs: int = OUT):
    """The DoNeRF net's weights drawn from ``seed`` with NumPy, in the JAX
    package's pytree form ``{'layers': [{'w' [in, out], 'b'}]}``: ``D``
    layers, ``W`` wide, the last returning ``outputs`` channels; w ~
    N(0, 2 / fan_in) (Kaiming normal, fan-in, the ReLU gain), b = 0; the
    view features entering at layer ``skip``."""
    rng = np.random.default_rng(seed)
    layers, fan_in = [], POS_CH
    for i in range(D):
        if i == skip and i != 0:
            fan_in += DIR_CH
        out = outputs if i == D - 1 else W
        w = rng.standard_normal((fan_in, out)) * np.sqrt(2.0 / fan_in)
        layers.append({"w": w.astype(np.float32),
                       "b": np.zeros(out, np.float32)})
        fan_in = out
    return {"layers": layers}


def weights_from_tree(donerf, sampler, refine, device="cpu"):
    """The DoNeRF net and the sampler and refine nets of JAX pytrees as the
    reference's weight dict."""
    out = {}
    for i, p in enumerate(donerf["layers"]):
        ref._layer(out, f"donerf.layers.{i}", p, device)
    for net, tree in (("sampler", sampler), ("refine", refine)):
        for i, p in enumerate(tree["layers"]):
            ref._layer(out, f"{net}.layers.{i}", p, device)
        ref._layer(out, f"{net}.out", tree["out"], device)
    return out


def trunk(P, x_pe, d_pe, quant=None, skip: int = SKIP):
    """The DoNeRF net on [..., 63] and [..., 27] -> [..., 4]."""
    n = sum(1 for k in P if k.startswith("donerf.layers.")
            and k.endswith(".weight"))
    h = x_pe
    for i in range(n):
        if i == skip:
            h = torch.cat([h, d_pe], -1)
        h = ref._lin(P, f"donerf.layers.{i}", h, quant)
        if i + 1 < n:
            h = torch.relu(h)
    return h


def render_rays(P, rays, scene, views, N_samples=8, n_enc=48, quant=None,
                window_rows=0, skip: int = SKIP):
    """One batch of rays on the serving path (``reference.pronerf.SERVE``),
    the radiance net DoNeRF's; ``rays`` and ``views`` as
    ``reference.pronerf.render_rays`` takes them."""
    st = ref.SERVE
    S, near, far = N_samples, st["near"], st["far"]
    o, d = rays["ndc_o"], rays["ndc_d"]
    N = o.shape[0]

    t = torch.linspace(0.0, 1.0, n_enc, device=o.device)
    sig = ref.plucker(o[:, None] + d[:, None] * t[None, :, None], d[:, None])
    mm = ref.minmax(P, "sampler", sig.reshape(N, -1), quant)
    depth = torch.sigmoid(mm[:, :S]) * (far - near) + near
    depth, order = torch.sort(depth, dim=-1, stable=True)
    mm_add = mm[:, S:2 * S].gather(1, order)
    mm_mul = mm[:, 2 * S:3 * S].gather(1, order)
    z3d = 1.0 / (1.0 - depth - st["eps"])

    col = ref.epipolar_colors(scene, views, rays["or_o"], rays["or_d"], z3d,
                              window_rows)
    plk = ref.plucker(o[:, None] + d[:, None] * depth[..., None], d[:, None])
    rf = ref.minmax(P, "refine",
                    torch.cat([plk.reshape(N, -1), col.reshape(N, -1)], -1),
                    quant)
    mids = 0.5 * (depth[:, 1:] + depth[:, :-1])
    upper = torch.cat([mids, 0.5 * (far + depth[:, -1:])], -1)
    lower = torch.cat([0.5 * (near + depth[:, :1]), mids], -1)
    z = lower + (upper - lower) * torch.sigmoid(rf[:, :S])

    pts = o[:, None] + d[:, None] * z[..., None]
    pts = pts + 1e-2 * torch.tanh(rf[:, S:4 * S]).reshape(N, S, 3)
    d_pe = ref.posenc(rays["viewdirs"], 4)[:, None].expand(N, S, DIR_CH)
    raw = trunk(P, ref.posenc(pts, 10), d_pe, quant, skip)
    comp = ref.composite(raw, z, d, mm_add, mm_mul)
    return {"rgb1": comp["rgb"], "depth": comp["depth"],
            "rgb0": torch.sigmoid(rf[:, 4 * S:]),
            "mm_rgb": torch.sigmoid(mm[:, 3 * S:]),
            "depth0": z.mean(-1)}


@torch.no_grad()
def render_frame(P, scene, c2w, H: int, W: int, K, num_neighbor: int = 4,
                 block: int = 1 << 16, quant=None, windows=None,
                 skip: int = SKIP):
    """``reference.pronerf.render_frame`` with the DoNeRF net: rgb1, rgb0,
    mm_rgb [H, W, 3], depth, depth0 [H, W] at ``c2w``. ``skip`` is the layer
    that reads the view features (7, the release's)."""
    window_rows = 0
    if windows is not None:
        tiles, window_rows = windows
        if (H * W) % tiles:
            raise ValueError(f"{H}x{W} rays do not cut into {tiles} tiles")
        block = H * W // tiles
    or_o, or_d = rays_for_pose(H, W, K, c2w)
    dist = torch.linalg.norm(scene["poses"][:, :3, 3] - c2w[:3, 3], dim=-1)
    views = torch.argsort(dist, stable=True)[:num_neighbor]
    outs = {k: [] for k in ref.FRAME_KEYS}
    for lo in range(0, H * W, block):
        o, d = or_o[lo:lo + block], or_d[lo:lo + block]
        n_o, n_d = ndc_rays(H, W, float(K[0][0]), o, d)
        rays = {"ndc_o": n_o, "ndc_d": n_d, "or_o": o, "or_d": d,
                "viewdirs": d / torch.linalg.norm(d, dim=-1, keepdim=True)}
        out = render_rays(P, rays, scene, views, quant=quant,
                          window_rows=window_rows, skip=skip)
        for k in ref.FRAME_KEYS:
            outs[k].append(out[k])
    shapes = {"depth": (H, W), "depth0": (H, W)}
    return {k: torch.cat(v).reshape(shapes.get(k, (H, W, 3)))
            for k, v in outs.items()}
