"""Fused positional encoding -> NeRF MLP (8x256, skip after layer 4, view
branch), returning raw ``[N, S, 4]`` or the alpha-composited ray: packing,
the plain PyTorch versions, and the wrappers that launch the CUDA kernels of
``csrc/fused_nerf.cu``.

Counterpart of ``pronerf_tpu/kernels/fused_nerf.py`` with the same contract:
query points come transposed as ``pts24_t [S*3, N]`` (row ``3*s + c``), the
per-ray view contribution as ``vcon_t [128, N] = (d_pe @ views_w[256:]).T``
(bias excluded), rays contiguous in both.

Rounding points (part of the function, shared by kernels and plain versions):
points are cast to the pack dtype; ``xb = bx_t . x`` is rounded, ``sin``/
``cos`` are evaluated in f32 on it and rounded; every dot takes operands in
the pack dtype, accumulates in f32 and is rounded; biases are added in the
pack dtype; layer 5 adds two separately rounded dots; ``vcon`` is cast to the
pack dtype before it is added; the heads are returned as f32 and all
compositing arithmetic is f32.

Each kernel is a ``torch.library`` op (``pronerf::fused_nerf_raw``,
``pronerf::fused_nerf_composite``) that a traced program can name: its CUDA
implementation launches the kernel (or raises) and counts the launch, its
CPU implementation is the plain version, its fake one gives the shapes. The
blob the kernel reads is built at pack time (``attach_blobs``) and handed to
the op as a tensor.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pronerf_tpu_torch.kernels.stages import (  # noqa: F401 (re-exported)
    SLAB_K,
    SLAB_ROW_BYTES,
    STAGE_BYTES,
    halves,
    images,
    pad_k,
    slabs,
)
from pronerf_tpu_torch.kernels.stages import stage_table as _stage_table

L_PTS = 10     # position octaves: PE = [x(3), sin(30), cos(30)]
L_DIR = 4      # direction octaves: PE = [d(3), sin(12), cos(12)]
W = 256
W_HALF = 128
PE_PAD = 64    # the kernel's K for the two PE consumers (63 + one zero)


def _freq_matrix(L: int, dtype=torch.float32):
    """B [3, 3L] with B[j, 3k + j] = 2^k, so (x @ B)[:, 3k + j] = 2^k x_j,
    matching the interleaved [sin f_k x, cos f_k x] row order of
    ``ops.encoding.positional_encoding``."""
    B = np.zeros((3, 3 * L), np.float32)
    for k in range(L):
        for j in range(3):
            B[j, 3 * k + j] = 2.0**k
    return torch.from_numpy(B).to(dtype)


def _split_pe_rows(w, L: int):
    """Split a weight matrix whose rows consume a positional encoding
    [x(3), sin f0(3), cos f0(3), ..., sin f_{L-1}(3), cos f_{L-1}(3)]
    into (x rows [3, N], sin rows [3L, N], cos rows [3L, N])."""
    sin_rows = [3 + 6 * k + j for k in range(L) for j in range(3)]
    cos_rows = [3 + 6 * k + 3 + j for k in range(L) for j in range(3)]
    return w[:3], w[sin_rows], w[cos_rows]


def pack_nerf_params(net, dtype=torch.bfloat16):
    """Split/reorder a :class:`pronerf_tpu_torch.models.mlp.NeRFMLP` into
    TRANSPOSED kernel panels (w_t [out, in]; biases as [out, 1] columns),
    with the keys, shapes and values of the JAX pack.

    ``dtype`` governs matmul inputs AND inter-layer activations/biases
    (float32 = exact; bfloat16 = the serving fast path)."""
    def w_in_out(lin):
        return lin.weight.detach().T  # [in, out], as the JAX pytree stores it

    def wt(a):
        return a.T.contiguous().to(dtype)

    def bias(b):
        return b.detach().reshape(-1, 1).to(dtype)

    pts = list(net.pts)
    w0x, w0s, w0c = _split_pe_rows(w_in_out(pts[0]), L_PTS)
    w5 = w_in_out(pts[5])  # [63 + 256, 256]: [x_pe | h]
    w5x, w5s, w5c = _split_pe_rows(w5[:63], L_PTS)

    # rows ordered [x(3)|sin(30)|cos(30)] to match the kernel's PE rows
    w0p = torch.cat([w0x, w0s, w0c], dim=0)
    w5p = torch.cat([w5x, w5s, w5c], dim=0)

    # alpha/rgb heads padded to 8 output rows
    w_alpha = w5.new_zeros(W, 8)
    w_alpha[:, :1] = w_in_out(net.alpha)
    b_alpha = w5.new_zeros(8)
    b_alpha[:1] = net.alpha.bias.detach()
    w_rgb = w5.new_zeros(W_HALF, 8)
    w_rgb[:, :3] = w_in_out(net.rgb)
    b_rgb = w5.new_zeros(8)
    b_rgb[:3] = net.rgb.bias.detach()

    packed = {
        "bx_t": _freq_matrix(L_PTS).to(w5.device).T.contiguous().to(dtype),
        "w0p_t": wt(w0p), "b0": bias(pts[0].bias),
        "w5p_t": wt(w5p), "w5h_t": wt(w5[63:]),
        "b5": bias(pts[5].bias),
        "w_alpha_t": wt(w_alpha), "b_alpha": bias(b_alpha),
        "w_feat_t": wt(w_in_out(net.feature)), "b_feat": bias(net.feature.bias),
        "wvf_t": wt(w_in_out(net.views)[:W]),
        "bv": bias(net.views.bias),
        "w_rgb_t": wt(w_rgb), "b_rgb": bias(b_rgb),
    }
    for i in (1, 2, 3, 4, 6, 7):
        packed[f"w{i}_t"] = wt(w_in_out(pts[i]))
        packed[f"b{i}"] = bias(pts[i].bias)
    return attach_blobs(packed)


_WEIGHT_ORDER = (
    "bx_t",
    "w0p_t", "b0",
    "w1_t", "b1", "w2_t", "b2", "w3_t", "b3", "w4_t", "b4",
    "w5p_t", "w5h_t", "b5",
    "w6_t", "b6", "w7_t", "b7",
    "w_alpha_t", "b_alpha", "w_feat_t", "b_feat",
    "wvf_t", "bv",
    "w_rgb_t", "b_rgb",
)


def _mm(h, w_t):
    """[P, K] x w_t [M, K] -> [P, M]: operands in the pack dtype, f32
    accumulation, rounded to the pack dtype."""
    return (h.to(w_t.dtype).float() @ w_t.float().T).to(w_t.dtype)


def _forward_plain(packed, pts, vcon):
    """The shared PE -> MLP chain. pts [N, S, 3] f32, vcon [N, 128] f32.
    Returns (rgb [N, S, 3], sigma [N, S]) in the pack dtype."""
    p = packed
    cdt = p["w1_t"].dtype

    def row(name):
        return p[name].reshape(1, -1)

    x = pts.to(cdt)
    xb = _mm(x, p["bx_t"]).float()                       # [N, S, 30]
    pe = torch.cat([x, torch.sin(xb).to(cdt), torch.cos(xb).to(cdt)], dim=-1)

    h = torch.relu(_mm(pe, p["w0p_t"]) + row("b0"))
    for i in (1, 2, 3, 4):
        h = torch.relu(_mm(h, p[f"w{i}_t"]) + row(f"b{i}"))
    h = torch.relu(_mm(pe, p["w5p_t"]) + _mm(h, p["w5h_t"]) + row("b5"))
    for i in (6, 7):
        h = torch.relu(_mm(h, p[f"w{i}_t"]) + row(f"b{i}"))

    sigma = _mm(h, p["w_alpha_t"]) + row("b_alpha")      # [N, S, 8] (col 0)
    feat = _mm(h, p["w_feat_t"]) + row("b_feat")
    hv = torch.relu(
        _mm(feat, p["wvf_t"]) + vcon.to(cdt)[:, None, :] + row("bv")
    )
    rgb = _mm(hv, p["w_rgb_t"]) + row("b_rgb")           # [N, S, 8] (cols 0:3)
    return rgb[..., :3], sigma[..., 0]


def _check_common(packed, pts24_t, vcon_t, n_samples):
    if pts24_t.dim() != 2 or pts24_t.shape[0] != 3 * n_samples:
        raise ValueError(
            f"pts24_t must be [3*{n_samples}, N], got {tuple(pts24_t.shape)}"
        )
    N = pts24_t.shape[1]
    if tuple(vcon_t.shape) != (W_HALF, N):
        raise ValueError(
            f"vcon_t must be [{W_HALF}, {N}], got {tuple(vcon_t.shape)}"
        )
    return N


def fused_nerf_raw_plain(packed, pts24_t, vcon_t, n_samples: int = 8):
    """Plain PyTorch version of :func:`fused_nerf_raw_t`, same rounding
    points. Runs on any device; nothing on the card's main path calls it."""
    N = _check_common(packed, pts24_t, vcon_t, n_samples)
    pts = pts24_t.T.reshape(N, n_samples, 3)
    rgb, sigma = _forward_plain(packed, pts, vcon_t.T)
    return torch.cat([rgb, sigma[..., None]], dim=-1).float()


def fused_nerf_composite_plain(packed, pts24_t, vcon_t, z_t, mm_add_t,
                               mm_mul_t, dnorm_t, n_samples: int = 8,
                               white_bkgd: bool = False):
    """Plain PyTorch version of :func:`fused_nerf_composite_t`: the same
    chain, then the streaming composite sample by sample in f32."""
    N = _check_common(packed, pts24_t, vcon_t, n_samples)
    S = n_samples
    pts = pts24_t.T.reshape(N, S, 3)
    rgb, sigma = _forward_plain(packed, pts, vcon_t.T)
    sigf = sigma.float()
    rgbf = torch.sigmoid(rgb.float())

    z_t = z_t.float()
    dists = torch.cat(
        [z_t[1:] - z_t[:-1], torch.full_like(z_t[:1], 1e10)], dim=0
    ) * dnorm_t.float()
    madd, mmul = mm_add_t.float(), mm_mul_t.float()

    trans = torch.ones(N, dtype=torch.float32, device=z_t.device)
    out_rgb = torch.zeros(N, 3, dtype=torch.float32, device=z_t.device)
    depth = torch.zeros_like(trans)
    acc = torch.zeros_like(trans)
    weights = []
    for s in range(S):
        alpha = 1.0 - torch.exp(
            -torch.relu(sigf[:, s] + madd[s]) * dists[s]
        )
        alpha = alpha * torch.relu(mmul[s])
        w = alpha * trans
        out_rgb = out_rgb + w[:, None] * rgbf[:, s]
        depth = depth + w * z_t[s]
        acc = acc + w
        trans = trans * (1.0 - alpha + 1e-10)
        weights.append(w)
    disp = 1.0 / torch.maximum(torch.full_like(depth, 1e-10), depth / acc)
    if white_bkgd:
        out_rgb = out_rgb + (1.0 - acc)[:, None]
    return {
        "rgb": out_rgb, "depth": depth, "disp": disp, "acc": acc,
        "weights": torch.stack(weights, dim=1), "sigma": sigf,
    }


_BLOB_KEY = "_kernel_blob"
# The f32 blob: (panel, K of the panel as the kernel reads it), in order.
_BLOB_ORDER = (
    ("w0p_t", PE_PAD), ("b0", 1),
    ("w1_t", W), ("b1", 1), ("w2_t", W), ("b2", 1),
    ("w3_t", W), ("b3", 1), ("w4_t", W), ("b4", 1),
    ("w5p_t", PE_PAD), ("w5h_t", W), ("b5", 1),
    ("w6_t", W), ("b6", 1), ("w7_t", W), ("b7", 1),
    ("w_alpha_t", W), ("b_alpha", 1), ("w_feat_t", W), ("b_feat", 1),
    ("wvf_t", W), ("bv", 1), ("w_rgb_t", W_HALF), ("b_rgb", 1),
)

# The bf16 blob is the sequence of shared-memory images the kernel copies in
# bulk (slabs and stages as ``stages.py`` defines them). The ring stages come
# in the order the chain consumes them, the same for every sample: layer 0 is
# one stage of 256 rows, layer 5 has the PE slab of a half before its h
# slabs, the view layer is one half. After the ring: the two heads (read in
# place for the block's life), then the biases.
def _ring_stages():
    ring = slabs("w0p_t", n=1)
    for i in (1, 2, 3, 4):
        ring += halves(f"w{i}_t")
    for half in (0, 1):
        ring += slabs("w5p_t", W_HALF, half * W_HALF, n=1)
        ring += slabs("w5h_t", W_HALF, half * W_HALF, per_stage=2)
    for name in ("w6_t", "w7_t", "w_feat_t"):
        ring += halves(name)
    ring += slabs("wvf_t", W_HALF, per_stage=2)
    return tuple(tuple(st) for st in ring)


RING_STAGES = _ring_stages()
HEAD_SLABS = tuple(
    [("w_alpha_t", 0, 8, ks) for ks in range(W // SLAB_K)]
    + [("w_rgb_t", 0, 8, ks) for ks in range(W_HALF // SLAB_K)]
)
BIAS_ORDER = ("b0", "b1", "b2", "b3", "b4", "b5", "b6", "b7", "b_feat", "bv",
              "b_alpha", "b_rgb")


def stage_table():
    """(byte offset in the blob, bytes) of every ring stage, in order."""
    return _stage_table(RING_STAGES)


def _blob(packed):
    """The panels as the one contiguous buffer the kernels read (see the
    head of ``csrc/fused_nerf.cu``), built once and kept in ``packed``: for
    bf16 the stage images above, for f32 the panels in ``_BLOB_ORDER``. The
    kernels compute ``bx_t . x`` as ``ldexp(x, k)``, so the panel must be the
    frequency matrix; that is checked here."""
    blob = packed.get(_BLOB_KEY)
    if blob is None:
        bx = packed["bx_t"]
        want = _freq_matrix(L_PTS).T.to(device=bx.device, dtype=bx.dtype)
        if not torch.equal(bx, want):
            raise ValueError("bx_t is not the power-of-two frequency matrix")
        if bx.dtype == torch.bfloat16:
            parts = images(packed, RING_STAGES + (HEAD_SLABS,))
            parts += [packed[name].reshape(-1) for name in BIAS_ORDER]
        else:
            parts = [pad_k(packed[name], k).reshape(-1)
                     for name, k in _BLOB_ORDER]
        blob = torch.cat(parts).contiguous()
        packed[_BLOB_KEY] = blob
    return blob


_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from pronerf_tpu_torch.kernels.build import load

        lib = load("fused_nerf")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pn_fused_nerf_raw.argtypes = [p, p, p, ll, p, i, i, i, p]
        lib.pn_fused_nerf_raw.restype = ctypes.c_int
        lib.pn_fused_nerf_composite.argtypes = (
            [p] * 7 + [ll] + [p] * 6 + [i, i, i, i, p]
        )
        lib.pn_fused_nerf_composite.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_cuda(packed, **tensors):
    cdt = packed["w1_t"].dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pack dtype {cdt} has no kernel")
    dev = packed["w1_t"].device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, panels on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return int(cdt == torch.bfloat16)


def _launch_error(err: int) -> str:
    if err == -1:
        return ("arguments the kernel does not take (it needs N > 0, "
                "n_samples >= 1 and the blob built by this module)")
    return f"CUDA error {err}"


BLOBS_KEY = "_kernel_blobs"


def attach_blobs(packed):
    """Build the kernel's blob and keep it in ``packed`` under
    ``BLOBS_KEY`` (a list of one): at pack time, so that no traced or
    captured call builds it. Only a pack on the card gets it (the plain
    version reads the panels); returns ``packed``."""
    if packed["w1_t"].device.type == "cuda" and BLOBS_KEY not in packed:
        packed[BLOBS_KEY] = [_blob(packed)]
    return packed


def _op_args(packed, device):
    """(panels in ``_WEIGHT_ORDER``, blobs) as the ops take them."""
    panels = [packed[n] for n in _WEIGHT_ORDER]
    blobs = (attach_blobs(packed)[BLOBS_KEY] if device.type == "cuda"
             else [])
    return panels, blobs


def _launch_args(panels, blobs, tensors):
    """Checks of a launch on the card; (pack dict, blob, is_bf16)."""
    packed = dict(zip(_WEIGHT_ORDER, panels))
    if len(blobs) != 1:
        raise ValueError("the pack has no kernel blob (attach_blobs)")
    return packed, blobs[0], _check_cuda(packed, **tensors)


@torch.library.custom_op("pronerf::fused_nerf_raw", mutates_args=(),
                         device_types="cuda")
def fused_nerf_raw_op(panels: list[torch.Tensor], blobs: list[torch.Tensor],
                      pts24_t: torch.Tensor, vcon_t: torch.Tensor,
                      n_samples: int) -> torch.Tensor:
    """The op ``pronerf::fused_nerf_raw`` on the card: launches
    ``nerf_wg_kernel<false>`` (bf16 panels) or the f32 kernel, or raises."""
    packed, blob, is_bf16 = _launch_args(
        panels, blobs, dict(pts24_t=pts24_t, vcon_t=vcon_t))
    N = _check_common(packed, pts24_t, vcon_t, n_samples)
    raw = torch.empty(N, n_samples, 4, dtype=torch.float32,
                      device=pts24_t.device)
    with torch.cuda.device(pts24_t.device):
        err = _kernels().pn_fused_nerf_raw(
            pts24_t.data_ptr(), vcon_t.data_ptr(), blob.data_ptr(),
            blob.numel(), raw.data_ptr(), N, n_samples, is_bf16,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_nerf_raw kernel launch failed: {_launch_error(err)}")
    fused_nerf_raw_t.launches += 1
    _count_samples(fused_nerf_raw_t, n_samples)
    return raw


@fused_nerf_raw_op.register_kernel("cpu")
def _(panels, blobs, pts24_t, vcon_t, n_samples):
    return fused_nerf_raw_plain(dict(zip(_WEIGHT_ORDER, panels)), pts24_t,
                                vcon_t, n_samples).contiguous()


@fused_nerf_raw_op.register_fake
def _(panels, blobs, pts24_t, vcon_t, n_samples):
    return pts24_t.new_empty((pts24_t.shape[1], n_samples, 4),
                             dtype=torch.float32)


def fused_nerf_raw_t(packed, pts24_t, vcon_t, n_samples: int = 8):
    """Fused PE -> NeRF MLP forward (no autograd; inference path).

    Args:
      packed: :func:`pack_nerf_params` output (bf16 or f32 panels).
      pts24_t: [S*3, N] float32 query points, row 3*s + c = coordinate c of
        sample s (offsets applied).
      vcon_t: [128, N] float32 per-ray view-direction contribution.
      n_samples: S.

    Calls the op ``pronerf::fused_nerf_raw``: on CUDA tensors it launches
    the kernel or raises, on CPU tensors it runs the plain version. The JAX
    wrapper's ``rays_per_block`` is dropped: the CUDA kernel's tile is fixed
    at build time and it masks a ragged last tile itself.

    Returns: raw [N, S, 4] float32 (rgb logits, sigma), ready for
    ``ops.composite``.
    """
    panels, blobs = _op_args(packed, pts24_t.device)
    return fused_nerf_raw_op(panels, blobs, pts24_t, vcon_t, n_samples)


def _count_samples(fn, n_samples):
    fn.launches_by_samples[n_samples] = (
        fn.launches_by_samples.get(n_samples, 0) + 1)


# Launches of each kernel (counted where the op launches it): all of them,
# and by samples a ray
fused_nerf_raw_t.launches = 0
fused_nerf_raw_t.launches_by_samples = {}

_COMPOSITE_KEYS = ("rgb", "depth", "disp", "acc", "weights", "sigma")


@torch.library.custom_op("pronerf::fused_nerf_composite", mutates_args=(),
                         device_types="cuda")
def fused_nerf_composite_op(
        panels: list[torch.Tensor], blobs: list[torch.Tensor],
        pts24_t: torch.Tensor, vcon_t: torch.Tensor, z_t: torch.Tensor,
        mm_add_t: torch.Tensor, mm_mul_t: torch.Tensor,
        dnorm_t: torch.Tensor, n_samples: int, white_bkgd: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor]:
    """The op ``pronerf::fused_nerf_composite`` on the card: launches
    ``nerf_wg_kernel<true>`` (bf16 panels) or the f32 kernel, or raises.
    Returns the outputs in ``_COMPOSITE_KEYS`` order."""
    S = n_samples
    packed, blob, is_bf16 = _launch_args(panels, blobs, dict(
        pts24_t=pts24_t, vcon_t=vcon_t, z_t=z_t, mm_add_t=mm_add_t,
        mm_mul_t=mm_mul_t, dnorm_t=dnorm_t))
    N = _check_common(packed, pts24_t, vcon_t, S)
    for name, t in (("z_t", z_t), ("mm_add_t", mm_add_t),
                    ("mm_mul_t", mm_mul_t)):
        if tuple(t.shape) != (S, N):
            raise ValueError(f"{name} must be [{S}, {N}], got {tuple(t.shape)}")
    if tuple(dnorm_t.shape) != (1, N):
        raise ValueError(f"dnorm_t must be [1, {N}], got {tuple(dnorm_t.shape)}")
    out = _composite_empty(pts24_t, N, S)
    with torch.cuda.device(pts24_t.device):
        err = _kernels().pn_fused_nerf_composite(
            pts24_t.data_ptr(), vcon_t.data_ptr(), z_t.data_ptr(),
            mm_add_t.data_ptr(), mm_mul_t.data_ptr(), dnorm_t.data_ptr(),
            blob.data_ptr(), blob.numel(),
            *(t.data_ptr() for t in out),
            N, S, int(white_bkgd), is_bf16,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_nerf_composite kernel launch failed: {_launch_error(err)}"
        )
    fused_nerf_composite_t.launches += 1
    _count_samples(fused_nerf_composite_t, S)
    return out


def _composite_empty(like, N, S):
    def empty(*shape):
        return like.new_empty(shape, dtype=torch.float32)

    return (empty(N, 3), empty(N), empty(N), empty(N), empty(N, S),
            empty(N, S))


@fused_nerf_composite_op.register_kernel("cpu")
def _(panels, blobs, pts24_t, vcon_t, z_t, mm_add_t, mm_mul_t, dnorm_t,
      n_samples, white_bkgd):
    out = fused_nerf_composite_plain(
        dict(zip(_WEIGHT_ORDER, panels)), pts24_t, vcon_t, z_t, mm_add_t,
        mm_mul_t, dnorm_t, n_samples, white_bkgd)
    return tuple(out[k].contiguous() for k in _COMPOSITE_KEYS)


@fused_nerf_composite_op.register_fake
def _(panels, blobs, pts24_t, vcon_t, z_t, mm_add_t, mm_mul_t, dnorm_t,
      n_samples, white_bkgd):
    return _composite_empty(pts24_t, pts24_t.shape[1], n_samples)


def fused_nerf_composite_t(packed, pts24_t, vcon_t, z_t, mm_add_t, mm_mul_t,
                           dnorm_t, n_samples: int = 8,
                           white_bkgd: bool = False):
    """Fused PE -> NeRF MLP -> alpha COMPOSITE (no autograd; inference path).

    Semantics mirror ``ops.composite`` with the density corrections and no
    noise, clamp or ``num_valid`` (the inference variant). The raw [N, S, 4]
    never reaches device memory. Calls the op
    ``pronerf::fused_nerf_composite`` (the kernel on CUDA tensors, the plain
    version on CPU ones).

    Args:
      packed, pts24_t, vcon_t, n_samples: as :func:`fused_nerf_raw_t`.
      z_t: [S, N] float32 sorted bin-constrained sample depths.
      mm_add_t, mm_mul_t: [S, N] float32 sampler density corrections.
      dnorm_t: [1, N] float32 per-ray ||ndc_d|| interval scale.

    Returns: dict(rgb [N, 3], depth [N], disp [N], acc [N],
      weights [N, S], sigma [N, S]), float32.
    """
    panels, blobs = _op_args(packed, pts24_t.device)
    out = fused_nerf_composite_op(panels, blobs, pts24_t, vcon_t, z_t,
                                  mm_add_t, mm_mul_t, dnorm_t, n_samples,
                                  white_bkgd)
    return dict(zip(_COMPOSITE_KEYS, out))


fused_nerf_composite_t.launches = 0
fused_nerf_composite_t.launches_by_samples = {}
