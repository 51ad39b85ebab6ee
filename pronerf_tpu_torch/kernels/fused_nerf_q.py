"""INT8 form of the fused PE -> NeRF MLP (serving only, ``quant = int8``):
calibration, packing, the plain PyTorch version, and the wrapper that
launches the CUDA kernel of ``csrc/fused_nerf_q.cu``.

Counterpart of ``pronerf_tpu/kernels/fused_nerf_q.py`` with the same names
and the same contract as ``fused_nerf.fused_nerf_raw_t``: transposed query
points ``pts24_t [S*3, N]``, per-ray view contribution ``vcon_t [128, N]``,
raw ``[N, S, 4]`` float32 out, so ``ops.composite`` applies as it is.

Scheme (integer-only inference, every scale folded at pack time):

- weights: symmetric per-output-channel int8, ``w_q = round(w' / s_w[o])``;
- activations: affine PER-CHANNEL uint8 kept in int8. Feature k with the
  calibrated range ``[m_k, m_k + 254 s_k]`` is carried as ``q = clip(floor(
  (h_k - m_k) / s_k + .5), 0, 254) - 127``, so code 0 is ``-127`` and
  ``-128`` never occurs. The input scale ``diag(s_in)`` folds into the next
  layer's weight COLUMNS before the per-row weight quantisation, so the
  int8 product never sees it;
- each layer computes ``t = acc_i32 * A[o] + B[o]``: ``A`` folds
  ``s_w / s_out``; ``B`` folds the bias, the zero-point correction
  ``127 * s_w * rowsum(w_q)``, the exact offset term ``w @ m_in`` and the
  output offset. Then ``clip(floor(t + .5), 0, 254) - 127``. The lower clip
  is the ReLU of the layers whose output offset is 0;
- the two consumers of the positional encoding (K = 63) and sin/cos stay
  bf16 / f32; their f32 sums enter the requantisation unrounded.

Rounding points (part of the function, shared by kernel and plain version):
the sin/cos arguments are taken from the f32 points, exactly, as in
``fused_nerf`` (the Pallas kernel rounds the points to the PE dtype first);
``acc * A`` is rounded to f32 BEFORE ``B`` is added (no fused multiply-add);
layer 5 is ``(acc * A5 + pe_dot) + B5`` and the view layer ``(acc * Av +
vcon * vcon_scale) + Bv``, in that order. The int8 products are exact
integers everywhere: ``|acc| <= 256 * 127 * 127 < 2^24``, so the plain
version's float32 product of the codes is exact in any order of summation
(TF32 must be off, which is checked), and so is int32 -> float32.

The kernel is the ``torch.library`` op ``pronerf::fused_nerf_raw_q``
(``library.define``): its CUDA implementation launches the kernel (or
raises) and counts the launch, its CPU implementation is the plain version.
The blob is built at pack time (``attach_blobs``) and handed to the op as a
tensor.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from pronerf_tpu_torch.kernels import library
from pronerf_tpu_torch.kernels.fused_nerf import (
    L_DIR,
    L_PTS,
    W,
    W_HALF,
    _check_common,
    _freq_matrix,
    _raw_fake,
    _split_pe_rows,
    pe_args,
)
from pronerf_tpu_torch.kernels.stages import images, slabs
from pronerf_tpu_torch.kernels.stages import stage_table as _stage_table
from pronerf_tpu_torch.ops.encoding import positional_encoding

# Calibration headroom: maxima measured on the synthetic sweep are inflated
# by this factor so real-scene activations slightly past the sweep's
# envelope quantize instead of clipping.
_CAL_MARGIN = 1.10
_CAL_SEED = 20260818


@torch.no_grad()
def calibrate_nerf_ranges(net, n: int = 8192, pts=None, dirs=None,
                          generator=None):
    """Per-channel activation ranges for the int8 chain.

    Runs the f32 NeRF forward of ``net`` (a
    :class:`models.mlp.NeRFMLP`) on ``n`` synthetic query
    points spanning the NDC volume the serving path evaluates (x, y in
    [-1.25, 1.25], z in [-0.1, 1.1]; random unit view directions) and
    records the range of every tensor the kernel quantizes.

    The default sweep is drawn on the CPU from ``generator`` (default: a
    ``torch.Generator`` seeded with 20260818). The JAX package draws its
    sweep from a JAX key, whose numbers PyTorch cannot reproduce, so default
    ranges differ from the JAX package's by sampling only; pass the same
    ``pts [n, 3]`` and ``dirs [n, 3]`` to both to get the same ranges.

    Returns {"h0".."h7": (0, max), "feat": (min, max), "hv": (0, max)}, each
    a pair of [C] float32 tensors, with ``_CAL_MARGIN`` headroom applied.
    """
    dev = net.alpha.weight.device
    if pts is None:
        g = generator
        if g is None:
            g = torch.Generator().manual_seed(_CAL_SEED)
        lo = torch.tensor([-1.25, -1.25, -0.1])
        hi = torch.tensor([1.25, 1.25, 1.1])
        pts = lo + (hi - lo) * torch.rand(n, 3, generator=g)
        dirs = torch.randn(n, 3, generator=g)
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    pts = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    dirs = torch.as_tensor(dirs, dtype=torch.float32, device=dev)

    x_pe = positional_encoding(pts, L_PTS)    # [n, 63]
    d_pe = positional_encoding(dirs, L_DIR)   # [n, 27]

    ranges = {}

    def fmax(h, name):
        # per-CHANNEL ranges; the minimum after a ReLU is 0
        ranges[name] = (h.new_zeros(h.shape[-1]), h.amax(dim=0) * _CAL_MARGIN)
        return h

    h = x_pe
    for i, layer in enumerate(net.pts):
        inp = torch.cat([x_pe, h], dim=-1) if i == 5 else h
        h = fmax(torch.relu(F.linear(inp, layer.weight, layer.bias)), f"h{i}")
    feat = F.linear(h, net.feature.weight, net.feature.bias)
    mn, mx = feat.amin(dim=0), feat.amax(dim=0)
    c = 0.5 * (mn + mx)
    half = 0.5 * (mx - mn) * _CAL_MARGIN
    ranges["feat"] = (c - half, c + half)
    wv = net.views.weight  # [128, W + Cd]
    hv = torch.relu(feat @ wv[:, :W].T + d_pe @ wv[:, W:].T + net.views.bias)
    fmax(hv, "hv")
    return ranges


def _qweight(w_t):
    """Symmetric per-output-channel int8: returns (w_q [M, K] int8,
    s_w [M, 1] f32, rowsum_q [M, 1] f32)."""
    w_t = w_t.float()
    s = w_t.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
    s = s / 127.0
    wq = torch.clamp(torch.round(w_t / s), -127, 127).to(torch.int8)
    return wq, s, wq.float().sum(dim=1, keepdim=True)


def _fold(w_t, b, s_in, m_in, s_out=None, m_out=None):
    """Quantize one layer and fold every scale into (w_q, A, B):
    ``t = acc_i32 * A + B`` is the layer output in OUTPUT-quant units when
    ``s_out`` is given (requantize with ``_requant``), else in f32 units
    (the heads).

    ``s_in`` / ``m_in`` are PER-INPUT-CHANNEL [K] vectors (the input's affine
    quant); ``s_out`` / ``m_out`` per-output-channel [M] vectors. The sums
    keep the JAX pack's order of operations, so that with the same ranges
    the panels can be compared bit for bit."""
    w_t = w_t.float()                                   # [M, K]
    wq, s_w, rs_q = _qweight(w_t * s_in[None, :])
    b = b.float().reshape(-1, 1)
    A = s_w
    B = 127.0 * s_w * rs_q + (w_t @ m_in).reshape(-1, 1) + b
    if s_out is not None:
        inv = (1.0 / s_out).reshape(-1, 1)
        A = A * inv
        B = (B - m_out.reshape(-1, 1)) * inv
    return wq, A.float(), B.float()


@torch.no_grad()
def pack_nerf_params_int8(net, ranges=None, pe_dtype=torch.bfloat16):
    """Pack a :class:`models.mlp.NeRFMLP` into int8 kernel
    panels (plus the bf16 PE panels), with the keys, shapes and dtypes of the
    JAX pack: ``w{1..7}q, wfq [256, 256]``, ``wvq [128, 256]``, ``waq
    [8, 256]``, ``wrq [8, 128]`` int8; ``A*, B* [out, 1]`` and ``vcon_scale
    [128, 1]`` float32; ``bx_t [30, 3]``, ``w0p_t, w5p_t [256, 63]`` in
    ``pe_dtype``.

    ``ranges`` defaults to ``calibrate_nerf_ranges(net)``. The returned dict
    feeds :func:`fused_nerf_raw_tq`.
    """
    if ranges is None:
        ranges = calibrate_nerf_ranges(net)
    dev = net.alpha.weight.device

    def scale_of(name):
        m, mx = ranges[name]
        m = torch.as_tensor(m, dtype=torch.float32, device=dev).reshape(-1)
        mx = torch.as_tensor(mx, dtype=torch.float32, device=dev).reshape(-1)
        return (mx - m).clamp_min(1e-12) / 254.0, m

    def w_in_out(lin):
        return lin.weight.detach().T  # [in, out], as the JAX pytree stores it

    pts = list(net.pts)
    # The PE consumers stay bf16, rows reordered [x | sin | cos] exactly as
    # fused_nerf.pack_nerf_params orders them.
    w0x, w0s, w0c = _split_pe_rows(w_in_out(pts[0]), L_PTS)
    w5 = w_in_out(pts[5])
    w5x, w5s, w5c = _split_pe_rows(w5[:63], L_PTS)
    w0p = torch.cat([w0x, w0s, w0c], dim=0)
    w5p = torch.cat([w5x, w5s, w5c], dim=0)

    s0, m0 = scale_of("h0")
    s5, m5 = scale_of("h5")

    packed = {
        "bx_t": _freq_matrix(L_PTS).to(dev).T.contiguous().to(pe_dtype),
        "w0p_t": w0p.T.contiguous().to(pe_dtype),
        # layer 0 output straight into h0-quant units (per channel)
        "A0": (1.0 / s0).reshape(-1, 1).float(),
        "B0": (pts[0].bias.detach().reshape(-1, 1)
               / s0.reshape(-1, 1)).float(),
        # w5's PE half pre-scaled per OUTPUT channel by 1 / s5, so that its
        # f32 sum adds directly to the layer-5 requant expression
        "w5p_t": (w5p / s5[None, :]).T.contiguous().to(pe_dtype),
    }

    def fold_into(tag, w_t, b, s_in, m_in, s_out=None, m_out=None):
        wq, A, B = _fold(w_t, b, s_in, m_in, s_out, m_out)
        packed[f"w{tag}q"], packed[f"A{tag}"], packed[f"B{tag}"] = wq, A, B

    s_prev, m_prev = s0, m0
    for i in (1, 2, 3, 4):
        s_i, m_i = scale_of(f"h{i}")
        fold_into(i, pts[i].weight.detach(), pts[i].bias.detach(),
                  s_prev, m_prev, s_i, m_i)
        s_prev, m_prev = s_i, m_i
    # layer 5: int8 on the h4 half; the PE half arrives as a pre-scaled f32
    # sum
    fold_into(5, w5[63:].T, pts[5].bias.detach(), s_prev, m_prev, s5, m5)
    s_prev, m_prev = s5, m5
    for i in (6, 7):
        s_i, m_i = scale_of(f"h{i}")
        fold_into(i, pts[i].weight.detach(), pts[i].bias.detach(),
                  s_prev, m_prev, s_i, m_i)
        s_prev, m_prev = s_i, m_i
    s7, m7 = s_prev, m_prev

    # alpha head (padded to 8 rows), f32 out
    w_alpha = w5.new_zeros(W, 8)
    w_alpha[:, :1] = w_in_out(net.alpha)
    b_alpha = w5.new_zeros(8)
    b_alpha[:1] = net.alpha.bias.detach()
    fold_into("a", w_alpha.T, b_alpha, s7, m7)

    # feature layer (linear, so an affine output quant)
    s_f, m_f = scale_of("feat")
    fold_into("f", net.feature.weight.detach(), net.feature.bias.detach(),
              s7, m7, s_f, m_f)

    # view layer: int8 on the feature half; the d_pe contribution (vcon)
    # arrives as an f32 input and is scaled per channel by 1 / s_hv
    s_hv, m_hv = scale_of("hv")
    fold_into("v", w_in_out(net.views)[:W].T, net.views.bias.detach(),
              s_f, m_f, s_hv, m_hv)
    packed["vcon_scale"] = (1.0 / s_hv).reshape(-1, 1).float()

    # rgb head (padded to 8 rows), f32 out
    w_rgb = w5.new_zeros(W_HALF, 8)
    w_rgb[:, :3] = w_in_out(net.rgb)
    b_rgb = w5.new_zeros(8)
    b_rgb[:3] = net.rgb.bias.detach()
    fold_into("r", w_rgb.T, b_rgb, s_hv, m_hv)
    return attach_blobs(packed)


_ORDER = (
    "bx_t", "w0p_t", "A0", "B0",
    "w1q", "A1", "B1", "w2q", "A2", "B2",
    "w3q", "A3", "B3", "w4q", "A4", "B4",
    "w5p_t", "w5q", "A5", "B5",
    "w6q", "A6", "B6", "w7q", "A7", "B7",
    "waq", "Aa", "Ba", "wfq", "Af", "Bf",
    "wvq", "Av", "Bv",
    "wrq", "Ar", "Br",
)


def _mmf(x, w_t):
    """[P, K] x w_t [M, K] -> [P, M]: operands in the PE dtype, f32
    accumulation, the f32 sum returned UNROUNDED (PE consumers)."""
    return x.to(w_t.dtype).float() @ w_t.float().T


def _mmi(h_q, w_q):
    """int8 codes [P, K] x int8 panel [M, K] -> the exact integer sums as
    float32 (see the head of this file for why a float32 product is exact)."""
    return h_q.float() @ w_q.float().T


def _requant(t):
    """f32 in output-quant units -> int8 code. The lower clip doubles as the
    ReLU of layers whose output offset is 0."""
    return (torch.clamp(torch.floor(t + 0.5), 0.0, 254.0) - 127.0).to(
        torch.int8)


def fused_nerf_raw_q_plain(packed, pts24_t, vcon_t, n_samples: int = 8):
    """Plain PyTorch version of :func:`fused_nerf_raw_tq`, same rounding
    points. Runs on any device; nothing on the card's main path calls it."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "TF32 matmuls are on: the float32 products of int8 codes would "
            "not be exact")
    N = _check_common(packed, pts24_t, vcon_t, n_samples)
    p = packed
    pdt = p["w0p_t"].dtype

    def row(name):
        return p[name].reshape(1, -1)

    pts = pts24_t.T.reshape(N, n_samples, 3)
    x = pts.to(pdt)
    xb = pe_args(pts, p["bx_t"])                          # [N, S, 30], exact
    pe = torch.cat([x, torch.sin(xb).to(pdt), torch.cos(xb).to(pdt)], dim=-1)

    h = _requant(_mmf(pe, p["w0p_t"]) * row("A0") + row("B0"))
    for i in (1, 2, 3, 4):
        h = _requant(_mmi(h, p[f"w{i}q"]) * row(f"A{i}") + row(f"B{i}"))
    h = _requant(
        _mmi(h, p["w5q"]) * row("A5") + _mmf(pe, p["w5p_t"]) + row("B5"))
    for i in (6, 7):
        h = _requant(_mmi(h, p[f"w{i}q"]) * row(f"A{i}") + row(f"B{i}"))

    sigma = _mmi(h, p["waq"]) * row("Aa") + row("Ba")      # [N, S, 8] (col 0)
    fq = _requant(_mmi(h, p["wfq"]) * row("Af") + row("Bf"))
    vcon = (vcon_t.float() * p["vcon_scale"]).T[:, None, :]  # [N, 1, 128]
    hv = _requant(_mmi(fq, p["wvq"]) * row("Av") + vcon + row("Bv"))
    rgb = _mmi(hv, p["wrq"]) * row("Ar") + row("Br")       # [N, S, 8] (0:3)
    return torch.cat([rgb[..., :3], sigma[..., :1]], dim=-1)


_BLOB_KEY = "_kernel_blob"


def k_perm(k: int):
    """The permutation of K that makes a thread's s32 accumulators its A
    codes of the next int8 ``wgmma`` (see the head of ``csrc/hopper.cuh``), as
    an index: position p of a permuted panel holds column ``k_perm(k)[p]``.
    Inside each chunk of 16, position 4 q + e holds column 8 (e // 2) + 2 q
    + e % 2."""
    p = np.arange(k)
    q, e = (p % 16) // 4, p % 4
    return p - p % 16 + 8 * (e // 2) + 2 * q + e % 2


# The panels whose K is a requantised activation (permuted in the blob); the
# two PE panels read the PE rows from shared memory and are not.
PERMUTED = ("w1q", "w2q", "w3q", "w4q", "w5q", "w6q", "w7q", "wfq", "wvq",
            "waq", "wrq")


def _half(name, half):
    """128 rows of an int8 panel of K = 256: two slabs of 128 k, one stage."""
    return [(name, half * W_HALF, W_HALF, ks) for ks in (0, 1)]


def _quarter(name, qt):
    """64 rows of an int8 panel of K = 256: two slabs."""
    return [(name, qt * 64, 64, ks) for ks in (0, 1)]


# The int8 blob is the sequence of shared-memory images the kernel copies in
# bulk (slabs and stages as ``stages.py`` defines them; an int8 slab is 128
# k) in the order the chain consumes them, the same for every sample: layer 0
# is one stage of 256 rows (bf16), a 256-wide int8 layer two stages of a
# half, layer 5 four stages of a quarter [w5p slab | w5q slabs], the view
# layer two stages of a quarter. After the ring: the two heads (resident for
# the block's life), then the f32 columns (:func:`_columns`).
def _ring_stages():
    ring = slabs("w0p_t", n=1)
    for name in ("w1q", "w2q", "w3q", "w4q"):
        ring += [_half(name, 0), _half(name, 1)]
    ring += [[("w5p_t", qt * 64, 64, 0)] + _quarter("w5q", qt)
             for qt in range(4)]
    for name in ("w6q", "w7q", "wfq"):
        ring += [_half(name, 0), _half(name, 1)]
    ring += [_quarter("wvq", qt) for qt in range(2)]
    return tuple(tuple(st) for st in ring)


RING_STAGES = _ring_stages()
HEAD_SLABS = (("waq", 0, 8, 0), ("waq", 0, 8, 1), ("wrq", 0, 8, 0))
# The f32 columns, in the order of QBlob::c_*: per layer the pairs
# {A(2p), A(2p+1), B(2p), B(2p+1)} (one 16-byte load serves a thread's two
# columns of an n-tile), then vcon_scale, then the heads' columns whole.
COLUMN_PAIRS = tuple((f"A{i}", f"B{i}") for i in range(8)) + (
    ("Af", "Bf"), ("Av", "Bv"))
HEAD_COLUMNS = ("Aa", "Ba", "Ar", "Br")
# What the blob stores times T_SCALE, so that the kernel's requantising
# epilogue computes t / 256 (see ``csrc/hopper.cuh``): every requantised
# layer's A and B, and the addends of layers 5 (the w5p panel) and view
# (vcon_scale). Scaling by a power of two is exact; ``_blob`` checks it.
T_SCALE = 2.0 ** -8
SCALED = tuple(n for pair in COLUMN_PAIRS for n in pair) + (
    "vcon_scale", "w5p_t")


def stage_table():
    """(byte offset in the blob, bytes) of every ring stage, in order."""
    return _stage_table(RING_STAGES)


def _columns(panels):
    """The f32 column section of the blob, flat, from ``panels`` (the
    packed dict with ``SCALED`` applied)."""
    parts = [torch.stack([panels[a].reshape(-1, 2), panels[b].reshape(-1, 2)],
                         dim=1).reshape(-1) for a, b in COLUMN_PAIRS]
    parts += [panels[name].reshape(-1)
              for name in ("vcon_scale",) + HEAD_COLUMNS]
    return torch.cat([p.float() for p in parts])


def _blob(packed):
    """The panels as the one contiguous byte buffer the kernel reads (see the
    head of ``csrc/fused_nerf_q.cu``), built once and kept in ``packed``: the
    stage images above with ``k_perm`` applied to the panels in
    ``PERMUTED`` and ``T_SCALE`` to those in ``SCALED`` (``packed`` itself is
    neither permuted nor scaled), then the columns. The kernel computes
    ``bx_t . x`` as ``ldexp(x, k)``, so the panel must be the frequency
    matrix, and its PE products are bf16; both are checked here, and that
    the scaling is exact."""
    blob = packed.get(_BLOB_KEY)
    if blob is None:
        bx = packed["bx_t"]
        if bx.dtype != torch.bfloat16:
            raise TypeError(f"PE dtype {bx.dtype} has no int8 kernel "
                            "(bfloat16 only)")
        want = _freq_matrix(L_PTS).T.to(device=bx.device, dtype=bx.dtype)
        if not torch.equal(bx, want):
            raise ValueError("bx_t is not the power-of-two frequency matrix")
        panels = dict(packed)
        for name in PERMUTED:
            a = packed[name]
            panels[name] = a[:, torch.as_tensor(k_perm(a.shape[1]),
                                                device=a.device)]
        for name in SCALED:
            a = packed[name] * T_SCALE
            if not torch.equal(a / T_SCALE, packed[name]):
                raise ValueError(f"{name} is not exact times 2^-8")
            panels[name] = a
        parts = [img.view(torch.uint8)
                 for img in images(panels, RING_STAGES + (HEAD_SLABS,))]
        parts.append(_columns(panels).view(torch.uint8))
        blob = torch.cat(parts).contiguous()
        packed[_BLOB_KEY] = blob
    return blob


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from pronerf_tpu_torch.kernels.build import load

        fn = load("fused_nerf_q").pn_fused_nerf_raw_q
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, p, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


BLOBS_KEY = "_kernel_blobs"
PANELS = _ORDER + ("vcon_scale",)


def attach_blobs(packed):
    """Build the kernel's blob and keep it in ``packed`` under
    ``BLOBS_KEY`` (a list of one): at pack time, so that no traced or
    captured call builds it (``k_perm`` and the 2^-8 scaling are applied
    there). Only a pack on the card gets it; returns ``packed``."""
    if packed["w1q"].device.type == "cuda" and BLOBS_KEY not in packed:
        packed[BLOBS_KEY] = [_blob(packed)]
    return packed


def _fused_nerf_raw_q_cuda(panels: list[torch.Tensor],
                           blobs: list[torch.Tensor], pts24_t: torch.Tensor,
                           vcon_t: torch.Tensor,
                           n_samples: int) -> torch.Tensor:
    """The op ``pronerf::fused_nerf_raw_q`` on the card: launches
    ``nerf_q_wg_kernel`` or raises. ``panels`` in ``PANELS`` order."""
    packed = dict(zip(PANELS, panels))
    N = _check_common(packed, pts24_t, vcon_t, n_samples)
    dev = packed["w1q"].device
    for name, t in (("pts24_t", pts24_t), ("vcon_t", vcon_t)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, panels on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len(blobs) != 1:
        raise ValueError("the pack has no kernel blob (attach_blobs)")
    blob = blobs[0]
    raw = torch.empty(N, n_samples, 4, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _kernel()(
            pts24_t.data_ptr(), vcon_t.data_ptr(), blob.data_ptr(),
            blob.numel(), raw.data_ptr(), N, n_samples,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_nerf_raw_q kernel launch failed: error {err}")
    fused_nerf_raw_tq.launches += 1
    fused_nerf_raw_tq.launches_by_samples[n_samples] = (
        fused_nerf_raw_tq.launches_by_samples.get(n_samples, 0) + 1)
    return raw


def _fused_nerf_raw_q_cpu(panels, blobs, pts24_t, vcon_t, n_samples):
    return fused_nerf_raw_q_plain(dict(zip(PANELS, panels)), pts24_t,
                                  vcon_t, n_samples).contiguous()


fused_nerf_raw_q_op = library.define(
    "fused_nerf_raw_q(Tensor[] panels, Tensor[] blobs, Tensor pts24_t, "
    "Tensor vcon_t, SymInt n_samples) -> Tensor",
    _fused_nerf_raw_q_cuda, _fused_nerf_raw_q_cpu, _raw_fake)


def fused_nerf_raw_tq(packed, pts24_t, vcon_t, n_samples: int = 8):
    """INT8 fused PE -> NeRF MLP forward (no autograd; inference path).

    Args:
      packed: :func:`pack_nerf_params_int8` output.
      pts24_t: [S*3, N] float32 query points, row 3*s + c = coordinate c of
        sample s (offsets applied).
      vcon_t: [128, N] float32 per-ray view-direction contribution, NOT yet
        scaled by ``packed["vcon_scale"]``.
      n_samples: S.

    Calls the op ``pronerf::fused_nerf_raw_q``: on CUDA tensors it launches
    the kernel or raises, on CPU tensors it runs the plain version. The JAX
    wrapper's ``rays_per_block`` is dropped: the CUDA kernel's tile is fixed
    at build time and it masks a ragged last tile itself.

    Returns: raw [N, S, 4] float32 (rgb logits, sigma), ready for
    ``ops.composite``.
    """
    panels = [packed[n] for n in PANELS]
    blobs = (attach_blobs(packed)[BLOBS_KEY]
             if pts24_t.device.type == "cuda" else [])
    return fused_nerf_raw_q_op(panels, blobs, pts24_t, vcon_t, n_samples)


# Launches of the kernel (counted where the op launches it): all of them,
# and by samples a ray
fused_nerf_raw_tq.launches = 0
fused_nerf_raw_tq.launches_by_samples = {}
