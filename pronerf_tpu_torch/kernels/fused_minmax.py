"""Fused MinMaxRay MLP (sampler / refine net, 6x256 ELU + linear head) for
the serving path: packing, the plain PyTorch version, and the wrapper that
launches the CUDA kernel ``csrc/fused_minmax.cu``.

Counterpart of ``pronerf_tpu/kernels/fused_minmax.py``. The contract is the
same: the input is transposed, ``x_t [C, N]`` with rays contiguous; the first
layer is pre-FOLDED (the Pluecker ray signature is constant along a ray, so
the tiled ``[reps*6 | rest]`` input contracts to ``[6 | rest]`` with
row-block-summed weights); the head is padded to a multiple of 8 columns
and callers slice the true width.

Rounding points (part of the function, shared by kernel and plain version):
every dot takes operands in the pack dtype, accumulates in f32 and is rounded
to the pack dtype; the bias is added in the pack dtype; ELU is
``exp(min(x, 0)) - 1`` evaluated in f32 on the rounded value and rounded
again; the head is returned as f32.

The kernel is the ``torch.library`` op ``pronerf::fused_minmax``, so that a
traced program can name it: its CUDA implementation launches the kernel (or
raises) and counts the launch, its CPU implementation is
:func:`fused_minmax_plain`, its fake one gives the shape. The blobs the
kernel reads are built at pack time (``attach_blobs``) and handed to the op
as tensors.
"""

from __future__ import annotations

import ctypes

import torch

from pronerf_tpu_torch.kernels.stages import (
    SLAB_K,
    halves,
    images,
    pad_k,
    slabs,
)

W = 256


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _pad32(n: int) -> int:
    return -(-n // 32) * 32


def pack_minmax_params(net, reps: int, dtype=torch.bfloat16, c_rep: int = 6,
                       rest_row_perm=None):
    """Transposed kernel panels for a no-skip MinMax net whose first
    ``reps * c_rep`` input features are an exact tiling.

    Args:
      net: a :class:`pronerf_tpu_torch.models.mlp.MinMaxMLP`.
      reps: tile count of the repeated leading block (48 sampler, 8 refine).
      c_rep: width of the repeated block: 6 (Pluecker [d, m]).
      rest_row_perm: optional permutation of the NON-repeated trailing input
        features, ``rest_new[i] = rest_old[perm[i]]``.

    Returns a dict with the same keys, shapes and values as the JAX pack:
    ``w{i}_t [256, in]``, ``b{i} [256, 1]``, ``wout_t [out_pad, 256]``,
    ``bout [out_pad, 1]`` in ``dtype``, and on the card the kernel's blobs
    (``attach_blobs``). (The folded columns are a sum of
    ``reps`` f32 terms, so they agree with another framework's pack to the
    last bits of that sum, not bit for bit; everything else is a copy.)
    """
    if net.skips:
        raise ValueError("the fold supports the release no-skip nets")
    layers = list(net.layers)
    w0 = layers[0].weight.detach().T  # [reps*c_rep + rest, 256]
    if w0.shape[0] < reps * c_rep:
        raise ValueError(
            f"first layer has {w0.shape[0]} input rows < reps*c_rep = "
            f"{reps * c_rep}; wrong reps/c_rep for this net"
        )
    w_rep = w0[: reps * c_rep].reshape(reps, c_rep, -1).sum(0)
    w0_rest = w0[reps * c_rep:]
    if rest_row_perm is not None:
        if len(rest_row_perm) != w0_rest.shape[0]:
            raise ValueError(
                f"rest_row_perm has {len(rest_row_perm)} entries for "
                f"{w0_rest.shape[0]} trailing rows"
            )
        w0_rest = w0_rest[torch.as_tensor(rest_row_perm, dtype=torch.long,
                                          device=w0.device)]
    w0_eff = torch.cat([w_rep, w0_rest], dim=0)  # [c_rep + rest, 256]

    n_out = net.out.weight.shape[0]
    out_pad = _pad8(n_out)
    w_out = w0.new_zeros(out_pad, W)
    w_out[:n_out] = net.out.weight.detach()
    b_out = w0.new_zeros(out_pad)
    b_out[:n_out] = net.out.bias.detach()

    def bias(b):
        return b.detach().reshape(-1, 1).to(dtype)

    packed = {
        "w0_t": w0_eff.T.contiguous().to(dtype),
        "b0": bias(layers[0].bias),
        "wout_t": w_out.to(dtype), "bout": bias(b_out),
    }
    for i, layer in enumerate(layers[1:], start=1):
        packed[f"w{i}_t"] = layer.weight.detach().contiguous().to(dtype)
        packed[f"b{i}"] = bias(layer.bias)
    return attach_blobs(packed)


def _depth(packed) -> int:
    return 1 + max(
        int(k[1:-2]) for k in packed if k.startswith("w") and k[1].isdigit()
    )


def _mm(h, w_t):
    """[N, K] x w_t [M, K] -> [N, M]: operands in the pack dtype, f32
    accumulation, rounded to the pack dtype."""
    return (h.to(w_t.dtype).float() @ w_t.float().T).to(w_t.dtype)


def _elu(x):
    xf = x.float()
    return torch.where(
        xf > 0, xf, torch.exp(torch.clamp(xf, max=0.0)) - 1.0
    ).to(x.dtype)


def fused_minmax_plain(packed, x_t, transpose_out: bool = True):
    """Plain PyTorch version of :func:`fused_minmax_t`, same rounding
    points. Runs on any device; nothing on the card's main path calls it."""
    depth = _depth(packed)
    h = x_t.T.to(packed["w0_t"].dtype)
    for i in range(depth):
        h = _elu(_mm(h, packed[f"w{i}_t"]) + packed[f"b{i}"].reshape(1, -1))
    out = (_mm(h, packed["wout_t"]) + packed["bout"].reshape(1, -1)).float()
    return out if transpose_out else out.T


_BLOB_KEY = "_kernel_blob"
# The bf16 kernel's layer 0 takes K = C padded to a multiple of 16, in
# passes of at most two k-slabs of 64 (one pass for C <= 128; the refine net
# of 4 views and 8 samples has C = 102).
PASS_SLABS = 2


def ring_stages(packed):
    """The ring stages of one tile of the bf16 kernel, in the order it
    consumes them: layer 0 per half of 128 outputs, one stage a pass (two of
    the half's k-slabs, the last pass what is left), then each hidden layer
    as four stages of two slabs."""
    n0 = -(-packed["w0_t"].shape[1] // SLAB_K)
    ring = [st for half in (0, 1)
            for st in slabs("w0_t", W // 2, half * W // 2,
                            per_stage=PASS_SLABS, n=n0)]
    for i in range(1, _depth(packed)):
        ring += halves(f"w{i}_t")
    return tuple(tuple(st) for st in ring)


def head_slabs(packed):
    """The head ``wout_t [out_pad, 256]`` as four k-slabs, resident in the
    block's shared memory."""
    out_pad = packed["wout_t"].shape[0]
    return tuple(("wout_t", 0, out_pad, ks) for ks in range(W // SLAB_K))


def bias_order(packed):
    return tuple(f"b{i}" for i in range(_depth(packed))) + ("bout",)


def _blob(packed):
    """The panels as the one contiguous buffer the kernel reads (see the
    head of ``csrc/fused_minmax.cu``), built once and kept in ``packed``:
    for bf16 the stage images of the ring, the head slabs and the biases;
    for f32 the panels in order, the first padded to a multiple of 32
    columns."""
    blob = packed.get(_BLOB_KEY)
    if blob is None:
        w0 = packed["w0_t"]
        if w0.dtype == torch.bfloat16:
            parts = images(packed, ring_stages(packed) + (head_slabs(packed),))
            parts += [packed[name].reshape(-1) for name in bias_order(packed)]
        else:
            parts = [pad_k(w0, _pad32(w0.shape[1])), packed["b0"]]
            for i in range(1, _depth(packed)):
                parts += [packed[f"w{i}_t"], packed[f"b{i}"]]
            parts += [packed["wout_t"], packed["bout"]]
        blob = torch.cat([p.reshape(-1) for p in parts]).contiguous()
        packed[_BLOB_KEY] = blob
    return blob


# The bf16 kernel keeps the head [out_pad, 256] and two result buffers
# [128, out_pad] in shared memory for the block's life, beside the layer-0 A
# rows, the biases and at least two ring stages (``MmSmem`` in
# ``csrc/fused_minmax.cu``, mirrored by ``_wg_fits``). A head too large for
# that (the refine net of more than 29 samples a ray, 4 S + 3 outputs) runs
# in parts of its rows, one launch a part, each writing its own columns of
# ``out`` and running the whole trunk.
_SMEM_LIMIT = 232448 - 1024
_RING_STAGE = 32768
BLOBS_KEY = "_kernel_blobs"


def _wg_fits(C: int, depth: int, out_pad: int) -> bool:
    n0 = -(-(-(-C // 16) * 16) // SLAB_K)
    a_rows = 2 * min(n0, PASS_SLABS) * 64 * 128
    biases = ((depth * W + out_pad) * 2 + 15) & ~15
    rest = biases + 2 * (128 * out_pad * 2) + 256
    return _SMEM_LIMIT - a_rows - out_pad * 512 - rest >= 2 * _RING_STAGE


def head_parts(C: int, depth: int, out_pad: int):
    """Row ranges ``(c0, c1)`` of the head that the bf16 kernel computes one
    launch each: the whole head where it fits, else the fewest parts of
    equal size (a multiple of 8) that each fit."""
    if _wg_fits(C, depth, out_pad):
        return ((0, out_pad),)
    fit = [n for n in range(8, out_pad, 8) if _wg_fits(C, depth, n)]
    if not fit:
        raise ValueError(f"no head part fits the bf16 kernel at C={C}")
    size = _pad8(-(-out_pad // -(-out_pad // fit[-1])))
    return tuple((c, min(c + size, out_pad)) for c in range(0, out_pad, size))


def _parts(packed, C):
    """``head_parts`` with the pack of each part (the trunk's panels, the
    part's head rows)."""
    out_pad = packed["wout_t"].shape[0]
    ranges = head_parts(C, _depth(packed), out_pad)
    if len(ranges) == 1:
        return ((0, out_pad, packed),)
    trunk = {k: v for k, v in packed.items()
             if not k.startswith("_") and k not in ("wout_t", "bout")}
    return tuple(
        (c0, c1, trunk | {"wout_t": packed["wout_t"][c0:c1].clone(),
                          "bout": packed["bout"][c0:c1].clone()})
        for c0, c1 in ranges)


def panel_names(depth: int):
    """The pack's panels in the order the op takes them."""
    return tuple(n for i in range(depth) for n in (f"w{i}_t", f"b{i}")) + (
        "wout_t", "bout")


def attach_blobs(packed):
    """Build the kernel's blobs (one a head part for bf16 panels, see
    ``head_parts``) and keep them in ``packed`` under ``BLOBS_KEY``: at pack
    time, so that no traced or captured call builds them. Only a pack on the
    card gets them (the plain version reads the panels); returns ``packed``.
    """
    w0 = packed["w0_t"]
    if w0.device.type == "cuda" and BLOBS_KEY not in packed:
        parts = (_parts(packed, w0.shape[1]) if w0.dtype == torch.bfloat16
                 else ((0, packed["wout_t"].shape[0], packed),))
        packed[BLOBS_KEY] = [_blob(part) for _, _, part in parts]
    return packed


def _blobs(packed):
    """The blobs the op hands the kernel: those of the pack, built now for
    a pack on the card that has none."""
    return attach_blobs(packed).get(BLOBS_KEY, [])


def _check_launch(panels, blobs, x_t):
    w0 = panels[0]
    if x_t.dim() != 2 or x_t.shape[0] != w0.shape[1]:
        raise ValueError(
            f"x_t must be [C={w0.shape[1]}, N], got {tuple(x_t.shape)}"
        )
    if x_t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x_t must be float32 or bfloat16, got {x_t.dtype}")
    if w0.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pack dtype {w0.dtype} has no kernel")
    if not x_t.is_contiguous():
        raise ValueError("x_t must be contiguous")
    if w0.device != x_t.device:
        raise ValueError(f"panels on {w0.device}, x_t on {x_t.device}")
    if not blobs:
        raise ValueError("the pack has no kernel blob (attach_blobs)")


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from pronerf_tpu_torch.kernels.build import load

        fn = load("fused_minmax").pn_fused_minmax
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, p, ll, p, i, i, i, i, ll, ll, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@torch.library.custom_op("pronerf::fused_minmax", mutates_args=(),
                         device_types="cuda")
def fused_minmax_op(panels: list[torch.Tensor], blobs: list[torch.Tensor],
                    x_t: torch.Tensor, transpose_out: bool) -> torch.Tensor:
    """The op ``pronerf::fused_minmax`` on the card: launches
    ``minmax_wg_kernel`` (bf16 panels; one launch a head part) or the f32
    kernel, or raises. ``panels`` in ``panel_names`` order, ``blobs`` as
    ``attach_blobs`` builds them."""
    _check_launch(panels, blobs, x_t)
    depth = (len(panels) - 2) // 2
    w0 = panels[0]
    C, N = x_t.shape
    out_pad = panels[-2].shape[0]
    is_bf16 = w0.dtype == torch.bfloat16
    ranges = head_parts(C, depth, out_pad) if is_bf16 else ((0, out_pad),)
    if len(ranges) != len(blobs):
        raise ValueError(f"{len(blobs)} blobs for {len(ranges)} head parts")
    if transpose_out:
        out = torch.empty(N, out_pad, dtype=torch.float32, device=x_t.device)
        strides, col = (out_pad, 1), 1
    else:
        out = torch.empty(out_pad, N, dtype=torch.float32, device=x_t.device)
        strides, col = (1, N), N
    for (c0, c1), blob in zip(ranges, blobs):
        with torch.cuda.device(x_t.device):
            err = _kernel()(
                x_t.data_ptr(), int(x_t.dtype == torch.bfloat16),
                blob.data_ptr(), blob.numel(),
                out.data_ptr() + 4 * c0 * col, N, C, depth,
                c1 - c0, strides[0], strides[1], int(is_bf16),
                torch.cuda.current_stream().cuda_stream,
            )
        if err != 0:
            what = ("arguments the kernel does not take (it needs N > 0, a "
                    "head padded to a multiple of 8 and the blob built by "
                    "this module)" if err == -1 else f"CUDA error {err}")
            raise RuntimeError(f"fused_minmax kernel launch failed: {what}")
        fused_minmax_t.launches += 1
        fused_minmax_t.launches_by_width[C] = (
            fused_minmax_t.launches_by_width.get(C, 0) + 1)
        if not transpose_out:
            fused_minmax_t.launches_untransposed[C] = (
                fused_minmax_t.launches_untransposed.get(C, 0) + 1)
    return out


@fused_minmax_op.register_kernel("cpu")
def _(panels, blobs, x_t, transpose_out):
    depth = (len(panels) - 2) // 2
    packed = dict(zip(panel_names(depth), panels))
    return fused_minmax_plain(packed, x_t, transpose_out).contiguous()


@fused_minmax_op.register_fake
def _(panels, blobs, x_t, transpose_out):
    n, out_pad = x_t.shape[1], panels[-2].shape[0]
    shape = (n, out_pad) if transpose_out else (out_pad, n)
    return x_t.new_empty(shape, dtype=torch.float32)


def fused_minmax_t(packed, x_t, transpose_out: bool = True):
    """Fused MinMax MLP forward (no autograd; inference path).

    Args:
      packed: :func:`pack_minmax_params` output (bf16 or f32 panels).
      x_t: [C, N] transposed input, float32 or bfloat16, contiguous.
      transpose_out: True returns row-major [N, out_pad]; False returns
        [out_pad, N].

    Calls the op ``pronerf::fused_minmax``: on a CUDA ``x_t`` it launches
    the kernel or raises, on a CPU one it runs :func:`fused_minmax_plain`.
    The JAX wrapper's ``rays_per_block`` is dropped: the CUDA kernel's tile
    is fixed at build time and it masks a ragged last tile itself. bf16
    panels run ``minmax_wg_kernel`` (``wgmma``; layer 0 in passes of 128
    input rows where C > 128; a head too large for its shared memory in
    parts, one launch each, see ``head_parts``), f32 panels the exact FMA
    kernel.

    Returns float32; the caller slices its true output width (pad columns are
    exact zero-weight products).
    """
    panels = [packed[n] for n in panel_names(_depth(packed))]
    blobs = _blobs(packed) if x_t.device.type == "cuda" else []
    return fused_minmax_op(panels, blobs, x_t, transpose_out)


# Launches of the kernel (counted where the op launches it): all of them,
# and by input width C (the sampler and the refine net go through this one
# op and differ in C); those with ``transpose_out=False`` (the transposed
# serving graph's form) are also counted apart, by width too.
fused_minmax_t.launches = 0
fused_minmax_t.launches_by_width = {}
fused_minmax_t.launches_untransposed = {}
