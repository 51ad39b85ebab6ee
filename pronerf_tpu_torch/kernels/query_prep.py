"""The NeRF kernel's inputs for the served frame, built in one CUDA kernel
(``csrc/query_prep.cu``: ``query_prep_kernel``) from the refine MinMax
kernel's output, the sorted sampler depths and the rays: rgb0, the query
points ``pts24_t``, the view term ``vcon_t``, the composite's [S, N] rows,
the direction norm and depth0, where the PyTorch chain
(:func:`query_inputs_chain`) runs about 35 launches and an f32 GEMM.

The JAX package writes this step in XLA; no TPU kernel is replaced. The
contract is the chain: on the card the kernel gives its outputs bit for bit
(the rounding points are listed at the head of the ``.cu``), except three
sums that may differ in their order only: the view term's 27 exact products
(cuBLAS picks its order), the norm over 3 and the mean over S.

The kernel is the ``torch.library`` op ``pronerf::query_prep``
(``library.define``): its CUDA implementation launches the kernel (or
raises) and counts the launch (``query_inputs.launches`` and
``profiling.COUNTERS["query_prep_launches"]``), its CPU implementation is
the chain itself, its fake one gives the shapes.
"""

from __future__ import annotations

import ctypes

import torch

from pronerf_tpu_torch.kernels import library
from pronerf_tpu_torch.ops.encoding import positional_encoding
from pronerf_tpu_torch.ops.sampling import bin_constrain
from pronerf_tpu_torch.utils.profiling import COUNTERS

MAX_SAMPLES = 32     # the kernel's shared-memory rows are sized up to 32
MAX_VIEW_ROWS = 128  # the NeRF MLP's view layer; DoNeRF's head has 4
VIEW_OCTAVES = 4     # the kernel encodes the view direction at 4 octaves


def refine_epilogue(refine_out, depth_values, n_samples: int, near: float,
                    far: float):
    """``(rgb0 [N, 3], z_vals [N, S])`` from the refine net's output
    ``refine_out`` [N, >= 4 S + 3] (S depth logits, 3 S point offsets, 3 rgb
    logits): the auxiliary colour and the refined depths, one inside each
    bin around the sorted sampler depths (``ops.sampling.bin_constrain``)."""
    S = n_samples
    rgb0 = torch.sigmoid(refine_out[:, 4 * S: 4 * S + 3])
    z_vals = bin_constrain(depth_values, torch.sigmoid(refine_out[:, :S]),
                           near, far)
    return rgb0, z_vals


def query_points_t(ndc_o, ndc_d, z_vals, offsets, offset_scale: float):
    """[3 S, N] float32 query points, row 3 s + c = coordinate c of sample
    s: ``ndc_o + ndc_d * z`` plus ``offset_scale * tanh(offsets)``, the
    offsets being the refine output's [N, 3 S] columns (``(s, c)`` order),
    or None for no offsets."""
    n, S = z_vals.shape
    pts24_t = (
        ndc_o.T[None, :, :] + ndc_d.T[None, :, :] * z_vals.T[:, None, :]
    ).reshape(3 * S, n)
    if offsets is not None:
        pts24_t = pts24_t + offset_scale * torch.tanh(offsets.T)
    return pts24_t.float().contiguous()


def query_inputs_chain(refine_out, depth_values, mm_add, mm_mul, ndc_o,
                       ndc_d, viewdirs, view_w, n_samples: int, near: float,
                       far: float, offset_scale: float, add_offsets: bool,
                       multires_views: int):
    """The PyTorch chain of :func:`query_inputs` (the op's CPU
    implementation, and the kernel's contract on the card)."""
    # the view term through its module's name, where a test may replace it
    from pronerf_tpu_torch.models import pronerf

    S = n_samples
    rgb0, z_vals = refine_epilogue(refine_out, depth_values, S, near, far)
    pts24_t = query_points_t(
        ndc_o, ndc_d, z_vals,
        refine_out[:, S: 4 * S] if add_offsets else None, offset_scale)
    d_pe = positional_encoding(viewdirs, multires_views)
    vcon_t = pronerf.view_contribution(view_w, d_pe, torch.bfloat16)
    dnorm_t = torch.linalg.norm(ndc_d, dim=-1)[None, :]
    return (rgb0, pts24_t, vcon_t, z_vals.T.float().contiguous(),
            mm_add.T.float().contiguous(), mm_mul.T.float().contiguous(),
            dnorm_t.float().contiguous(), torch.mean(z_vals, dim=-1))


OUTPUTS = ("rgb0", "pts24_t", "vcon_t", "z_t", "mm_add_t", "mm_mul_t",
           "dnorm_t", "depth0")
U = 2.0 ** -24  # the unit roundoff of float32


def sum_bounds(want, view_w, viewdirs, n_samples: int) -> dict:
    """How far the kernel's three sums may lie from the chain's ``want``
    (a tuple in :data:`OUTPUTS` order), which adds the same terms in
    another order (a worst case of each order is ``(k - 1) u`` times the
    sum of the k terms' sizes; the two orders differ by at most twice
    that), by output:

    - ``vcon_t``: 27 products, each exact (bf16 x bf16 in f32): ``52 u
      sum_k |w_k v_k|``;
    - ``dnorm_t``: three squares, then a square root: ``8 u |norm|``;
    - ``depth0``: S depths, then the product by the f32 reciprocal of S:
      ``(2 (S - 1) + 1) u mean|z|``."""
    from pronerf_tpu_torch.models import pronerf

    d_pe = positional_encoding(viewdirs, VIEW_OCTAVES)
    terms = pronerf.view_contribution(view_w.abs(), d_pe.abs(),
                                      torch.bfloat16)
    z_t = want[OUTPUTS.index("z_t")]
    return {"vcon_t": 52 * U * terms,
            "dnorm_t": 8 * U * want[OUTPUTS.index("dnorm_t")].abs(),
            "depth0": (2 * (n_samples - 1) + 1) * U * z_t.abs().mean(dim=0)}


def differences(got, want, view_w, viewdirs, n_samples: int) -> dict:
    """Where the op's outputs ``got`` leave the contract with the chain's
    ``want`` (tuples in :data:`OUTPUTS` order): by output, the elements
    whose bits differ (NaN of either sign as one value), or for the three
    sums those outside :func:`sum_bounds` or NaN on one side only; and
    the share of each sum's elements that are equal bit for bit
    (``<name>_exact``). A kernel that keeps the contract reads 0 for every
    output."""
    bounds = sum_bounds(want, view_w, viewdirs, n_samples)
    out = {}
    for name, g, w in zip(OUTPUTS, got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            out[name] = max(g.numel(), w.numel())
            continue
        nan = torch.isnan(g) | torch.isnan(w)
        same = (g.view(torch.int32) == w.view(torch.int32)) | (
            torch.isnan(g) & torch.isnan(w))
        ok = same
        if name in bounds:
            ok = same | (((g - w).abs() <= bounds[name]) & ~nan)
            out[f"{name}_exact"] = float(same.float().mean())
        out[name] = int((~ok).sum())
    return out


def _check_launch(refine_out, rows, view_w, n_samples, multires_views):
    """Refuse what the kernel does not take; ``rows`` are the [N, S] and
    [N, 3] inputs, in the op's order."""
    for name, t in (("refine_out", refine_out), ("view_w", view_w)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.stride(1) != 1:
            raise ValueError(f"{name} must be float32 [rows, C] with unit "
                             f"column stride, got {t.dtype} "
                             f"{tuple(t.shape)} strides {t.stride()}")
    S, n = n_samples, refine_out.shape[0]
    if not 1 <= S <= MAX_SAMPLES or refine_out.shape[1] < 4 * S + 3:
        raise ValueError(f"the kernel takes 1 to {MAX_SAMPLES} samples from "
                         f"4 S + 3 columns, got S = {S} and "
                         f"{refine_out.shape[1]} columns")
    want = [(n, S)] * 3 + [(n, 3)] * 3
    if [tuple(t.shape) for t in rows] != want:
        raise ValueError(f"depth_values, mm_add, mm_mul, ndc_o, ndc_d, "
                         f"viewdirs must be {want}, got "
                         f"{[tuple(t.shape) for t in rows]}")
    cd = 3 * (1 + 2 * VIEW_OCTAVES)
    if (multires_views != VIEW_OCTAVES or view_w.shape[1] != cd
            or not 1 <= view_w.shape[0] <= MAX_VIEW_ROWS):
        raise ValueError(f"the kernel encodes the view at {VIEW_OCTAVES} "
                         f"octaves for 1 to {MAX_VIEW_ROWS} rows of {cd} "
                         f"columns, got multires_views = {multires_views} "
                         f"and view_w {tuple(view_w.shape)}")


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from pronerf_tpu_torch.kernels.build import load

        fn = load("query_prep").pn_query_prep
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        fn.argtypes = [p, ll, p, p, p, p, p, p, p, ll, i, ll, i, f, f, f, i,
                       p, p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _outputs(like, n, S, R):
    def empty(*shape):
        return like.new_empty(shape, dtype=torch.float32)

    return (empty(n, 3), empty(3 * S, n), empty(R, n), empty(S, n),
            empty(S, n), empty(S, n), empty(1, n), empty(n))


def _query_prep_cuda(refine_out, depth_values, mm_add, mm_mul, ndc_o, ndc_d,
                     viewdirs, view_w, n_samples: int, near: float,
                     far: float, offset_scale: float, add_offsets: bool,
                     multires_views: int):
    """The op ``pronerf::query_prep`` on the card: launches
    ``query_prep_kernel`` or raises."""
    rows = [t.float().contiguous()
            for t in (depth_values, mm_add, mm_mul, ndc_o, ndc_d, viewdirs)]
    _check_launch(refine_out, rows, view_w, n_samples, multires_views)
    S, n = n_samples, refine_out.shape[0]
    outs = _outputs(refine_out, n, S, view_w.shape[0])
    if n == 0:
        return outs
    with torch.cuda.device(refine_out.device):
        # the chain's scalars as its kernels take them: f32 of the Python
        # floats
        err = _kernel()(
            refine_out.data_ptr(), refine_out.stride(0),
            *(t.data_ptr() for t in rows), view_w.data_ptr(),
            view_w.stride(0), view_w.shape[0], n, S, near, far,
            offset_scale, int(add_offsets), *(t.data_ptr() for t in outs),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        what = "arguments the kernel does not take" if err == -1 \
            else f"CUDA error {err}"
        raise RuntimeError(f"query_prep kernel launch failed: {what}")
    query_inputs.launches += 1
    COUNTERS["query_prep_launches"] += 1
    return outs


def _query_prep_cpu(refine_out, depth_values, mm_add, mm_mul, ndc_o, ndc_d,
                    viewdirs, view_w, n_samples, near, far, offset_scale,
                    add_offsets, multires_views):
    return query_inputs_chain(refine_out, depth_values, mm_add, mm_mul,
                              ndc_o, ndc_d, viewdirs, view_w, n_samples,
                              near, far, offset_scale, add_offsets,
                              multires_views)


def _query_prep_fake(refine_out, depth_values, mm_add, mm_mul, ndc_o, ndc_d,
                     viewdirs, view_w, n_samples, near, far, offset_scale,
                     add_offsets, multires_views):
    return _outputs(refine_out, refine_out.shape[0], n_samples,
                    view_w.shape[0])


query_prep_op = library.define(
    "query_prep(Tensor refine_out, Tensor depth_values, Tensor mm_add, "
    "Tensor mm_mul, Tensor ndc_o, Tensor ndc_d, Tensor viewdirs, "
    "Tensor view_w, SymInt n_samples, float near, float far, "
    "float offset_scale, bool add_offsets, SymInt multires_views) -> "
    "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
    _query_prep_cuda, _query_prep_cpu, _query_prep_fake)


def query_inputs(refine_out, depth_values, mm_add, mm_mul, ndc_o, ndc_d,
                 viewdirs, view_w, n_samples: int, near: float, far: float,
                 offset_scale: float, add_offsets: bool,
                 multires_views: int):
    """What the NeRF kernel takes, from the refine MinMax kernel's output.

    Args:
      refine_out: [N, >= 4 S + 3] float32, unit column stride (the refine
        kernel's row-major output, sliced): S depth logits, 3 S point
        offsets, 3 rgb logits.
      depth_values, mm_add, mm_mul: [N, S] sorted sampler depths and their
        density corrections.
      ndc_o, ndc_d, viewdirs: [N, 3] rays.
      view_w: [R, 27] float32 direction columns of the layer that reads the
        view features (``models.pronerf.view_weight``); rounded to bf16.
      n_samples, near, far, offset_scale, add_offsets, multires_views: the
        statics.

    Returns ``(rgb0 [N, 3], pts24_t [3 S, N], vcon_t [R, N], z_t [S, N],
    mm_add_t [S, N], mm_mul_t [S, N], dnorm_t [1, N], depth0 [N])``, float32,
    contiguous. Calls the op ``pronerf::query_prep``: on CUDA tensors it
    launches the kernel (S up to :data:`MAX_SAMPLES`, the view at
    :data:`VIEW_OCTAVES` octaves) or raises, on CPU tensors it runs
    :func:`query_inputs_chain`.
    """
    return query_prep_op(refine_out, depth_values, mm_add, mm_mul, ndc_o,
                         ndc_d, viewdirs, view_w, n_samples, near, far,
                         offset_scale, add_offsets, multires_views)


# Launches of the kernel (counted where the op launches it).
query_inputs.launches = 0
