"""The served frame's sampler depths, sorted, as one CUDA kernel
(``csrc/depth_sort.cu``: ``depth_sort_kernel``): the depths from the
sampler's logits, a stable per-ray sort carrying the density corrections,
and the 3D depths, in one pass over the sampler's output, where the
PyTorch chain (``ops/sampling.py:sort_sampler_depths``) runs about ten
launches around a block radix sort.

The JAX package sorts with ``jnp.sort``; no TPU kernel is replaced. The
contract is the chain: on the card the kernel gives its four outputs bit
for bit (the order and the rounding points are listed at the head of the
``.cu``).

The kernel is the ``torch.library`` op ``pronerf::depth_sort``
(``library.define``): its CUDA implementation launches the kernel (or
raises) and counts the launch (``sorted_sampler_depths.launches`` and
``profiling.COUNTERS["depth_sort_launches"]``), its CPU implementation is
the chain itself, its fake one gives the shapes.
"""

from __future__ import annotations

import ctypes

import torch

from pronerf_tpu_torch.kernels import library
from pronerf_tpu_torch.ops import sampling
from pronerf_tpu_torch.utils.profiling import COUNTERS

MAX_SAMPLES = 32  # the kernel's sorting network is instantiated up to 32


def _check_launch(mm_out, n_samples):
    if mm_out.dtype != torch.float32 or mm_out.dim() != 2 \
            or mm_out.stride(1) != 1:
        raise ValueError("mm_out must be float32 [N, C] with unit column "
                         f"stride, got {mm_out.dtype} {tuple(mm_out.shape)} "
                         f"strides {mm_out.stride()}")
    if not 1 <= n_samples <= MAX_SAMPLES or mm_out.shape[1] < 3 * n_samples:
        raise ValueError(f"the kernel sorts 1 to {MAX_SAMPLES} samples from "
                         f"3 S columns, got S = {n_samples} and "
                         f"{mm_out.shape[1]} columns")


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from pronerf_tpu_torch.kernels.build import load

        fn = load("depth_sort").pn_depth_sort
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        fn.argtypes = [p, ll, ll, i, f, f, f, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _depth_sort_cuda(mm_out, n_samples: int, near: float, far: float,
                     ndc_eps: float):
    """The op ``pronerf::depth_sort`` on the card: launches
    ``depth_sort_kernel`` or raises."""
    _check_launch(mm_out, n_samples)
    N = mm_out.shape[0]
    outs = tuple(torch.empty(N, n_samples, dtype=torch.float32,
                             device=mm_out.device) for _ in range(4))
    if N == 0:
        return outs
    with torch.cuda.device(mm_out.device):
        # the chain's scalars as its kernels take them: f32 of the Python
        # floats (far - near in double first)
        err = _kernel()(
            mm_out.data_ptr(), mm_out.stride(0), N, n_samples, far - near,
            near, ndc_eps, *(t.data_ptr() for t in outs),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        what = "arguments the kernel does not take" if err == -1 \
            else f"CUDA error {err}"
        raise RuntimeError(f"depth_sort kernel launch failed: {what}")
    sorted_sampler_depths.launches += 1
    COUNTERS["depth_sort_launches"] += 1
    return outs


def _depth_sort_cpu(mm_out, n_samples, near, far, ndc_eps):
    return sampling.sort_sampler_depths(mm_out, n_samples, near, far,
                                        ndc_eps)


def _depth_sort_fake(mm_out, n_samples, near, far, ndc_eps):
    n = mm_out.shape[0]
    return tuple(mm_out.new_empty(n, n_samples, dtype=torch.float32)
                 for _ in range(4))


depth_sort_op = library.define(
    "depth_sort(Tensor mm_out, SymInt n_samples, float near, float far, "
    "float ndc_eps) -> (Tensor, Tensor, Tensor, Tensor)",
    _depth_sort_cuda, _depth_sort_cpu, _depth_sort_fake)


def sorted_sampler_depths(mm_out, n_samples: int, near: float, far: float,
                          ndc_eps: float):
    """``(depth_values, mm_add, mm_mul, z3d)`` [N, S] from the sampler's
    raw output ``mm_out`` [N, >= 3 S] float32 (unit column stride; the
    MinMax kernel's row-major output, sliced): as
    :func:`ops.sampling.sort_sampler_depths`.

    Calls the op ``pronerf::depth_sort``: on a CUDA ``mm_out`` it launches
    the kernel (S up to :data:`MAX_SAMPLES`) or raises, on a CPU one it runs
    the chain.
    """
    return depth_sort_op(mm_out, n_samples, near, far, ndc_eps)


# Launches of the kernel (counted where the op launches it).
sorted_sampler_depths.launches = 0
