"""The work of the DoNeRF configuration (``configs/fern_donerf.json``),
counted from shapes as ``work.py`` counts: the DoNeRF net at the release
widths (the PE layer 63 -> 256, six layers 256 -> 256, the head on [h ‖
d_pe] 283 -> 4), the sampler and the refine net as ``work.pipeline_macs``
counts them."""

from __future__ import annotations

import work

# The DoNeRF kernel's multiply-adds a sample: the chain and the head's h
# half, 410,368; the head's direction half (27 x 4, one a ray) is computed
# outside the kernel and read as an input.
DONERF_KERNEL_MACS = 63 * 256 + 6 * 256 * 256 + 256 * 4
# the net's multiply-adds a sample as the reference counts them, its head
# on [feature, direction] per sample: 410,476
DONERF_POINT_MACS = work._dense([(63, 256)] + [(256, 256)] * 6 + [(283, 4)])


def donerf_kernel(rays: int, S: int = 8):
    """(operations, bytes) of the DoNeRF kernel over ``rays`` rays, counted
    as ``work.nerf_kernel`` counts the NeRF kernel: inputs the [3S, N] f32
    points, the [4, N] f32 direction term and the bf16 weights, output
    [N, S, 4] f32."""
    ops = 2 * DONERF_KERNEL_MACS * rays * S
    nbytes = (3 * S + 4) * rays * 4 + rays * S * 4 * 4 \
        + 2 * DONERF_KERNEL_MACS
    return ops, nbytes


def pipeline_macs(H: int, W: int, N_samples=8, N_point_ray_enc=48,
                  num_neighbor=4):
    """Multiply-adds of one frame, by net: the DoNeRF net on every sample,
    the sampler and the refine net as ``work.pipeline_macs``."""
    macs = work.pipeline_macs(H, W, N_samples, N_point_ray_enc,
                              num_neighbor)
    macs["nerf"] = H * W * N_samples * DONERF_POINT_MACS
    return macs
