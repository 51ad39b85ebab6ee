"""The yardstick: the chip's published peaks and the work of each kernel and
step, counted from shapes, the same whatever implements them.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates without
sparsity), at its 700 W limit. Work: multiply-adds of the ProNeRF nets at
the release widths (NeRF 8 x 256 with the skip after layer 4 and a 128-wide
view branch; sampler and refine 6 x 256), each input byte read once and
each output byte written once.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
PEAK_BYTES_S = 3.35e12


def _dense(dims):
    return sum(a * b for a, b in dims)


def pipeline_macs(H: int, W: int, N_samples=8, N_point_ray_enc=48,
                  num_neighbor=4, netwidth=256, mmnetwidth=256, mmnetdepth=6):
    """Multiply-adds of one frame, by net, as the reference's ptflops count
    gives them: the NeRF on every sample (its view layer on [feature,
    direction] per sample), the sampler on the 48-point signature, the
    refine net on [signature of the candidates || colours]."""
    rays = H * W
    w = netwidth
    nerf = ([(63, w)] + [(w, w)] * 4 + [(w + 63, w)] + [(w, w)] * 2
            + [(w, 1), (w, w), (w + 27, w // 2), (w // 2, 3)])
    mw = mmnetwidth
    sampler = [(6 * N_point_ray_enc, mw)] + [(mw, mw)] * (mmnetdepth - 1) \
        + [(mw, 3 * N_samples + 3)]
    refine = [(6 * N_samples + 3 * num_neighbor * N_samples, mw)] \
        + [(mw, mw)] * (mmnetdepth - 1) + [(mw, 4 * N_samples + 3)]
    return {"nerf": rays * N_samples * _dense(nerf),
            "sampler": rays * _dense(sampler),
            "refine": rays * _dense(refine)}


# The NeRF kernel's work a sample: the PE -> 8 layers -> heads chain and
# the feature half of the view layer; the direction half (one a ray) is
# computed outside the kernel and read as an input.
NERF_KERNEL_MACS = (63 * 256 + 4 * 256 * 256 + (63 + 256) * 256
                    + 2 * 256 * 256 + 256 + 256 * 256 + 256 * 128 + 128 * 3)


def nerf_kernel(rays: int, S: int = 8):
    """(operations, bytes) of the raw NeRF kernel over ``rays`` rays:
    inputs the [3S, N] f32 points, the [128, N] f32 direction term and the
    bf16 weights, output [N, S, 4] f32."""
    ops = 2 * NERF_KERNEL_MACS * rays * S
    nbytes = (3 * S + 128) * rays * 4 + rays * S * 4 * 4 \
        + 2 * NERF_KERNEL_MACS
    return ops, nbytes


def minmax_kernel(rays: int, c_in: int, c_out: int):
    """(operations, bytes) of one MinMax kernel launch: the first layer on
    the folded input of ``c_in`` rows (6 for the sampler, 6 + 96 for the
    refine net), 5 hidden layers, the head; f32 input [c_in, N], f32 output
    [N, c_out], bf16 weights."""
    macs = c_in * 256 + 5 * 256 * 256 + 256 * c_out
    return 2 * rays * macs, (c_in + c_out) * rays * 4 + 2 * macs


def roofline_s(ops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time the chip could take: the larger of operations over
    the peak of their type and bytes over the memory bandwidth."""
    return max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S)


def stage1_pair_flops(rays: int, explore_width: int = 64, S: int = 8):
    """Operations of one stage-1 step pair (a NeRF step at the exploration
    width, then a sampler step), counted as the reference trains: a forward
    and backward costs three forwards (the backward takes the gradients of
    the inputs and of the weights); the NeRF step runs the sampler and
    refine nets forward only, frozen."""
    per_point = _dense([(63, 256)] + [(256, 256)] * 4 + [(256 + 63, 256)]
                       + [(256, 256)] * 2 + [(256, 1), (256, 256),
                                             (256 + 27, 128), (128, 3)])
    mm = _dense([(288, 256)] + [(256, 256)] * 5 + [(256, 27)]) \
        + _dense([(144, 256)] + [(256, 256)] * 5 + [(256, 35)])
    nerf_step = 3 * 2 * per_point * rays * explore_width + 2 * mm * rays
    sampler_step = 3 * 2 * (per_point * rays * S + mm * rays)
    return nerf_step + sampler_step
