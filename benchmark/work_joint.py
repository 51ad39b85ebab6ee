"""The work of one stage-2 joint step (``configs/llff/fern/fern_refine.txt``),
counted from shapes as ``work.stage1_pair_flops`` counts: the NeRF on every
sample, the sampler on the 48-point signature and the refine net on the
candidates' signature and colours, all three forward and backward (three
forwards: the backward takes the gradients of the inputs and of the
weights), at the release widths."""

from __future__ import annotations

from work import _dense

# multiply-adds of the NeRF a sample point (8 x 256, the skip after layer 4,
# the 128-wide view branch): 593,408
NERF_POINT_MACS = _dense(
    [(63, 256)] + [(256, 256)] * 4 + [(256 + 63, 256)] + [(256, 256)] * 2
    + [(256, 1), (256, 256), (256 + 27, 128), (128, 3)])
# multiply-adds of the sampler and the refine net a ray (6 x 256 each):
# 408,320 + 373,504 = 781,824
MINMAX_RAY_MACS = _dense([(288, 256)] + [(256, 256)] * 5 + [(256, 27)]) \
    + _dense([(144, 256)] + [(256, 256)] * 5 + [(256, 35)])


def joint_step_flops(rays: int, S: int = 8) -> int:
    """Operations of one joint step over ``rays`` rays of ``S`` samples:
    3 x 2 x (NeRF at S + sampler + refine) a ray."""
    return 3 * 2 * (NERF_POINT_MACS * S + MINMAX_RAY_MACS) * rays
