"""The MinMax kernels' share of their roofline: the sampler (C = 6) and
refine (C = 6 + 3 V S) launches of a frame together (``work.minmax_kernel``
at the bf16 peak), over the traced time of the kernels named below."""

import work

LAYER = "kernels (kernels/fused_minmax.py)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["fern_trt.view_1008"]

STEMS = ("minmax_wg_kernel",)


def read(outcome):
    tr = outcome.trace
    us = tr.kernel_us(STEMS) if tr is not None else 0.0
    if not us:
        return None
    p = outcome.run.cell["params"]
    st = outcome.run.config["statics"]
    rays, S = p["height"] * p["width"], st["N_samples"]
    bound = (work.roofline_s(*work.minmax_kernel(rays, 6, 3 * S + 3))
             + work.roofline_s(*work.minmax_kernel(
                 rays, 6 + 3 * st["num_neighbor"] * S, 4 * S + 3)))
    return 100.0 * bound * tr.units / (us * 1e-6)
