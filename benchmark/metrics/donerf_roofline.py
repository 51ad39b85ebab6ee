"""The DoNeRF kernel's share of its roofline: the least time the chip could
take for the DoNeRF net over the frame's samples
(``work_donerf.donerf_kernel``: operations over the bf16 peak, or bytes
over the bandwidth where larger), over the traced time of the kernels
named below, a frame."""

import work
import work_donerf

LAYER = "kernels (kernels/fused_nerf.py)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["fern_donerf.view_1008"]

STEMS = ("donerf_wg_kernel",)


def read(outcome):
    tr = outcome.trace
    us = tr.kernel_us(STEMS) if tr is not None else 0.0
    if not us:
        return None
    p = outcome.run.cell["params"]
    S = outcome.run.config["statics"]["N_samples"]
    bound = work.roofline_s(*work_donerf.donerf_kernel(
        p["height"] * p["width"], S))
    return 100.0 * bound * tr.units / (us * 1e-6)
