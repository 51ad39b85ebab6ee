"""The whole DoNeRF frame's share of the chip's bf16 peak: the frame's
analytic operations (``work_donerf.pipeline_macs``, times 2) over the
traced window's time a frame."""

import work
import work_donerf

LAYER = "whole frame"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["fern_donerf.view_1008"]


def read(outcome):
    tr = outcome.trace
    if tr is None or not tr.kernels:
        return None
    p = outcome.run.cell["params"]
    st = outcome.run.config["statics"]
    macs = work_donerf.pipeline_macs(p["height"], p["width"], st["N_samples"],
                                     st["N_point_ray_enc"],
                                     st["num_neighbor"])
    flops = 2 * sum(macs.values())
    return 100.0 * flops / (tr.window_s / tr.units) \
        / work.PEAK_FLOPS["bfloat16"]
