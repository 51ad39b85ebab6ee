"""Kernels launched a frame, counted in the traced frames."""

LAYER = "frame body (models/pronerf.py:render_rays)"
UNIT = "count"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["fern_trt.view_1008"]


def read(outcome):
    tr = outcome.trace
    if tr is None or not tr.kernels:
        return None
    return len(tr.kernels) / tr.units
