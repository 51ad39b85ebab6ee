"""Host ms of ``render_frame`` a frame: the benchmark's span from the call
to its return (the frame's launches queued, before the readback), the mean
over the window's frames."""

LAYER = "driver (render/renderer.py:render_frame)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "frame_ms"
WORKLOADS = ["fern_trt.view_1008"]


def read(outcome):
    return outcome.run.spans.mean_ms("render_frame")
