"""Host ms a stage-2 joint step of the executor's fill (the port's span
``pn/fill``: the chunk's draws, learning rates and Adam counts written into
the graph's buffers before its replays), from the traced chunks, over
their steps."""

LAYER = "trainer (train/fast_loop.py executor)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_step_ms"
WORKLOADS = ["fern_refine.train_s2"]


def read(outcome):
    tr = outcome.trace
    if tr is None or not tr.kernels or not tr.has_span("fill"):
        return None
    return tr.program_us("fill") / tr.units / 1e3
