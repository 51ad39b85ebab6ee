"""Device ms a stage-2 joint step: the kernels launched inside the port's
span ``pn/step.joint`` (on the card one CUDA graph replay a step; its
kernels share the replay's launch), summed over the traced chunks, over
their steps."""

LAYER = "whole step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_step_ms"
WORKLOADS = ["fern_refine.train_s2"]


def read(outcome):
    tr = outcome.trace
    if tr is None or not tr.kernels or not tr.has_span("step.joint"):
        return None
    return tr.span_kernel_us("step.joint") / tr.units / 1e3
