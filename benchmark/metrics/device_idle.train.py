"""The share of the traced window in which no kernel or copy ran on the
device, while a scene trains in chunks."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_step_ms"
WORKLOADS = ["fern_epi.train_s1"]


def read(outcome):
    tr = outcome.trace
    if tr is None or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.device_busy_s() / tr.window_s)
