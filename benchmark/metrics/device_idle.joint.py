"""The share of the traced window in which no kernel or copy ran on the
device, while a scene trains in chunks of stage-2 joint steps: the reader
of ``device_idle.train``, on this cell's trace."""

import harness

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_step_ms"
WORKLOADS = ["fern_refine.train_s2"]

read = harness.load_module("metrics", "device_idle.train").read
