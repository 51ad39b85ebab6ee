"""The stage-2 joint step's share of the chip's float32 peak (the port
trains in float32 with TF32 off): its analytic operations
(``work_joint.joint_step_flops``) over the traced window's time a step."""

import work
import work_joint

LAYER = "whole step"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_step_ms"
WORKLOADS = ["fern_refine.train_s2"]


def read(outcome):
    tr = outcome.trace
    if tr is None or not tr.kernels:
        return None
    train = outcome.run.config["train"]
    step_s = tr.window_s / tr.units
    return 100.0 * work_joint.joint_step_flops(
        train["N_rand"], train["N_samples"]) / step_s \
        / work.PEAK_FLOPS["float32"]
