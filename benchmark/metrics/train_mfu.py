"""The whole training step's share of the chip's float32 peak (the port
trains in float32 with TF32 off): the stage-1 step pair's analytic
operations (``work.stage1_pair_flops``) over the traced window's time a
pair."""

import work

LAYER = "whole step"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_step_ms"
WORKLOADS = ["fern_epi.train_s1"]


def read(outcome):
    tr = outcome.trace
    if tr is None or not tr.kernels:
        return None
    rays = outcome.run.config["train"]["N_rand"]
    pair_s = 2 * tr.window_s / tr.units
    return 100.0 * work.stage1_pair_flops(rays) / pair_s \
        / work.PEAK_FLOPS["float32"]
