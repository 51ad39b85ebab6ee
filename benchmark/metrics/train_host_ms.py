"""Host ms a training step of the executor's call: the benchmark's span
around each chunk's call (steps queued as graph replays, no host sync),
the mean over the window's chunks, divided by the steps a chunk."""

LAYER = "trainer (train/fast_loop.py executor)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "train_step_ms"
WORKLOADS = ["fern_epi.train_s1"]


def read(outcome):
    ms = outcome.run.spans.mean_ms("executor")
    return None if ms is None else ms / outcome.run.K
