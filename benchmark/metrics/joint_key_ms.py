"""Host ms a stage-2 joint step of the executor's graph key (the port's
span ``pn/key``: every state tensor's, the pool's and the scene's address,
compared with those the graphs were captured on), from the traced chunks,
over their steps."""

LAYER = "trainer (train/fast_loop.py executor)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_step_ms"
WORKLOADS = ["fern_refine.train_s2"]


def read(outcome):
    tr = outcome.trace
    if tr is None or not tr.kernels or not tr.has_span("key"):
        return None
    return tr.program_us("key") / tr.units / 1e3
