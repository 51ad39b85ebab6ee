"""The reader ``joint_key_ms`` (cell ``fern_refine.train_s2``) on a
hand-built Chrome trace, reduced as the cell reduces its traced chunks
(``program_trace.read``): the host ms of the port's ``pn/key`` a step, and
nothing where the program has no such span."""

import dataclasses
import json
import types

import pytest

import harness
import program_trace


def chrome_trace():
    """Two chunks of 8 joint steps, 40 ms each: in each a 1 ms fill, then
    the graph key's walk (``pn/key``, 0.4 ms), then 8 replays of one 3 ms
    kernel each."""
    ev, c = [], 0

    def x(cat, name, ts, dur, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur, "args": args})

    for chunk in range(2):
        t = chunk * 40_000.0
        x("user_annotation", "bench/chunk", t, 40_000.0)
        x("user_annotation", "pn/chunk", t + 10, 39_000.0)
        x("user_annotation", "pn/fill", t + 20, 1_000.0)
        x("user_annotation", "pn/key", t + 1_100, 400.0)
        for s in range(8):
            ts = t + 2_000.0 + 4_000.0 * s
            x("user_annotation", "pn/step.joint", ts, 50.0)
            c += 1
            x("cuda_runtime", "cudaGraphLaunch", ts + 10, 20.0,
              correlation=c)
            x("kernel", "sgemm", ts + 100, 3_000.0, correlation=c)
    return {"traceEvents": ev}


@pytest.fixture
def outcome(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(chrome_trace()))
    return types.SimpleNamespace(
        trace=program_trace.read(path, "chunk", 16),
        run=types.SimpleNamespace(K=8))


def read(outcome):
    return harness.load_module("metrics", "joint_key_ms").read(outcome)


def test_joint_key_ms_is_the_key_spans_host_ms_a_step(outcome):
    assert outcome.trace.has_span("key")
    assert read(outcome) == pytest.approx(2 * 0.4 / 16)
    # the walk launches nothing: its kernels are none
    assert outcome.trace.span_kernel_us("key") == 0


def test_joint_key_ms_reads_nothing_without_the_span(outcome):
    tr = outcome.trace
    outcome.trace = dataclasses.replace(
        tr, program=[p for p in tr.program if p[0] != "key"])
    assert read(outcome) is None
    outcome.trace = None
    assert read(outcome) is None
