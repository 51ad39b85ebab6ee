"""The controls, on the card at a size a test run holds: the reference in
the program's place, a precision below the configuration's, reads over
the cell's limits while the program reads under them. The readings at the
cells' own sizes come from ``python3 benchmark/control.py --workload
<cell>`` (``PERF.md`` §2). Without a card these tests skip."""

import pytest

import control
import harness
from reference import pronerf as ref
from traffic import train_chunks, viewer


@pytest.mark.card
def test_tf32_control_fails_the_training_limits(card):
    cell = harness.load_json("workloads", "fern_epi.train_s1")
    cell["params"].update(reshuffle_after=2, check_within=2)
    config = harness.load_json("configs", "fern_epi")
    config["train"]["N_rand"] = 1024
    config["scene"].update(height=378, width=504)
    t = train_chunks.Trainer(cell, config, card, 2**33 + 17)
    t.window(0.0)
    t.free()
    limits = cell["limits"]
    for f in t.followed:
        want = t.reference_chunk(f)
        program = train_chunks.compare(f["after"], want, t.K)
        assert all(program[k] <= lim for k, lim in limits.items()), program
        tf32 = train_chunks.compare(
            control.as_after(t.reference_chunk(f, tf32=True)), want, t.K)
        assert any(tf32[k] > lim for k, lim in limits.items()), tf32


@pytest.mark.card
def test_fp8_control_fails_the_viewer_limits(card):
    cell = harness.load_json("workloads", "fern_trt.view_1008")
    cell["params"].update(height=378, width=504, check_frames=2)
    config = harness.load_json("configs", "fern_trt")
    v = viewer.Viewer(cell, config, card)
    limits = cell["limits"]
    program = control.readings(v, 2**33 + 19, 0.5)
    assert all(program[k] <= lim for k, lim in limits.items()), program
    fp8 = control.readings(v, 2**33 + 19, 0.5, ref.fp8, program=False)
    assert any(fp8[k] > lim for k, lim in limits.items()), fp8
