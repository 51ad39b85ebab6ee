"""Stage 2 in the benchmark, on the CPU at a small size: the float32
stage-2 reference against the port's joint step, the ``train_joint``
traffic's followed chunks against the reference, the faults its check has
to see, and the readers of the port's spans on a hand-built trace."""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import control
import harness
import program_trace
import run
import work_joint
from reference import scene as rscene
from reference import train as rtrain
from reference import train_s2 as rs2
from traffic import train_chunks, train_joint

torch.set_num_threads(2)

CELL = "fern_refine.train_s2"


def small_config(n_rand=64):
    config = harness.load_json("configs", "fern_refine")
    config["train"]["N_rand"] = n_rand
    config["scene"].update(height=36, width=48)
    return config


def small_cell():
    cell = harness.load_json("workloads", CELL)
    cell["params"].update(reshuffle_after=2, check_within=2, trace_chunks=2)
    return cell


def test_train_config_is_fern_refine_with_scan_steps():
    """The configuration's training fields are ``fern_refine.txt``'s (every
    key of the file) and the port's defaults it relies on, with the
    ``scan_steps`` it assumes."""
    from pronerf_tpu_torch.config import Config, parse_config_file

    config = harness.load_json("configs", "fern_refine")
    path = harness.ROOT / config["source_config"]
    cfg = Config.from_file(path, scan_steps=config["train"]["scan_steps"])
    assert set(parse_config_file(path)) <= set(config["train"])
    for key, value in config["train"].items():
        got = getattr(cfg, key)
        assert (list(got) if isinstance(got, tuple) else got) == value, key
    assert "scan_steps" in config["assumed"] and config["reduced"] == []


@pytest.mark.parametrize("step", [370001, 370002, 9])
def test_stage2_draws_are_the_executors(step):
    """The stage-2 executor draws its noise at the width N_samples; the
    reference takes the same draws."""
    from pronerf_tpu_torch.train.fast_loop import draw_device_controls

    want = draw_device_controls(2**41 + 5, step, 14, 4, 8, 32, 8, "cpu")
    got = rtrain.draws(2**41 + 5, step, 14, 4, 8, 32, 8, "cpu")
    for a, b in (("dir_jitter", "dir_jitter"), ("subset", "neighbor_subset"),
                 ("raw_noise", "raw_noise"),
                 ("jitter_noise", "jitter_noise")):
        assert torch.equal(got[a], want[b]), a


# ----------------------------------- the port's step against the reference --

# Tolerances of the port's joint step against the reference, over three
# steps at 24x32 with seeded random weights, both in float32 on the CPU.
# The two compute the same expressions; they differ in the order of some
# sums (the port folds the 48 collinear signature points into the
# sampler's first layer, encodes the view directions once a ray, and
# reduces the mean fill in its own order), a few ulps of each value.
LOSS_REL = 1e-5    # the step's loss: one mean of 64 x 3 squared errors
GRAD_REL = 1e-4    # a leaf's gradient, against the leaf's largest
                   # magnitude: a backward pass of 15 layers adds the
                   # forward's ulps of every layer; first read 2.1e-6 (mu)
PARAM_REL = 1e-6   # a leaf after 3 updates, against its largest magnitude:
                   # Adam's steps are lr (3e-4) times a unit-size direction
NU_REL = 1e-4      # Adam's second moment: squares of the gradients


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.fixture(scope="module")
def three_steps():
    """Three joint steps of the port (``make_stage2_step``, fed the
    executor's draws) and of the reference from the same random weights
    and rows; each step's gradients worked out from Adam's first moment."""
    from pronerf_tpu_torch.config import Config
    from pronerf_tpu_torch.models.pronerf import init_pronerf_params
    from pronerf_tpu_torch.render.raygen import prepare_scene
    from pronerf_tpu_torch.train.fast_loop import draw_device_controls
    from pronerf_tpu_torch.train.stage2 import (
        init_stage2_state,
        make_stage2_step,
    )
    from pronerf_tpu_torch.train.state import named_params, stage2_lr

    config = small_config()
    train = config["train"]
    cfg = Config(**train)
    H, W = 24, 32
    views = train_chunks.training_views(config["scene"])
    sc = rscene.synthetic_scene(config["scene"]["views"], H, W, seed=0,
                                views=views)
    focal = float(sc["K"][0, 0])
    images = torch.as_tensor(sc["images"])
    poses = torch.as_tensor(sc["poses"][views])
    pool, ids = train_chunks.ray_pool(images, poses, sc["K"])
    scene = prepare_scene(sc["images"], sc["poses"][views], sc["K"],
                          device="cpu")
    params = init_pronerf_params(
        torch.Generator().manual_seed(3), N_samples=8, N_point_ray_enc=48,
        num_neighbor=4, mmnetdepth=6, device="cpu")
    state = init_stage2_state(params)
    step0, seed = 370000, 2**40 + 11
    state["global_step"] = step0
    P = {k: v.detach().clone() for k, v in named_params(params).items()}
    opt = {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in P.items()},
           "nu": {k: torch.zeros_like(v) for k, v in P.items()}}
    gen = torch.Generator().manual_seed(5)
    rows = [torch.randperm(pool.shape[0], generator=gen)[:64]
            for _ in range(3)]
    step = make_stage2_step(cfg, H, W, focal)
    out = {"port": [], "ref": []}

    def keep(side, loss, named, o):
        out[side].append({"loss": loss, "count": o["count"],
                          "params": {k: v.detach().clone()
                                     for k, v in named.items()},
                          "mu": {k: v.clone() for k, v in o["mu"].items()},
                          "nu": {k: v.clone() for k, v in o["nu"].items()}})

    for k, idx in enumerate(rows):
        i = step0 + k + 1
        c = draw_device_controls(seed, i, len(views), 4, 8, 64, 8, "cpu")
        lr = float(np.float32(stage2_lr(i - 1, cfg.lrate, cfg.lrate_decay)))
        state, m = step(state, scene, pool[idx], ids[idx], c, lr)
        keep("port", float(m["loss"]), named_params(params), state["opt"])
        rsc = {"images": images, "poses": poses, "K": sc["K"]}
        (loss,) = rs2.stage2_steps(P, opt, rsc, pool, ids, [idx], seed,
                                   i - 1, train, H, W, focal)
        keep("ref", loss, P, opt)
    return out


@pytest.mark.parametrize("k", [0, 1, 2])
def test_joint_step_equals_the_reference(three_steps, k):
    got, want = three_steps["port"][k], three_steps["ref"][k]
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_REL)
    assert got["count"] == want["count"] == k + 1
    assert set(got["params"]) == set(want["params"])
    prev = {side: three_steps[side][k - 1]["mu"] if k else None
            for side in ("port", "ref")}
    for name, w in want["params"].items():
        # this step's gradient: (mu_k - b1 mu_{k-1}) / (1 - b1)
        g = {side: (three_steps[side][k]["mu"][name] - (
            rtrain.B1 * prev[side][name] if k else 0)) / (1 - rtrain.B1)
            for side in ("port", "ref")}
        assert float(g["ref"].abs().max()) > 0, name
        assert rel(g["port"], g["ref"]) < GRAD_REL, name
        assert rel(got["params"][name], w) < PARAM_REL, name
        assert rel(got["nu"][name], want["nu"][name]) < NU_REL, name


# --------------------------------------------------- followed chunks --

@pytest.fixture(scope="module")
def trainer():
    t = train_joint.JointTrainer(small_cell(), small_config(), "cpu",
                                 2**33 + 7)
    t.window(0.0)
    t.free()
    return t


def test_resumed_state_is_the_checkpoints(trainer):
    """Set-up resumed the JAX soak's stage-2 file at step 370000: the first
    followed chunk's reference starts from what the reference's own reader
    finds there."""
    first = trainer.followed[0]
    assert first["before"] is None and trainer.step0 == 370000
    P, opt, step0 = trainer.checkpoint_start()
    assert step0 == 370000 and opt["count"] == 370000
    assert set(P) == set(first["after"]["params"])


@pytest.mark.parametrize("which", [0, 1], ids=["first", "window"])
def test_followed_chunk_equals_the_reference(trainer, which):
    f = trainer.followed[which]
    got = train_joint.compare(f["after"], trainer.reference_chunk(f),
                              trainer.K)
    assert got["loss_gap"] < 1e-3 and got["grad_gap_median"] < 1e-3 \
        and got["change_gap_median"] < 1e-3, got


def test_the_window_starts_after_a_reshuffle(trainer):
    first, window = trainer.followed
    assert first["start"] == 0 and len(first["keys"]) == 1
    assert len(window["keys"]) == 3 and window["start"] > 0
    assert window["start"] == (trainer.check_at - 2) * trainer.stride
    assert window["before"]["step"] == trainer.step0 + trainer.K * (
        trainer.check_at + 1)
    assert window["before"]["count"] == window["before"]["step"]


@pytest.mark.parametrize("readings, done", [
    ([0.40, 0.40, 0.40], True),
    ([0.47, 0.40, 0.41, 0.40], True),
    ([0.40, 0.40], False),
    ([0.40, 0.47, 0.40], False),
    ([0.40, 0.40, 0.40, 0.43], False),
])
def test_the_launch_cost_settles_within_five_percent_three_times(readings,
                                                                 done):
    """Set-up ends once the last three launch-cost readings are within 5%
    of the floor read before set-up (the raised state reads 18% over)."""
    assert train_joint.settled(readings, 0.40) is done


def test_settle_waits_for_the_floor_and_stops_at_its_cap(monkeypatch):
    monkeypatch.setattr(train_joint, "SETTLE_GAP_S", 0.0)
    readings = iter([0.47] * 4 + [0.40] * 3 + [0.47] * 100)
    calls = []

    def read():
        calls.append(1)
        return next(readings)

    waited, last = train_joint.settle(read, 0.40)
    assert len(calls) == 7 and last == 0.40 and waited < 1.0
    waited, last = train_joint.settle(lambda: 0.47, 0.40, cap_s=0.05)
    assert waited >= 0.05 and last == 0.47


@pytest.mark.parametrize("fault", sorted(train_joint.FAULTS))
def test_reference_faults_read_over_the_limits(trainer, fault):
    """Each fault planted in the reference, in the program's place, reads
    over a limit of the cell in one of the followed chunks."""
    limits = harness.load_json("workloads", CELL)["limits"]
    worst = {}
    for f in trainer.followed:
        want = trainer.reference_chunk(f)
        got = train_joint.compare(control.as_after(
            trainer.reference_chunk(f, fault=fault)), want, trainer.K)
        worst = {k: max(worst.get(k, 0.0), v) for k, v in got.items()}
    assert any(worst[k] > lim for k, lim in limits.items()), worst


# ------------------------------------- faults planted in the program --

def shrink(monkeypatch):
    load = harness.load_json
    smaller = {("configs", "fern_refine"): small_config(),
               ("workloads", CELL): small_cell()}

    def small(kind, name):
        got = smaller.get((kind, name))
        return json.loads(json.dumps(got)) if got else load(kind, name)

    monkeypatch.setattr(harness, "load_json", small)


def plant(monkeypatch, fault):
    """One fault in the port's stage-2 path."""
    from pronerf_tpu_torch.models.pronerf import RenderStatics
    from pronerf_tpu_torch.train import fast_loop

    statics = {"no_offsets": {"add_offsets": False},
               "no_jitter": {"jitter": False}, "no_mm": {"use_mm": False}}
    if fault in statics:
        real = RenderStatics.stage2

        def stage2(*a, **kw):
            return dataclasses.replace(real(*a, **kw), **statics[fault])

        monkeypatch.setattr(RenderStatics, "stage2", staticmethod(stage2))
    elif fault == "row_zero":  # every chunk reads the pool from its row 0
        real = fast_loop.make_scan_executor
        monkeypatch.setattr(fast_loop, "make_scan_executor",
                            lambda *a, **kw: _Forward(real(*a, **kw)))
    else:
        real = fast_loop.make_stage2_step

        def make(*a, **kw):
            step = real(*a, **kw)

            def broken(state, scene, batch, ids, controls, lr):
                if fault == "half_batch":
                    n = batch.shape[0] // 2
                    controls = dict(controls)
                    for key in ("raw_noise", "jitter_noise"):
                        controls[key] = controls[key][:n]
                    return step(state, scene, batch[:n], ids[:n], controls,
                                lr)
                # the update undone: of everything, or of the sampler and
                # refine nets (a stage-1 NeRF step's treatment)
                kept = _sampler_and_refine(state) if fault == "frozen" \
                    else fast_loop.state_tensors(state, ("opt",))
                saved = [t.detach().clone() for t in kept]
                out = step(state, scene, batch, ids, controls, lr)
                with torch.no_grad():
                    for t, v in zip(kept, saved):
                        t.copy_(v)
                return out

            return broken

        monkeypatch.setattr(fast_loop, "make_stage2_step", make)


def _sampler_and_refine(state):
    from pronerf_tpu_torch.train.state import named_params

    named = named_params(state["params"])
    names = [n for n in named if not n.startswith("nerf.")]
    return [named[n] for n in names] + [
        state["opt"][m][n] for m in ("mu", "nu") for n in names]


class _Forward:
    """An executor whose calls read the pool from row 0; its other
    attributes are the real one's."""

    def __init__(self, executor):
        self._executor = executor

    def __call__(self, state, scene, pool, ids, i_batch, seed, **kw):
        return self._executor(state, scene, pool, ids, 0, seed, **kw)

    def __getattr__(self, name):
        return getattr(self._executor, name)


@pytest.mark.parametrize("fault", [None, "no_offsets", "no_jitter", "no_mm",
                                   "frozen", "half_batch", "unchanged",
                                   "row_zero"])
def test_planted_fault_is_not_correct(monkeypatch, fault):
    """The whole run on the CPU at a small size: correct without a fault,
    not correct with one planted in the program."""
    shrink(monkeypatch)
    if fault:
        plant(monkeypatch, fault)
    outcome, _, _ = run.run_cell(CELL, 2**35 + 3, 0.3, False, "cpu",
                                 harness.load_json("workloads", CELL))
    assert outcome.correct is (fault is None), harness.checks_line(
        outcome.checks)


# ------------------------------------------------------ the trace's readers --

def chrome_trace():
    """Two chunks of 8 joint steps, 40 ms each: in each chunk a 1 ms fill
    (one kernel of 0.5 ms launched inside it), then 8 graph replays of
    two 1.5 ms kernels each (their correlation the replay's
    ``cudaGraphLaunch``), and one kernel launched outside the port's
    spans."""
    ev, c = [], 0

    def x(cat, name, ts, dur, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur, "args": args})

    for chunk in range(2):
        t = chunk * 40_000.0
        x("user_annotation", "bench/chunk", t, 40_000.0)
        x("user_annotation", "pn/chunk", t + 10, 39_000.0)
        x("user_annotation", "pn/fill", t + 20, 1_000.0)
        c += 1
        x("cuda_runtime", "cudaLaunchKernel", t + 30, 5.0, correlation=c)
        x("kernel", "fill_kernel", t + 40, 500.0, correlation=c)
        for s in range(8):
            ts = t + 2_000.0 + 4_000.0 * s
            x("user_annotation", "pn/step.joint", ts, 50.0)
            c += 1
            x("cuda_runtime", "cudaGraphLaunch", ts + 10, 20.0,
              correlation=c)
            for j in range(2):
                x("kernel", f"sgemm_{j}", ts + 100 + 1_500.0 * j, 1_500.0,
                  correlation=c)
        c += 1
        x("cuda_runtime", "cudaLaunchKernel", t + 39_500, 5.0,
          correlation=c)
        x("kernel", "loss_read_kernel", t + 39_510, 100.0, correlation=c)
        x("gpu_memcpy", "Memcpy DtoH", t + 39_700, 50.0, correlation=c)
    return {"traceEvents": ev}


@pytest.fixture
def traced(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(chrome_trace()))
    return program_trace.read(path, "chunk", 16)


def test_kernels_belong_to_the_span_of_their_launch(traced):
    assert traced.window_s == pytest.approx(0.08) and traced.units == 16
    assert traced.span_kernel_us("step.joint") == pytest.approx(48_000.0)
    assert traced.span_kernel_us("fill") == pytest.approx(1_000.0)
    # the loss read's kernel, launched after pn/chunk closed, has no span
    assert traced.span_kernel_us("chunk") == 0
    assert [k[0] for k, o in zip(traced.kernels, traced.owner)
            if o is None] == ["loss_read_kernel"] * 2
    assert traced.program_us("fill") == pytest.approx(2_000.0)
    # idle gaps by the innermost span open at each gap's start, the port's
    # named with pn/: a chunk's gaps are 40 + 90 + 250 us in bench/chunk
    # alone, 1,560 after the fill's kernel, 7 x 1,000 between the replays
    # and 6,410 before the loss read
    assert dict(traced.idle_by_span(20)) == pytest.approx(
        {"chunk": 760e-6, "pn/fill": 3_120e-6, "pn/chunk": 26_820e-6})
    assert traced.device_busy_s() == pytest.approx(0.0493)


def test_joint_readers_on_a_known_trace(traced):
    config = harness.load_json("configs", "fern_refine")
    outcome = types.SimpleNamespace(trace=traced, run=types.SimpleNamespace(
        config=config, K=8))

    def read(name):
        return harness.load_module("metrics", name).read(outcome)

    assert read("joint_step_ms") == pytest.approx(3.0)
    assert read("joint_fill_ms") == pytest.approx(1.0 / 8)
    # hand count: 6 x (593,408 x 8 + 781,824) x 4096 operations a step
    assert work_joint.joint_step_flops(4096) == 135_882_866_688
    assert read("joint_mfu") == pytest.approx(
        100 * 135_882_866_688 / 0.005 / 67e12)
    busy = 2 * (0.5 + 8 * 3.0 + 0.1 + 0.05)
    assert read("device_idle.joint") == pytest.approx(100 * (1 - busy / 80))
    # a program without the spans (kernels owned by none) gives neither
    outcome.trace = dataclasses.replace(
        traced, program=[], owner=[None] * len(traced.kernels))
    assert read("joint_step_ms") is None and read("joint_fill_ms") is None
    assert read("joint_mfu") is not None
