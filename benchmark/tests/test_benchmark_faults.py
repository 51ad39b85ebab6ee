"""A run with the timed path broken underneath comes out not correct.

Each test drives ``run.run_cell`` (the harness's look for a card skipped)
on the CPU at a small size, with one fault planted in the program: for the
viewer, a frame's answer altered where it is produced (a colour offset, or
the frame of another pose); for training, a chunk that leaves the state
unchanged, and steps that leave out half of each batch and take the mean
over the rest, a chunk that reads the pool from row 0 whatever its
offset, and a reshuffle that leaves the pool as it was. The same run
without a fault comes out correct."""

import pytest
import torch

import harness
import run


def small_viewer():
    cell = harness.load_json("workloads", "fern_trt.view_1008")
    cell["params"].update(height=36, width=48, check_frames=2,
                          warmup_frames=1, reference_block=1024)
    return cell


def break_renderer(monkeypatch, fault):
    from pronerf_tpu_torch.render import renderer

    real = renderer.make_frame_renderer

    def make(*a, **kw):
        render = real(*a, **kw)

        def broken(params, scene, c2w):
            if fault == "other_pose":
                c2w = c2w.copy()
                c2w[:, 3] += 0.05
            out = dict(render(params, scene, c2w))
            if fault == "offset":
                out["rgb1"] = out["rgb1"] + 0.02
            return out

        return broken

    monkeypatch.setattr(renderer, "make_frame_renderer", make)


@pytest.mark.parametrize("fault", [None, "offset", "other_pose"])
def test_viewer(monkeypatch, fault):
    if fault:
        break_renderer(monkeypatch, fault)
    outcome, _, _ = run.run_cell("fern_trt.view_1008", 2**35 + 1, 0.3,
                                 False, "cpu", small_viewer())
    assert outcome.correct is (fault is None), harness.checks_line(
        outcome.checks)


def small_training(monkeypatch):
    load = harness.load_json

    def small(kind, name):
        out = load(kind, name)
        if kind == "configs" and name == "fern_epi":
            out["train"]["N_rand"] = 64
            out["scene"].update(height=36, width=48)
        if kind == "workloads" and name == "fern_epi.train_s1":
            out["params"].update(reshuffle_after=2, check_within=2)
        return out

    monkeypatch.setattr(harness, "load_json", small)


def break_steps(monkeypatch, fault):
    from pronerf_tpu_torch.train import fast_loop

    real = fast_loop.make_stage1_steps

    def make(*a, **kw):
        def broken(step):
            def run_step(state, scene, batch, ids, controls, lr):
                if fault == "unchanged":  # the step's update undone
                    ts = fast_loop.state_tensors(state, ("opt_nerf",
                                                         "opt_s"))
                    saved = [t.detach().clone() for t in ts]
                    out = step(state, scene, batch, ids, controls, lr)
                    with torch.no_grad():
                        for t, v in zip(ts, saved):
                            t.copy_(v)
                    return out
                n = batch.shape[0] // 2  # half of the batch left out
                ctl = dict(controls)
                for key in ("raw_noise", "jitter_noise"):
                    ctl[key] = ctl[key][:n]
                return step(state, scene, batch[:n], ids[:n], ctl, lr)
            return run_step
        return tuple(broken(s) for s in real(*a, **kw))

    monkeypatch.setattr(fast_loop, "make_stage1_steps", make)


def break_rows(monkeypatch, fault):
    from pronerf_tpu_torch.train import fast_loop

    if fault == "row_zero":  # every chunk reads the pool from its row 0
        real = fast_loop.make_scan_executor

        def make(*a, **kw):
            executor = real(*a, **kw)

            def broken(state, scene, pool, ids, i_batch, seed, **k):
                return executor(state, scene, pool, ids, 0, seed, **k)

            return _Forward(executor, broken)

        monkeypatch.setattr(fast_loop, "make_scan_executor", make)
    else:  # the window's reshuffle leaves the pool as it was
        real = fast_loop.device_reshuffle
        calls = []

        def reshuffle(pool, ids, seed):
            calls.append(seed)
            if len(calls) <= 2:
                return real(pool, ids, seed)
            return pool, ids

        monkeypatch.setattr(fast_loop, "device_reshuffle", reshuffle)


class _Forward:
    """An executor whose calls go through ``call``; its other attributes
    are the real one's."""

    def __init__(self, executor, call):
        self._executor, self._call = executor, call

    def __call__(self, *a, **kw):
        return self._call(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._executor, name)


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch",
                                   "row_zero", "stale_pool"])
def test_training(monkeypatch, fault):
    small_training(monkeypatch)
    if fault in ("unchanged", "half_batch"):
        break_steps(monkeypatch, fault)
    elif fault:
        break_rows(monkeypatch, fault)
    cell = harness.load_json("workloads", "fern_epi.train_s1")
    outcome, _, _ = run.run_cell("fern_epi.train_s1", 2**35 + 2, 0.3, False,
                                 "cpu", cell)
    assert outcome.correct is (fault is None), harness.checks_line(
        outcome.checks)
