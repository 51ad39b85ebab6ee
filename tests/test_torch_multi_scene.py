"""Several scenes in one training run (``pronerf_tpu_torch/parallel/
multi_scene.py``, ``train/multi_loop.py``, the ``train-multi`` verb) against
the JAX package on the CPU.

The JAX side is kept small: at most 2 scenes, on a mesh of at most 2
devices, never its 8-scene program (its XLA runtime has aborted in that
program under parallel test workers).

- the port's multi-scene step (one process, scenes in sequence) against
  ``make_multi_scene_step`` on ``make_scene_mesh(2, 1)``, both stages, the
  params carried across by ``convert`` and JAX's per-scene noise
  (``fold_in(rng, scene)``, split as ``render_rays`` splits it) injected;
- the pooled step against the batch step on the same slice;
- the reshuffle: a permutation a scene, another for each scene, and a
  scene's permutation independent of the layout;
- the layout arithmetic against JAX's ``_make_mesh`` over a grid of
  (scenes, shards, devices), with its note and its ``ValueError``;
- ``train-multi`` over two gloo ranks through the command line (``--nproc
  2 --ray-shards 2``, the arguments of JAX's smoke test): both scenes'
  checkpoints, the layout note, the weights within the data-parallel bound
  of a world of one (``--nproc 1``); layouts that cannot run raise before
  any rank starts;
- ``train-multi`` through both command lines at 2 scenes: the same pools,
  host draws, learning rates and batches step for step, per-scene
  checkpoints; the port's stage 2 bootstrapped from the JAX stage-1 multi
  expdir; an exact resume (across a reshuffle), the partial-set warning,
  the non-finite-loss raise, mismatched scenes.

Tolerances. The step against JAX, per scene: the one-step bounds of
``tests/test_torch_train_steps.py`` (loss ``1e-6`` relative; Adam's
moments within ``torch_train_common``'s gradient bounds, doubled for nu;
params within 2 lr everywhere and ``1e-3`` lr on 99% of elements; the
reasons stand there). The pooled step against the batch step: the JAX
test's ``atol 1e-6`` on the losses (``tests/test_parallel.py:309``), and
equal params. A resumed run against the uninterrupted one: bit for bit.
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pronerf_tpu import cli as j_cli
from pronerf_tpu.parallel import multi_scene as j_ms
from pronerf_tpu.train import multi_loop as j_loop
from pronerf_tpu.train.stage1 import init_stage1_state as j_init1
from pronerf_tpu.train.stage2 import init_stage2_state as j_init2
from pronerf_tpu_torch import cli, convert
from pronerf_tpu_torch.parallel import multi_scene as t_ms
from pronerf_tpu_torch.train import checkpoint as t_ckpt
from pronerf_tpu_torch.train import multi_loop as t_loop
from pronerf_tpu_torch.train.stage1 import init_stage1_state
from pronerf_tpu_torch.train.stage2 import init_stage2_state
from pronerf_tpu_torch.train.state import named_params
from torch_train_common import (
    N_RAYS,
    Setup,
    T,
    as_numpy,
    assert_trees_close,
    configs,
    named_numpy,
)

import jax_native_once

torch.set_num_threads(2)
jax_native_once.load()  # the JAX pool on its library, as the port's

LR = 5e-4
KEY = 7
SUBSET = (0, 2, 3, 4)
# (stage, branch, optimizer, noise width)
KINDS = {"stage1_nerf": (1, "nerf", "opt_nerf", 64),
         "stage1_sampler": (1, "sampler", "opt_s", 64),
         "stage2": (2, None, "opt", 8)}
SMALL = ["--netdepth", "3", "--netwidth", "64", "--mmnetdepth", "2",
         "--mmnetwidth", "32"]


def adam_of(opt_state):
    """optax's ScaleByAdamState (alone, or last in a chain)."""
    return opt_state[-1] if type(opt_state) is tuple else opt_state


def named_moments(tree, opt):
    """A JAX moment tree in the port's names (the NeRF's alone for
    ``opt_nerf``)."""
    if opt == "opt_nerf":
        m = convert.radiance_from_numpy(as_numpy(tree))
        return {f"nerf.{k}": v.detach().numpy()
                for k, v in m.named_parameters()}
    return named_numpy(tree)


def jax_scene_noise(s, width):
    """JAX's noise of scene ``s``: the step's key folded with the scene's
    index, then split as ``render_rays`` splits it."""
    k = jax.random.fold_in(jax.random.PRNGKey(KEY), s)
    nk, jk = jax.random.split(k)
    return {"raw_noise": T(jax.random.normal(nk, (N_RAYS, width))),
            "jitter_noise": T(jax.random.normal(jk, (N_RAYS, width)))}


@pytest.mark.parametrize("kind", list(KINDS))
def test_multi_scene_step_matches_jax(kind):
    stage, branch, opt, width = KINDS[kind]
    sus = [Setup("u8", s) for s in (0, 1)]
    jcfg, tcfg = configs()
    H, W, focal = sus[0].H, sus[0].W, sus[0].focal
    # JAX: the stacked scenes on a (2, 1) mesh, its own per-scene draws
    j_init = j_init1 if stage == 1 else j_init2
    jstates = j_ms.stack_scenes([j_init(su.jparams_copy()) for su in sus])
    jscenes = j_ms.stack_scenes([su.jscene for su in sus])
    mesh = j_ms.make_scene_mesh(2, 1)
    batch, ids = j_ms.place_scene_batch(
        mesh, jnp.asarray(np.stack([su.batch for su in sus])),
        jnp.asarray(np.stack([su.ids for su in sus])))
    jc = {"rng": jax.random.PRNGKey(KEY), "n_mult": jnp.int32(3),
          "dir_expand": jnp.asarray(True), "dir_jitter": jnp.asarray(True),
          "neighbor_subset": jnp.asarray(SUBSET, jnp.int32),
          "target_t": jnp.zeros((3,), jnp.float32)}
    jstep = j_ms.make_multi_scene_step(jcfg, H, W, focal, mesh, stage,
                                       branch or "nerf")
    jstates, jm = jstep(jstates, jscenes, batch, ids, jc, LR)
    # the port: one process, the scenes in sequence, JAX's noise injected
    init = init_stage1_state if stage == 1 else init_stage2_state
    states = [init(su.tparams()) for su in sus]
    tc = {"rng": None, "n_mult": 3, "dir_expand": True, "dir_jitter": True,
          "neighbor_subset": torch.tensor(SUBSET),
          "target_t": torch.zeros(3)}
    step = t_ms.make_multi_scene_step(tcfg, H, W, focal,
                                      t_ms.make_scene_mesh(1, 1), stage,
                                      branch or "nerf")
    states, tm = step(states, [su.tscene for su in sus],
                      torch.from_numpy(np.stack([su.batch for su in sus])),
                      torch.from_numpy(np.stack([su.ids for su in sus])),
                      tc, LR, noise=[jax_scene_noise(s, width)
                                     for s in (0, 1)])
    jl = np.asarray(jm["loss"])
    assert jl.shape == tuple(tm["loss"].shape) == (2,)
    np.testing.assert_allclose(tm["loss"].numpy(), jl, rtol=1e-6)
    np.testing.assert_allclose(tm["psnr"].numpy(), np.asarray(jm["psnr"]),
                               atol=1e-4)
    assert jl[0] != jl[1]  # scenes differ
    for s in (0, 1):
        js = jax.tree_util.tree_map(lambda a: a[s], jstates)
        ja = adam_of(js[opt])
        assert states[s][opt]["count"] == int(ja.count) == 1
        assert states[s]["global_step"] == int(js["global_step"]) == 1
        assert_trees_close(states[s][opt]["mu"], named_moments(ja.mu, opt),
                           f"{kind} scene {s} mu")
        assert_trees_close(states[s][opt]["nu"], named_moments(ja.nu, opt),
                           f"{kind} scene {s} nu", power=2)
        jp = named_numpy(js["params"])
        d = np.concatenate([np.abs(v.detach().numpy() - jp[k]).ravel()
                            for k, v in named_params(states[s]["params"])
                            .items()])
        assert d.max() <= 2 * LR and (d <= 1e-3 * LR).mean() >= 0.99


def test_pooled_step_equals_batch_step():
    sus = [Setup("u8", s) for s in (0, 1)]
    _, tcfg = configs()
    H, W, focal = sus[0].H, sus[0].W, sus[0].focal
    pools, ids = [], []
    for su in sus:
        from pronerf_tpu_torch.render.raygen import build_ray_pool

        p, i = build_ray_pool(su.sc["images"], su.sc["poses"], su.sc["K"],
                              list(range(6)), 4, np.random.default_rng(0))
        pools.append(p[:3 * N_RAYS])
        ids.append(i[:3 * N_RAYS])
    pools, ids = torch.from_numpy(np.stack(pools)), torch.from_numpy(
        np.stack(ids))
    mesh = t_ms.make_scene_mesh(1, 1)
    tc = {"rng": None, "n_mult": 2, "dir_expand": False, "dir_jitter": True,
          "neighbor_subset": torch.tensor(SUBSET), "target_t": torch.zeros(3)}
    noise = [jax_scene_noise(s, 64) for s in (0, 1)]
    out = {}
    for name in ("batch", "pooled"):
        states = [init_stage1_state(su.tparams()) for su in sus]
        if name == "batch":
            step = t_ms.make_multi_scene_step(tcfg, H, W, focal, mesh)
            _, m = step(states, [su.tscene for su in sus],
                        pools[:, N_RAYS:2 * N_RAYS],
                        ids[:, N_RAYS:2 * N_RAYS], tc, LR, noise=noise)
        else:
            step = t_ms.make_multi_scene_pooled_step(tcfg, H, W, focal, mesh)
            _, m = step(states, [su.tscene for su in sus], pools, ids,
                        N_RAYS, tc, LR, noise=noise)
        out[name] = (m["loss"].numpy(), states)
    np.testing.assert_allclose(out["pooled"][0], out["batch"][0], atol=1e-6,
                               rtol=0)
    for a, b in zip(out["pooled"][1], out["batch"][1]):
        for (k, v), w in zip(named_params(a["params"]).items(),
                             named_params(b["params"]).values()):
            assert torch.equal(v, w), k


def test_reshuffle_gives_each_scene_its_own_permutation():
    m = 500
    pools = torch.arange(2 * m * 9, dtype=torch.float32).reshape(2, m, 3, 3)
    ids = torch.arange(m).repeat(2, 1)
    before = pools.clone()
    t_ms.reshuffle_scene_pools(pools, ids, 5)
    for s in (0, 1):
        # a permutation of the scene's rows, ids moved with them
        assert torch.equal(torch.sort(ids[s]).values, torch.arange(m))
        assert torch.equal(pools[s], before[s][ids[s]])
    assert not torch.equal(ids[0], ids[1])
    # a scene's permutation depends on its index, not on the layout
    alone_p, alone_i = before[1:].clone(), torch.arange(m)[None].clone()
    t_ms.reshuffle_scene_pools(alone_p, alone_i, 5, first_scene=1)
    assert torch.equal(alone_i[0], ids[1])
    again = torch.arange(m).repeat(2, 1)
    t_ms.reshuffle_scene_pools(before.clone(), again, 6)
    assert not torch.equal(again, ids)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("scenes", [1, 2, 3, 8])
def test_layout_matches_jax(scenes, shards, n_dev, capsys):
    try:
        jmesh = j_loop._make_mesh(scenes, shards, n_dev)
        want = tuple(jmesh.devices.shape)
    except ValueError as e:
        want = e
    jout = capsys.readouterr().out
    if isinstance(want, ValueError):
        with pytest.raises(ValueError, match="ray_shards"):
            t_loop.mesh_layout(scenes, shards, n_dev)
        assert str(want).startswith(f"ray_shards={shards} exceeds")
        return
    shape, note = t_loop.mesh_layout(scenes, shards, n_dev)
    assert shape == want
    assert (note + "\n" if note else "") == jout


# ------------------------------------------------------- the loops ------

def _common(basedir, expname, n_rand=64):
    return ["--", "--basedir", str(basedir), "--expname", expname,
            "--N_rand", str(n_rand), "--i_print", "1", "--i_weights", "2",
            "--i_testset", "0"] + SMALL


SCENES = ["--scenes", "synthetic:24x18x6,synthetic:24x18x6"]


def _spy_steps(monkeypatch, module, record, n_rand):
    """Record every multi-scene step's batch slices, ids, host draws and
    learning rate."""
    make = module.make_multi_scene_pooled_step

    def make_spied(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(states, scenes, pools, pool_ids, i_batch, controls, lr):
            i = int(i_batch)
            record.append({
                "batch": np.asarray(pools)[:, i:i + n_rand],
                "ids": np.asarray(pool_ids)[:, i:i + n_rand],
                "lr": float(lr),
                **{k: np.asarray(controls[k]) for k in (
                    "n_mult", "dir_expand", "dir_jitter",
                    "neighbor_subset")}})
            return step(states, scenes, pools, pool_ids, i_batch, controls,
                        lr)
        return run

    monkeypatch.setattr(module, "make_multi_scene_pooled_step", make_spied)


def _spy_pools(monkeypatch, module, record):
    fn = module.build_ray_pool

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        record.append(out)
        return out

    monkeypatch.setattr(module, "build_ray_pool", wrapped)


@pytest.fixture(scope="module")
def jax_stage1(tmp_path_factory):
    """``train-multi`` of the JAX package at 2 scenes, 3 steps, spied."""
    root = tmp_path_factory.mktemp("multi_jax")
    seen = {"pools": [], "steps": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRONERF_XLA_CACHE", "off")
        _spy_pools(mp, j_loop, seen["pools"])
        _spy_steps(mp, j_loop, seen["steps"], 64)
        j_cli.main(["train-multi", "--no-reload", "--max-steps", "3"]
                   + SCENES + _common(root, "jax_s1"))
    return root / "jax_s1", seen


def test_both_command_lines_train_on_the_same_pools_draws_and_batches(
        jax_stage1, tmp_path, monkeypatch, capsys):
    jexp, jseen = jax_stage1
    seen = {"pools": [], "steps": []}
    _spy_pools(monkeypatch, t_loop, seen["pools"])
    _spy_steps(monkeypatch, t_loop, seen["steps"], 64)
    states, names, expdir = cli.main(
        ["train-multi", "--no-reload", "--max-steps", "3", "--device", "cpu"]
        + SCENES + _common(tmp_path, "port_s1"))
    out = capsys.readouterr().out
    assert "[TRAIN-MULTI] Iter: 3" in out and "synthetic1:" in out
    assert names == ["synthetic0", "synthetic1"]
    assert len(seen["pools"]) == len(jseen["pools"]) == 2
    for (tp, tids), (jp, jids) in zip(seen["pools"], jseen["pools"]):
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tids, jids)
    assert len(seen["steps"]) == len(jseen["steps"]) == 3
    for i, (t, j) in enumerate(zip(seen["steps"], jseen["steps"])):
        assert t.keys() == j.keys()
        for k in t:
            if k == "lr":
                assert t[k] == pytest.approx(j[k], rel=1e-7), i
            else:
                np.testing.assert_array_equal(t[k], j[k], err_msg=f"{i} {k}")
    for name in names:
        for exp in (expdir, jexp):
            ckpts = sorted((exp / f"scene_{name}").glob("*.ckpt"))
            assert [c.name for c in ckpts] == ["000002.ckpt", "000003.ckpt"]
    assert [s["global_step"] for s in states] == [3, 3]


def test_port_stage2_bootstraps_from_the_jax_multi_expdir(jax_stage1,
                                                          tmp_path, capsys):
    jexp, _ = jax_stage1
    states, names, expdir = cli.main(
        ["train-multi", "--stage", "2", "--no-reload", "--max-steps", "2",
         "--pretrain-path", str(jexp), "--device", "cpu"]
        + SCENES + _common(tmp_path, "port_s2"))
    out = capsys.readouterr().out
    assert out.count("stage-2 bootstrap from") == 2
    assert "Multi-scene stage-2" in out
    # the bootstrap carried JAX's stage-1 weights of each scene
    for s, name in enumerate(names):
        ck = t_ckpt.latest_checkpoint(jexp / f"scene_{name}")
        jnerf = t_ckpt.load_checkpoint(ck)["network_fn"]
        got = t_ckpt.load_checkpoint(
            t_ckpt.latest_checkpoint(expdir / f"scene_{name}"))
        assert "network_fine" in got and got["global_step"] == 2
        moved = max(float((got["network_fine"][k] - v).abs().max())
                    for k, v in jnerf.items())
        assert 0 < moved <= 2 * 2 * 5e-4  # two Adam steps of lr <= 5e-4


def _run(basedir, expname, steps, extra=(), no_reload=False, n_rand=1080):
    argv = ["train-multi", "--max-steps", str(steps), "--device", "cpu"]
    if no_reload:
        argv.append("--no-reload")
    return cli.main(argv + SCENES + _common(basedir, expname, n_rand)
                    + list(extra))


def test_resume_continues_the_uninterrupted_run_exactly(tmp_path, capsys):
    # 1080 rays a batch from a pool of 2,160 (5 train views of 24x18):
    # reshuffles at steps 3 and 5; the resumed run replays the first
    _run(tmp_path, "straight", 5, no_reload=True)
    _run(tmp_path, "resumed", 3, no_reload=True)
    capsys.readouterr()
    _run(tmp_path, "resumed", 2, extra=["--i_testset", "5",
                                        "--max_images", "1"])
    out = capsys.readouterr().out
    assert "resumed 2 scenes at step 3 (per-scene steps [3, 3])" in out
    assert "[TRAIN-MULTI] Iter 5 per-scene test PSNR: synthetic0:" in out
    for name in ("synthetic0", "synthetic1"):
        a, b = (t_ckpt.load_checkpoint(tmp_path / e / f"scene_{name}" /
                                       "000005.ckpt")
                for e in ("straight", "resumed"))
        for key in ("network_fn", "mmr_network_fn", "refine_net"):
            for p, v in a[key].items():
                assert torch.equal(b[key][p], v), (name, key, p)
        for key in ("optimizer", "s_optimizer"):
            assert a[key]["count"] == b[key]["count"]
            for part in ("mu", "nu"):
                for p, v in a[key][part].items():
                    assert torch.equal(b[key][part][p], v), (name, key, p)


def test_partial_set_warns_and_starts_fresh(tmp_path, capsys):
    _run(tmp_path, "partial", 2, no_reload=True, n_rand=64)
    for ck in (tmp_path / "partial" / "scene_synthetic1").glob("*.ckpt"):
        ck.unlink()
    capsys.readouterr()
    states, _, _ = _run(tmp_path, "partial", 1, n_rand=64)
    out = capsys.readouterr().out
    assert "WARNING: partial per-scene checkpoints found" in out
    assert [s["global_step"] for s in states] == [1, 1]


def test_non_finite_loss_raises_with_the_per_scene_losses(tmp_path):
    _run(tmp_path, "nan", 2, no_reload=True, n_rand=64)
    ck_file = t_ckpt.latest_checkpoint(tmp_path / "nan" / "scene_synthetic1")
    ck = t_ckpt.load_checkpoint(ck_file)
    w0 = next(k for k in ck["network_fn"] if k.endswith("weight"))
    ck["network_fn"][w0] = torch.full_like(ck["network_fn"][w0],
                                           float("nan"))
    t_ckpt.save_checkpoint(ck_file, ck)
    with pytest.raises(FloatingPointError, match="Non-finite loss at iter 3"):
        _run(tmp_path, "nan", 1, n_rand=64)


def test_scenes_of_other_resolutions_raise(tmp_path):
    with pytest.raises(ValueError, match="share resolution"):
        cli.main(["train-multi", "--max-steps", "1", "--device", "cpu",
                  "--scenes", "synthetic:24x18x6,synthetic:20x18x6"]
                 + _common(tmp_path, "bad"))
    with pytest.raises(ValueError, match="train view count"):
        cli.main(["train-multi", "--max-steps", "1", "--device", "cpu",
                  "--scenes", "synthetic:24x18x6,synthetic:24x18x12"]
                 + _common(tmp_path, "bad"))


# ------------------------------------- ranks from the command line ------

# JAX's tests/test_train_smoke.py::test_train_multi_smoke, on the small nets
SMOKE = ["train-multi", "--no-reload", "--max-steps", "4", "--n-synthetic",
         "2", "--device", "cpu"]
# a world of two against a world of one: tests/test_torch_parallel.py's
# data-parallel bound on the weights (the JAX package's own bound for its
# sharded step, tests/test_parallel.py:75-79)
PARAM_ATOL = 2e-6


def _smoke_tail(basedir, expname):
    return ["--", "--basedir", str(basedir), "--expname", expname,
            "--N_rand", "64", "--i_print", "2", "--i_weights", "4",
            "--i_testset", "0"] + SMALL


@contextlib.contextmanager
def _fd_stdout(path):
    """File descriptor 1 sent to ``path``: what spawned ranks print."""
    sys.stdout.flush()
    saved = os.dup(1)
    try:
        with open(path, "w") as fh:
            os.dup2(fh.fileno(), 1)
            yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


@pytest.fixture(scope="module")
def cli_ranks(tmp_path_factory):
    """``train-multi`` of JAX's smoke test over two gloo ranks (``--nproc 2
    --ray-shards 2``) and in a world of one (``--nproc 1 --ray-shards
    1``): ``(root, return values, what the parent and the ranks
    printed)``."""
    root = tmp_path_factory.mktemp("cli_ranks")
    parent = io.StringIO()
    with _fd_stdout(root / "ranks.log"), contextlib.redirect_stdout(parent):
        two = cli.main(SMOKE + ["--ray-shards", "2", "--nproc", "2"]
                       + _smoke_tail(root, "two"))
    one = cli.main(SMOKE + ["--ray-shards", "1", "--nproc", "1"]
                   + _smoke_tail(root, "one"))
    return root, {"two": two, "one": one}, {
        "parent": parent.getvalue(),
        "ranks": (root / "ranks.log").read_text()}


def test_train_multi_over_two_ranks_writes_every_scene(cli_ranks):
    root, runs, out = cli_ranks
    states, names, expdir = runs["two"]
    assert states is None and names == ["synthetic0", "synthetic1"]
    assert expdir == root / "two"
    assert "[TRAIN-MULTI] 2 ranks over gloo" in out["parent"]
    # rank 0 prints, and the layout note is layout(2, 2, 2)'s, once
    _, note = t_loop.mesh_layout(2, 2, 2)
    assert out["ranks"].count(note) == 1
    assert "Multi-scene stage-1: 2 scenes on mesh {'scene': 1, 'rays': 2}" \
        in out["ranks"]
    assert out["ranks"].count("[TRAIN-MULTI] Iter: 4") == 1
    for name in names:
        assert sorted(p.name for p in (expdir / f"scene_{name}").glob(
            "*.ckpt")) == ["000004.ckpt"], name


def test_train_multi_over_two_ranks_equals_a_world_of_one(cli_ranks):
    root, runs, _ = cli_ranks
    states, names, expdir = runs["one"]
    assert [s["global_step"] for s in states] == [4, 4]
    assert not torch.distributed.is_initialized()  # the world was closed
    for name in names:
        a, b = (t_ckpt.load_checkpoint(t_ckpt.latest_checkpoint(
            root / e / f"scene_{name}")) for e in ("one", "two"))
        assert a["global_step"] == b["global_step"] == 4
        for key in ("network_fn", "mmr_network_fn", "refine_net"):
            assert a[key].keys() == b[key].keys()
            for p, v in a[key].items():
                np.testing.assert_allclose(b[key][p].numpy(), v.numpy(),
                                           atol=PARAM_ATOL, rtol=0,
                                           err_msg=f"{name} {key} {p}")
    # each scene trained its own nets
    a, b = (t_ckpt.load_checkpoint(root / "one" / f"scene_{name}" /
                                   "000004.ckpt")["network_fn"]
            for name in names)
    assert any(not torch.equal(a[k], b[k]) for k in a)


def test_train_multi_layouts_that_cannot_run_raise_before_any_rank(
        tmp_path, monkeypatch):
    def no_spawn(*args, **kwargs):
        raise AssertionError("a rank was spawned")

    monkeypatch.setattr(t_loop, "spawn_local", no_spawn)
    with pytest.raises(ValueError, match="ray_shards=4 exceeds the 2"):
        cli.main(SMOKE + ["--ray-shards", "4", "--nproc", "2"]
                 + _smoke_tail(tmp_path, "bad"))
    with pytest.raises(ValueError, match="at least one rank"):
        cli.main(SMOKE + ["--nproc", "0"] + _smoke_tail(tmp_path, "bad"))
    # on the card the default is every visible card, and no more may be
    # asked for
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert t_loop.local_ranks("cuda") == 1 and t_loop.local_ranks("cpu") == 1
    with pytest.raises(ValueError, match="nproc=2 exceeds the 1 visible"):
        cli.main(["train-multi", "--nproc", "2", "--device", "cuda"]
                 + _smoke_tail(tmp_path, "bad"))
    assert not (tmp_path / "bad").exists()
