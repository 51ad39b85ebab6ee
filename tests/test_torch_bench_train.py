"""The port's training bench (``pronerf_tpu_torch/bench_train.py``) against
the JAX package's root ``bench_train.py`` on the CPU.

- its setup equals the JAX file's bit for bit: the configs, the scene's
  arrays (its f32 matrices within one unit in the last place, as in
  ``tests/test_torch_bench.py``), the ray pool and the batch, the controls,
  the learning rate and the nets' shapes. The JAX side is read from the JAX
  file's own ``main``, run with its step builders swapped for recorders;
- the chain of K = 2 steps of each kind (each on the last one's state)
  equals JAX's chained ``lax.scan`` of the same steps at small widths (6
  views of 18x24, 64 rays, ``torch_train_common``'s nets), from the same
  params, batch and controls, the noise JAX draws from the controls' key
  handed to the port. Bounds: the first loss within 1e-6
  relative (``tests/test_torch_train_steps.py``'s bound for one step); the
  second within ``CHUNK_LOSS_REL`` = 1e-4 and the params within
  ``PARAM_DRIFT_LR`` = 0.25 lr on 99% of the elements and 2 lr a step
  everywhere (``tests/test_torch_fast_loop.py``'s bounds for a chain of
  steps, which drift apart by the sign flips they state);
- the JSON line holds JAX's keys.
"""

import dataclasses
import importlib.util
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pronerf_tpu.models import init_pronerf_params as j_init
from pronerf_tpu.render import prepare_scene as j_prepare_scene
from pronerf_tpu.render.raygen import build_ray_pool as j_build_ray_pool
from pronerf_tpu.train import stage1 as j_stage1
from pronerf_tpu.train import stage2 as j_stage2
from pronerf_tpu.utils.synthetic import make_scene as j_make_scene
from pronerf_tpu_torch import bench_train, convert
from pronerf_tpu_torch.train.state import named_params
from torch_train_common import NETS, as_numpy, configs, controls, named_numpy

import jax_native_once

torch.set_num_threads(2)
jax_native_once.load()  # the JAX pool on its library, as the port's

ROOT = Path(__file__).resolve().parents[1]
K = 2
CHUNK_LOSS_REL = 1e-4
PARAM_DRIFT_LR = 0.25


def jax_bench_train():
    spec = importlib.util.spec_from_file_location(
        "jax_root_bench_train", ROOT / "bench_train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_run():
    """The JAX file's ``main`` with its step builders swapped for
    recorders: what it builds and hands its steps, and its JSON line."""
    rec = {}
    mp = pytest.MonkeyPatch()

    def recorder(name):
        def fn(st, scene, batch, bids, controls, lr):
            rec.setdefault(name, (scene, batch, bids, controls, lr))
            return st, {"loss": jnp.float32(1.0)}
        return fn

    def build1(cfg, H, W, focal):
        rec["stage1"] = (cfg, H, W, focal)
        return recorder("stage1_nerf_ms"), recorder("stage1_sampler_ms")

    def build2(cfg, H, W, focal):
        rec["stage2"] = (cfg, H, W, focal)
        return recorder("stage2_ms")

    init = j_stage1.init_stage1_state

    def init1(params, *a):
        rec.setdefault("params", params)
        return init(params, *a)

    mp.setattr(j_stage1, "build_stage1_step_fns", build1)
    mp.setattr(j_stage2, "build_stage2_step_fn", build2)
    mp.setattr(j_stage1, "init_stage1_state", init1)
    mp.chdir(ROOT)
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            jax_bench_train().main()
    finally:
        mp.undo()
    rec["line"] = json.loads(buf.getvalue().strip().splitlines()[-1])
    return rec


@pytest.fixture(scope="module")
def port_setup():
    return bench_train.setup("cpu")


def test_configs_equal_jax(jax_run):
    cfg, cfg2 = bench_train.configs()
    jcfg, H, W, focal = jax_run["stage1"]
    jcfg2 = jax_run["stage2"][0]
    for got, want in ((cfg, jcfg), (cfg2, jcfg2)):
        g, w = dataclasses.asdict(got), dataclasses.asdict(want)
        assert Path(g.pop("config")).resolve() == \
            Path(w.pop("config")).resolve()
        assert g == w
    assert cfg2.lrate == 3e-4 and cfg.mmnetdepth == 6
    assert (H, W, focal) == (bench_train.H, bench_train.W, 0.8 * bench_train.W)
    assert jax_run["stage2"][1:] == (H, W, focal)


def test_pool_and_batch_equal_jax_bit_for_bit(jax_run):
    sc, pool, ids, batch, bids = bench_train.data()
    jsc = j_make_scene(n_views=17, H=378, W=504, focal=0.8 * 504, seed=0)
    jpool, jids = j_build_ray_pool(jsc["images"], jsc["poses"], jsc["K"],
                                   list(range(16)), 4,
                                   np.random.default_rng(0))
    np.testing.assert_array_equal(pool, jpool)
    np.testing.assert_array_equal(ids, jids)
    for name in bench_train.STEPS:
        _, jbatch, jbids, _, _ = jax_run[name]
        np.testing.assert_array_equal(batch, np.asarray(jbatch))
        np.testing.assert_array_equal(bids, np.asarray(jbids))
    assert batch.shape == (4096, 3, 3)


def test_scene_controls_and_lr_equal_jax(jax_run, port_setup):
    s = port_setup
    for name in bench_train.STEPS:
        jscene, _, _, jc, lr = jax_run[name]
        assert lr == bench_train.LR == 5e-4
        assert set(s["scene"]) == set(jscene)
        for k, v in jscene.items():
            atol = 2.0 ** -24 if k == "fused_mats" else 0
            np.testing.assert_allclose(s["scene"][k].numpy(), np.asarray(v),
                                       rtol=0, atol=atol, err_msg=k)
        c = s["controls"]
        assert c["n_mult"] == int(jc["n_mult"]) == 4
        assert c["dir_expand"] == bool(jc["dir_expand"]) is True
        assert c["dir_jitter"] == bool(jc["dir_jitter"]) is False
        np.testing.assert_array_equal(c["neighbor_subset"].numpy(),
                                      np.asarray(jc["neighbor_subset"]))
        np.testing.assert_array_equal(c["target_t"].numpy(),
                                      np.asarray(jc["target_t"]))
        assert c["raw_noise"].shape == c["jitter_noise"].shape == (4096, 64)


def test_params_have_jax_shapes(jax_run, port_setup):
    want = named_numpy(as_numpy(jax_run["params"]))
    got = {k: v.detach() for k, v in
           named_params(port_setup["params"]).items()}
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k


def test_json_line_holds_jax_keys(jax_run):
    want = jax_run["line"]
    got = bench_train.result_line(
        {k: 10.0 for k in bench_train.STEPS},
        {k: 20.0 for k in bench_train.STEPS}, "cpu")
    assert list(got) == list(want)
    assert got["metric"] == want["metric"]
    assert list(got["extra"])[:len(want["extra"])] == list(want["extra"])
    assert got["extra"]["full_500k_train_minutes"] == round(
        10.0 * 500e3 / 60e3, 1)
    assert got["extra"]["n_rand"] == want["extra"]["n_rand"] == 4096
    assert {k.replace("_eager", "") for k in got["extra"]
            if "_eager_" in k} == set(bench_train.STEPS)


# ---------------------------------------------- chains against JAX's scan --

SMALL = dict(h=18, w=24, n_views=6, n_rand=64)


@pytest.fixture(scope="module")
def small():
    jcfg, tcfg = configs()
    jparams = j_init(jax.random.PRNGKey(0), **NETS)
    s = bench_train.setup(
        "cpu", **SMALL, cfgs=(tcfg, tcfg.replace(lrate=3e-4)),
        params=convert.params_from_numpy(as_numpy(jparams)))
    return jcfg, jparams, s


def step_controls(name):
    """(JAX controls, port controls) of every step of the chain: the
    bench's host choices and key 1, with JAX's own draws of the noise from
    that key (``torch_train_common.controls``: 64 wide in stage 1, S = 8 in
    stage 2, where JAX draws the jitter from the key whatever is given)."""
    jc, tc = controls(SMALL["n_rand"], n_mult=4, dir_expand=True,
                      dir_jitter=False, subset=(0, 1, 2, 3),
                      width=8 if name == "stage2_ms" else 64, key=1)
    return jc, bench_train.controls(
        SMALL["n_rand"], "cpu", noise=(tc["raw_noise"], tc["jitter_noise"]))


def jax_chain(name, jcfg, jparams, controls):
    h, w = SMALL["h"], SMALL["w"]
    sc = j_make_scene(n_views=SMALL["n_views"], H=h, W=w, focal=0.8 * w,
                      seed=0)
    scene = j_prepare_scene(sc["images"], sc["poses"], sc["K"])
    pool, ids = j_build_ray_pool(sc["images"], sc["poses"], sc["K"],
                                 list(range(SMALL["n_views"] - 1)), 4,
                                 np.random.default_rng(0))
    batch, bids = jnp.asarray(pool[:64]), jnp.asarray(ids[:64])
    nerf_fn, sampler_fn = j_stage1.build_stage1_step_fns(jcfg, h, w, 0.8 * w)
    s2_fn = j_stage2.build_stage2_step_fn(jcfg.replace(lrate=3e-4), h, w,
                                          0.8 * w)
    fn, init = {"stage1_nerf_ms": (nerf_fn, j_stage1.init_stage1_state),
                "stage1_sampler_ms": (sampler_fn, j_stage1.init_stage1_state),
                "stage2_ms": (s2_fn, j_stage2.init_stage2_state)}[name]
    copy = jax.tree_util.tree_map(jnp.copy, jparams)

    @jax.jit
    def loop(st):
        def body(st, _):
            st, m = fn(st, scene, batch, bids, controls, 5e-4)
            return st, m["loss"]
        return jax.lax.scan(body, st, None, length=K)

    st, losses = loop(init(copy))
    return st, np.asarray(losses)


@pytest.mark.parametrize("name", bench_train.STEPS)
def test_chain_equals_jax_chained_scan(small, name):
    jcfg, jparams, s = small
    jc, tc = step_controls(name)
    jstate, jlosses = jax_chain(name, jcfg, jparams, jc)
    s = dict(s, controls=tc)
    step, init = s["steps"][name]
    state = init(bench_train.copy_params(s["params"]))
    losses = bench_train.chain(step, state, s, iters=K).numpy()
    assert losses.shape == jlosses.shape == (K,)
    assert abs(losses[0] - jlosses[0]) <= 1e-6 * abs(jlosses[0])
    assert abs(losses[1] - jlosses[1]) <= CHUNK_LOSS_REL * abs(jlosses[1])
    assert losses[1] != losses[0]  # the second step ran on the first's state
    jp = named_numpy(jstate["params"])
    d = np.concatenate([
        np.abs(v.detach().numpy() - jp[k]).ravel()
        for k, v in named_params(state["params"]).items()])
    assert d.max() <= 2 * bench_train.LR * K
    assert (d <= PARAM_DRIFT_LR * bench_train.LR).mean() >= 0.99


def test_chain_from_the_same_state_repeats_bit_for_bit(small):
    """The timing's protocol: every call runs the chain from the restored
    initial state, so every call does the same work on the same values."""
    *_, s = small
    name = "stage2_ms"
    s = dict(s, controls=step_controls(name)[1])
    step, init = s["steps"][name]
    runs = []
    for _ in range(2):
        state = init(bench_train.copy_params(s["params"]))
        runs.append(bench_train.chain(step, state, s, iters=3))
    assert torch.equal(runs[0], runs[1])
    ms, eager = bench_train.time_step(name, s, 0.0, iters=2, reps=1)
    assert ms == eager > 0  # on the CPU the chain is eager
