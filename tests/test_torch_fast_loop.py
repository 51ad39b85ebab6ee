"""Several training steps a dispatch (``pronerf_tpu_torch/train/fast_loop.py``
and the scan branch of ``train/loop.py``) against the JAX package's
``train/fast_loop.py`` on the CPU, where the chunk body runs eagerly (on the
card it is CUDA graphs of the same steps; ``chip_smoke.py --only scan``
holds those against the eager steps).

- ``explore_expand`` with a device ``n_mult`` and device direction coins
  equals the host-integer form bit for bit, and JAX's;
- ``draw_device_controls`` has the structure of JAX's
  ``_draw_device_controls`` and depends on (seed, step) alone;
- a chunk of K = 4 steps of each stage (20x24 scene, 128 rays, small nets)
  against JAX's executor, fed the controls JAX's ``_draw_device_controls``
  yields and the noise drawn from each step's key as
  ``torch_train_common.controls`` draws it;
- the chunk equals the port's own per-step steps bit for bit;
- the next chunk's controls, drawn while a chunk runs, are the draws of
  its steps, and chunks that take them equal chunks drawn at the call bit
  for bit; a call that does not continue the last one (another seed, an
  earlier step, given controls) draws at the call; the fill counters;
- twins of ``tests/test_train_smoke.py``'s scan tests: two chunks advance
  ``global_step`` by K each, ``device_reshuffle`` is an aligned
  permutation, the scan command line writes ``000010.ckpt``, a chunk wraps a
  small pool with its note, a NaN state raises within one chunk (and the
  gathers take its NaN points without faulting), ``train_precision = bf16``
  stays close to f32; and an odd stage-1 resume takes the per-step loop, a
  resumed scan run equals the uninterrupted one.

Tolerances, chunk against JAX's chunk. One step is held to
``torch_train_common``'s bounds (f32 rounding, and ReLU-kink flips; the
reason stands there). Over a chunk the two runs drift apart: a parameter
whose gradient's sign the rounding decides moves by about +lr in one run
and -lr in the other (Adam's first steps move every parameter by about lr,
whatever its gradient's size), and the next steps start from those
params. Measured on this stage-1 chunk: moments within 2.8 x
``GRAD_NORM_REL`` in norm and 0.8 x ``GRAD_MAX_REL`` at an element (the
NeRF's first layer, in the sampler optimizer; started from JAX's own state
after step 3, the port's step 4 agrees with JAX's to 3e-6), params within
3.1 lr at most and 0.09 lr on 99% of the elements, the last step's loss
within 2e-5 relative; stage 2 within 2e-5 everywhere. Bounds:
``CHUNK_DRIFT`` = 4 times ``torch_train_common``'s on the moments (nu:
twice that, it holds squares), params within 2 lr a step everywhere and
``PARAM_DRIFT_LR`` = 0.25 lr on 99%, losses and PSNRs 1e-4 relative
(``CHUNK_LOSS_REL``). A wrong control, batch or learning rate moves the
first step already, by the size of the step. Chunk against the port's own
steps: bit for bit (the same code, on the CPU).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pronerf_tpu.ops import sampling as j_sampling
from pronerf_tpu.render import prepare_scene as j_prepare_scene
from pronerf_tpu.render.raygen import build_ray_pool as j_build_ray_pool
from pronerf_tpu.train import fast_loop as j_fast
from pronerf_tpu.train.stage1 import init_stage1_state as j_init1
from pronerf_tpu.train.stage2 import init_stage2_state as j_init2
from pronerf_tpu.utils.synthetic import make_scene
from pronerf_tpu_torch import cli
from pronerf_tpu_torch.config import Config
from pronerf_tpu_torch.ops import sampling as t_sampling
from pronerf_tpu_torch.ops import warp as t_warp
from pronerf_tpu_torch.render.raygen import build_ray_pool
from pronerf_tpu_torch.render.raygen import prepare_scene as t_prepare_scene
from pronerf_tpu_torch.train import checkpoint as ckpt_mod
from pronerf_tpu_torch.train import fast_loop
from pronerf_tpu_torch.train.loop import run_training
from pronerf_tpu_torch.train.stage1 import init_stage1_state, make_stage1_steps
from pronerf_tpu_torch.train.stage2 import init_stage2_state, make_stage2_step
from pronerf_tpu_torch.train.state import named_params
from torch_train_common import (
    NETS,
    as_numpy,
    assert_trees_close,
    configs,
    named_numpy,
)

torch.set_num_threads(2)

K, N_RAND, SEED = 4, 128, 7
CHUNK_LOSS_REL = 1e-4
CHUNK_DRIFT = 4
PARAM_DRIFT_LR = 0.25


# ------------------------------------------------------ explore_expand --

@pytest.mark.parametrize("direction_up", [True, False])
@pytest.mark.parametrize("n_mult", range(1, 9))
def test_explore_expand_device_n_mult_equals_host_form_and_jax(n_mult,
                                                               direction_up):
    rng = np.random.default_rng(n_mult)
    z = np.sort(rng.uniform(0.05, 0.95, (37, 8)), axis=-1).astype(np.float32)
    zt = torch.from_numpy(z)
    host, nv_host = t_sampling.explore_expand(zt, n_mult, direction_up, 0.0,
                                              1.0, 64)
    dev, nv_dev = t_sampling.explore_expand(
        zt, torch.tensor(n_mult), torch.tensor(direction_up), 0.0, 1.0, 64)
    assert torch.equal(dev, host)
    assert int(nv_dev) == nv_host == 8 * n_mult
    want, nv_j = j_sampling.explore_expand(jnp.asarray(z), n_mult,
                                           direction_up, 0.0, 1.0, 64)
    np.testing.assert_array_equal(dev.numpy(), np.asarray(want))
    assert int(nv_j) == nv_host
    # the gap jitter's device coin too
    noise = torch.from_numpy(rng.standard_normal((37, 64), dtype=np.float32))
    assert torch.equal(
        t_sampling.gap_jitter(dev, 0.0, 1.0, torch.tensor(direction_up),
                              0.99, noise=noise),
        t_sampling.gap_jitter(dev, 0.0, 1.0, direction_up, 0.99,
                              noise=noise))


# ------------------------------------------------------------ controls --

def test_draw_device_controls_structure_and_seed_step_dependence():
    n_train, V, max_mult = 6, 4, 8
    jc = j_fast._draw_device_controls(jax.random.PRNGKey(SEED), 3, n_train,
                                      V, max_mult)
    tc = fast_loop.draw_device_controls(SEED, 3, n_train, V, max_mult,
                                        N_RAND, 64)
    # JAX's keys, with the step's noise where JAX hands its step a key
    assert set(tc) == (set(jc) - {"rng"}) | {"raw_noise", "jitter_noise"}
    for k in ("n_mult", "dir_expand", "dir_jitter", "neighbor_subset",
              "target_t"):
        assert tuple(tc[k].shape) == tuple(jc[k].shape), k
    assert tc["n_mult"].dtype == torch.int64
    assert tc["dir_expand"].dtype == tc["dir_jitter"].dtype == torch.bool
    assert tuple(tc["raw_noise"].shape) == (N_RAND, 64)
    assert torch.equal(tc["target_t"], torch.zeros(3))
    # (seed, step) alone decide the draws
    again = fast_loop.draw_device_controls(SEED, 3, n_train, V, max_mult,
                                           N_RAND, 64)
    assert all(torch.equal(tc[k], again[k]) for k in tc)
    other = fast_loop.draw_device_controls(SEED, 4, n_train, V, max_mult,
                                           N_RAND, 64)
    assert not torch.equal(tc["raw_noise"], other["raw_noise"])
    # the distributions' support: n_mult in 1..max_mult (every value
    # drawn), both coin faces, subsets sorted without repeats in range
    draws = [fast_loop.draw_device_controls(SEED, i, n_train, V, max_mult,
                                            4, 8) for i in range(1, 201)]
    assert {int(d["n_mult"]) for d in draws} == set(range(1, max_mult + 1))
    assert {bool(d["dir_expand"]) for d in draws} == {True, False}
    assert {bool(d["dir_jitter"]) for d in draws} == {True, False}
    for d in draws:
        s = d["neighbor_subset"].tolist()
        assert s == sorted(set(s)) and len(s) == V
        assert 0 <= s[0] and s[-1] < n_train - 1


# ---------------------------------------------------- chunk against JAX --

class _Chunk:
    """The 20x24 scene of the JAX smoke tests, 6 views, its ray pool (the
    JAX trainer's own), and JAX params of the small nets."""

    def __init__(self):
        sc = make_scene(n_views=6, H=20, W=24, seed=0)
        self.sc = sc
        self.H, self.W, self.focal = sc["hwf"]
        self.jscene = j_prepare_scene(sc["images"], sc["poses"], sc["K"])
        self.tscene = t_prepare_scene(sc["images"], sc["poses"], sc["K"],
                                      device="cpu")
        pool, ids = j_build_ray_pool(sc["images"], sc["poses"], sc["K"],
                                     list(range(6)), 4,
                                     np.random.default_rng(0))
        self.pool, self.ids = np.asarray(pool), np.asarray(ids)
        from pronerf_tpu.models import init_pronerf_params as j_init

        self.jparams = as_numpy(j_init(jax.random.PRNGKey(0), **NETS))

    def tparams(self):
        from pronerf_tpu_torch import convert

        return convert.params_from_numpy(self.jparams)


_CHUNK = []


def chunk_setup():
    if not _CHUNK:
        _CHUNK.append(_Chunk())
    return _CHUNK[0]


def jax_controls(base_key, steps, width):
    """The controls JAX's executor draws for ``steps``, and each step's
    noise from its key (split as ``render_rays`` splits it), as the port's
    executor takes them."""
    out = []
    for i in steps:
        jc = j_fast._draw_device_controls(base_key, i, 6, 4, 8)
        nk, jk = jax.random.split(jc["rng"])
        out.append({
            "n_mult": int(jc["n_mult"]),
            "dir_expand": bool(jc["dir_expand"]),
            "dir_jitter": bool(jc["dir_jitter"]),
            "neighbor_subset": np.array(jc["neighbor_subset"]),
            "raw_noise": np.array(jax.random.normal(nk, (N_RAND, width))),
            "jitter_noise": np.array(jax.random.normal(jk,
                                                         (N_RAND, width))),
        })
    return out


def adam_of(opt_state):
    return opt_state[-1] if type(opt_state) is tuple else opt_state


@pytest.mark.parametrize("stage", [1, 2])
def test_scan_chunk_against_jax_executor(stage):
    fx = chunk_setup()
    jcfg, tcfg = configs(N_rand=N_RAND)
    base_key = jax.random.PRNGKey(SEED)
    jinit, tinit = (j_init1, init_stage1_state) if stage == 1 else \
        (j_init2, init_stage2_state)
    jstate = jinit(jax.tree_util.tree_map(jnp.asarray, fx.jparams))
    jex = j_fast.make_scan_executor(jcfg, fx.H, fx.W, fx.focal, 6, stage, K)
    jstate, jm = jex(jstate, fx.jscene, jnp.asarray(fx.pool),
                     jnp.asarray(fx.ids), 0, base_key)

    tstate = tinit(fx.tparams())
    tex = fast_loop.make_scan_executor(tcfg, fx.H, fx.W, fx.focal, 6, stage,
                                       K)
    width = 64 if stage == 1 else 8
    tstate, tm = tex(tstate, fx.tscene, torch.from_numpy(fx.pool.copy()),
                     torch.from_numpy(fx.ids.copy()), 0, SEED,
                     controls=jax_controls(base_key, range(1, K + 1), width))

    assert tstate["global_step"] == int(jstate["global_step"]) == K
    for k in ("mean_loss", "mean_psnr", "loss", "psnr"):
        want = float(jm[k])
        assert abs(float(tm[k]) - want) <= CHUNK_LOSS_REL * abs(want), k
    opts = (("opt_nerf", ["nerf"]), ("opt_s", None)) if stage == 1 else \
        (("opt", None),)
    for opt, nets in opts:
        ja = adam_of(jstate[opt])
        assert tstate[opt]["count"] == int(ja.count)
        for part, power in (("mu", 1), ("nu", 2)):
            tree = getattr(ja, part)
            if nets == ["nerf"]:
                tree = {"nerf": tree,
                        "sampler": fx.jparams["sampler"],
                        "refine": fx.jparams["refine"]}
            want = {k: v for k, v in named_numpy(tree).items()
                    if nets is None or k.startswith("nerf.")}
            assert_trees_close(tstate[opt][part], want, f"{opt}.{part}",
                               power=power * CHUNK_DRIFT)
    jp = named_numpy(jstate["params"])
    d = np.concatenate([
        np.abs(v.detach().numpy() - jp[k]).ravel()
        for k, v in named_params(tstate["params"]).items()])
    lr = tcfg.lrate
    assert d.max() <= 2 * lr * K
    assert (d <= PARAM_DRIFT_LR * lr).mean() >= 0.99


# ------------------------------------------- chunk against its own steps --

def port_setup(**kw):
    fx = chunk_setup()
    _, tcfg = configs(N_rand=N_RAND, **kw)
    return fx, tcfg


@pytest.mark.parametrize("stage, buckets", [(1, False), (1, True),
                                            (2, False)])
def test_scan_chunk_equals_per_step_steps_bit_for_bit(stage, buckets):
    fx, cfg = port_setup(explore_buckets=buckets)
    init = init_stage1_state if stage == 1 else init_stage2_state
    ex = fast_loop.make_scan_executor(cfg, fx.H, fx.W, fx.focal, 6, stage, K)
    pool = torch.from_numpy(fx.pool.copy())
    ids = torch.from_numpy(fx.ids.copy())
    chunk, _ = ex(init(fx.tparams()), fx.tscene, pool, ids, N_RAND, SEED)
    if stage == 1:
        nerf_step, sampler_step = make_stage1_steps(cfg, fx.H, fx.W,
                                                    fx.focal)
        fns = [nerf_step, sampler_step] * (K // 2)
    else:
        fns = [make_stage2_step(cfg, fx.H, fx.W, fx.focal)] * K
    state = init(fx.tparams())
    for k, c in enumerate(ex.chunk_controls()):
        lr = c.pop("lr")
        c["n_mult"] = int(c["n_mult"])  # host values, as the loop draws
        c["dir_expand"] = bool(c["dir_expand"])
        c["dir_jitter"] = bool(c["dir_jitter"])
        lo = N_RAND * (1 + k)
        state, m = fns[k](state, fx.tscene, pool[lo:lo + N_RAND],
                          ids[lo:lo + N_RAND], c, lr)
        assert float(m["loss"]) == float(ex.buf["losses"][k])
    for a, b in zip(named_params(chunk["params"]).values(),
                    named_params(state["params"]).values()):
        assert torch.equal(a, b)
    for opt in (("opt_nerf", "opt_s") if stage == 1 else ("opt",)):
        assert chunk[opt]["count"] == state[opt]["count"]
        for part in ("mu", "nu"):
            for k, v in state[opt][part].items():
                assert torch.equal(chunk[opt][part][k], v), (opt, part, k)
    assert chunk["global_step"] == state["global_step"] == K


# ---------------------------------------- the next chunk's early draws --

def run_chunks(fx, cfg, stage, state, calls, ex=None):
    """``calls`` chunks, each ``(i_batch0, seed, controls)``, on ``ex`` (a
    fresh executor for each chunk where None): (state, the last executor,
    its metrics)."""
    pool = torch.from_numpy(fx.pool.copy())
    ids = torch.from_numpy(fx.ids.copy())
    for i_batch0, seed, controls in calls:
        run = ex or fast_loop.make_scan_executor(cfg, fx.H, fx.W, fx.focal,
                                                 6, stage, K)
        state, m = run(state, fx.tscene, pool, ids, i_batch0, seed,
                       controls=controls)
    return state, run, m


def assert_same_chunks(a, ex_a, m_a, b, ex_b, m_b):
    """Bit for bit: params, moments and step counts, the last chunk's
    losses, metrics and controls."""
    assert a["global_step"] == b["global_step"]
    for x, y in zip(named_params(a["params"]).values(),
                    named_params(b["params"]).values()):
        assert torch.equal(x, y)
    opts = [o for o in ("opt", "opt_nerf", "opt_s") if o in a]
    for opt in opts:
        assert a[opt]["count"] == b[opt]["count"]
        for part in ("mu", "nu"):
            for k, v in a[opt][part].items():
                assert torch.equal(v, b[opt][part][k]), (opt, part, k)
    assert torch.equal(ex_a.buf["losses"], ex_b.buf["losses"])
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k
    for ca, cb in zip(ex_a.chunk_controls(), ex_b.chunk_controls()):
        assert ca.keys() == cb.keys()
        for k in ca:
            assert torch.equal(torch.as_tensor(ca[k]),
                               torch.as_tensor(cb[k])), k


def fill_counts():
    return (fast_loop.COUNTERS["fill_predrawn"],
            fast_loop.COUNTERS["fill_drawn"])


def init_for(stage, fx):
    return (init_stage1_state if stage == 1 else init_stage2_state)(
        fx.tparams())


@pytest.mark.parametrize("stage", [1, 2])
def test_predrawn_chunks_equal_chunks_drawn_at_the_call(stage):
    """Two chunks on one executor (the second takes the controls drawn
    while the first ran) against the same chunks each drawn at the call (a
    fresh executor a chunk); the counters say which fill each took."""
    fx, cfg = port_setup()
    ex = fast_loop.make_scan_executor(cfg, fx.H, fx.W, fx.focal, 6, stage, K)
    calls = [(0, SEED, None), (K * N_RAND, SEED, None)]
    p0, d0 = fill_counts()
    state, _, _ = run_chunks(fx, cfg, stage, init_for(stage, fx), calls[:1],
                             ex)
    assert fill_counts() == (p0, d0 + 1)
    state, _, m = run_chunks(fx, cfg, stage, state, calls[1:], ex)
    assert fill_counts() == (p0 + 1, d0 + 1)
    want, ex_b, m_b = run_chunks(fx, cfg, stage, init_for(stage, fx), calls)
    assert fill_counts() == (p0 + 1, d0 + 3)
    assert_same_chunks(state, ex, m, want, ex_b, m_b)


@pytest.mark.parametrize("stage", [1, 2])
def test_staged_rows_are_the_next_chunks_draws(stage):
    fx, cfg = port_setup()
    ex = fast_loop.make_scan_executor(cfg, fx.H, fx.W, fx.focal, 6, stage, K)
    run_chunks(fx, cfg, stage, init_for(stage, fx), [(0, SEED, None)], ex)
    width = 64 if stage == 1 else cfg.N_samples
    for j, step in enumerate(range(K + 1, 2 * K + 1)):
        want = fast_loop.draw_device_controls(
            SEED, step, 6, cfg.num_neighbor, max(1, 64 // cfg.N_samples),
            N_RAND, width)
        for key in fast_loop._CONTROL_KEYS:
            assert torch.equal(ex.staged[key][j], want[key]), (step, key)


@pytest.mark.parametrize("miss", ["seed", "earlier_step", "controls"])
@pytest.mark.parametrize("stage", [1, 2])
def test_a_call_that_does_not_continue_draws_at_the_call(stage, miss):
    """After a chunk, a call with another seed, a state put back to an
    earlier step, or given controls draws at the call: it equals the same
    call on a fresh executor."""
    fx, cfg = port_setup()
    ex = fast_loop.make_scan_executor(cfg, fx.H, fx.W, fx.focal, 6, stage, K)
    first = [(0, SEED, None)]
    state, _, _ = run_chunks(fx, cfg, stage, init_for(stage, fx), first, ex)
    twin, _, _ = run_chunks(fx, cfg, stage, init_for(stage, fx), first)
    nxt = (K * N_RAND, SEED, None)
    if miss == "seed":
        nxt = (K * N_RAND, SEED + 1, None)
    elif miss == "earlier_step":
        state, twin = init_for(stage, fx), init_for(stage, fx)
    else:
        width = 64 if stage == 1 else cfg.N_samples
        nxt = (K * N_RAND, SEED, [fast_loop.draw_device_controls(
            SEED + 1, i, 6, cfg.num_neighbor, max(1, 64 // cfg.N_samples),
            N_RAND, width) for i in range(K + 1, 2 * K + 1)])
    p0, d0 = fill_counts()
    state, _, m = run_chunks(fx, cfg, stage, state, [nxt], ex)
    assert fill_counts() == (p0, d0 + 1)
    want, ex_b, m_b = run_chunks(fx, cfg, stage, twin, [nxt])
    assert_same_chunks(state, ex, m, want, ex_b, m_b)


def test_scan_executor_runs_and_advances():
    fx, cfg = port_setup()
    state = init_stage1_state(fx.tparams())
    ex = fast_loop.make_scan_executor(cfg, fx.H, fx.W, fx.focal, 6, 1, K)
    pool = torch.from_numpy(fx.pool.copy())
    ids = torch.from_numpy(fx.ids.copy())
    state, m = ex(state, fx.tscene, pool, ids, 0, SEED)
    assert state["global_step"] == K
    assert np.isfinite(float(m["mean_loss"]))
    # a second chunk continues the alternation from the host step count
    state, m = ex(state, fx.tscene, pool, ids, 512, SEED)
    assert state["global_step"] == 2 * K
    assert state["opt_nerf"]["count"] == state["opt_s"]["count"] == K
    with pytest.raises(ValueError, match="even"):
        fast_loop.make_scan_executor(cfg, fx.H, fx.W, fx.focal, 6, 1, 3)


def test_device_reshuffle_is_aligned_permutation():
    m = 1000
    pool = torch.arange(m * 9, dtype=torch.float32).reshape(m, 3, 3)
    ids = torch.arange(m, dtype=torch.int32)
    addr = pool.data_ptr(), ids.data_ptr()
    out_pool, out_ids = fast_loop.device_reshuffle(pool, ids, 3)
    # in place: the captured steps read the pool at its address
    assert (out_pool.data_ptr(), out_ids.data_ptr()) == addr
    assert not torch.equal(out_ids, torch.arange(m, dtype=torch.int32))
    assert torch.equal(torch.sort(out_ids).values,
                       torch.arange(m, dtype=torch.int32))
    assert torch.equal(out_pool[:, 0, 0], (out_ids * 9).float())


def test_train_precision_bf16_matches_f32_closely():
    fx = chunk_setup()
    pool, ids = fx.pool, fx.ids

    def run(tp, stage):
        _, cfg = configs(N_rand=N_RAND, train_precision=tp)
        init = init_stage1_state if stage == 1 else init_stage2_state
        state = init(fx.tparams())
        ex = fast_loop.make_scan_executor(cfg, fx.H, fx.W, fx.focal, 6,
                                          stage, K)
        state, m = ex(state, fx.tscene, torch.from_numpy(pool.copy()),
                      torch.from_numpy(ids.copy()), 0, SEED)
        return float(m["mean_loss"]), state

    for stage in (1, 2):
        loss_f32, _ = run("f32", stage)
        loss_bf16, st = run("bf16", stage)
        assert np.isfinite(loss_bf16)
        assert abs(loss_bf16 - loss_f32) <= 0.05 * max(abs(loss_f32), 1e-6)
        assert st["params"]["nerf"].pts[0].weight.dtype == torch.float32


# ------------------------------------------------------------ the loop --

SMALL = ["--netdepth", "3", "--netwidth", "32", "--mmnetdepth", "2",
         "--mmnetwidth", "32", "--i_testset", "0", "--i_video", "0",
         "--i_img", "0"]


def common(workdir, name, datadir="synthetic:24x18x9", n_rand="64"):
    return ["--device", "cpu", "--", "--datadir", datadir, "--basedir",
            str(workdir), "--expname", name, "--N_rand", n_rand] + SMALL


def test_scan_steps_cli_smoke(tmp_path, capsys):
    cli.main(["train-stage1", "--no-reload", "--max-steps", "10"]
             + common(tmp_path, "s1_scan")
             + ["--scan_steps", "4", "--i_print", "4"])
    out = capsys.readouterr().out
    assert "(chunk means)" in out
    ckpts = sorted((tmp_path / "s1_scan").glob("*.ckpt"))
    assert ckpts and ckpts[-1].name == "000010.ckpt"
    ck = ckpt_mod.load_checkpoint(ckpts[-1])
    assert ck["global_step"] == 10
    assert ck["optimizer"]["count"] == ck["s_optimizer"]["count"] == 5
    # stage 2 through the chunks, bootstrapped from that expdir
    cli.main(["train-stage2", "--no-reload", "--max-steps", "6",
              "--pretrain-path", str(tmp_path / "s1_scan")]
             + common(tmp_path, "s2_scan") + ["--scan_steps", "3"])
    assert sorted(p.name for p in (tmp_path / "s2_scan").glob("*.ckpt"))[
        -1] == "000006.ckpt"


def test_scan_chunk_wraps_small_pool(tmp_path, capsys):
    cli.main(["train-stage1", "--no-reload", "--max-steps", "24"]
             + common(tmp_path, "s1_wrap", "synthetic:24x20x6", "128")
             + ["--scan_steps", "24", "--i_print", "24", "--i_weights",
                "24"])
    out = capsys.readouterr().out
    assert "in-chunk epoch wrap" in out  # 24 > 18 pool batches
    ckpts = sorted((tmp_path / "s1_wrap").glob("*.ckpt"))
    assert ckpts and ckpts[-1].name == "000024.ckpt"


def test_scan_executor_nan_raises_within_one_chunk(tmp_path, capsys):
    cli.main(["train-stage1", "--no-reload", "--max-steps", "2"]
             + common(tmp_path, "s1_nan"))
    capsys.readouterr()
    path = sorted((tmp_path / "s1_nan").glob("*.ckpt"))[-1]
    ck = ckpt_mod.load_checkpoint(path)
    w = next(k for k in ck["network_fn"] if k.endswith("weight"))
    ck["network_fn"][w] = torch.full_like(ck["network_fn"][w], float("nan"))
    ckpt_mod.save_checkpoint(path, ck)
    with pytest.raises(FloatingPointError, match="chunk"):
        cli.main(["train-stage1", "--max-steps", "8"]
                 + common(tmp_path, "s1_nan")
                 + ["--scan_steps", "4", "--i_print", "1000000"])


def test_gathers_take_nan_points_without_faulting():
    """A diverged state's NaN sample points project to NaN coordinates,
    whose integer pixel index is undefined (on the CPU it was far out of
    range: an IndexError; on the card a device-side assert). The index is
    clipped into the image; the point stays out of bounds, masked."""
    sc = make_scene(n_views=4, H=20, W=24, seed=0)
    scene = t_prepare_scene(sc["images"], sc["poses"], sc["K"], device="cpu")
    rays_o = torch.zeros(5, 3)
    rays_d = torch.tensor([[0.0, 0.0, -1.0]] * 5)
    z3d = torch.full((5, 8), 2.0)
    z3d[2] = float("nan")
    view_idx = torch.tensor([[0, 1, 2, 3]] * 5)
    for pack in (scene["images"],
                 t_warp.build_rgb_word_u8(torch.from_numpy(sc["images"]))):
        colors = t_warp.epipolar_colors(pack, scene["fused_mats"],
                                        scene["K"], view_idx, rays_o, rays_d,
                                        z3d)
        assert colors.shape == (5, 4, 8, 3)
        good = torch.ones(5, dtype=torch.bool)
        good[2] = False
        assert torch.isfinite(colors[good]).all()


def test_odd_stage1_resume_takes_the_per_step_loop(tmp_path, capsys):
    cli.main(["train-stage1", "--no-reload", "--max-steps", "3"]
             + common(tmp_path, "s1_odd"))
    capsys.readouterr()
    state, _ = cli.main(["train-stage1", "--max-steps", "4"]
                        + common(tmp_path, "s1_odd") + ["--scan_steps", "4"])
    assert "requires an even resume step" in capsys.readouterr().out
    assert state["global_step"] == 7


def test_resumed_scan_run_equals_the_uninterrupted_one(tmp_path):
    def run(name, steps, no_reload):
        cfg = Config.from_file(
            "configs/llff/fern/fern_epi.txt", datadir="synthetic:24x18x9",
            basedir=str(tmp_path), expname=name, N_rand=64, netdepth=3,
            netwidth=32, mmnetdepth=2, mmnetwidth=32, i_print=1,
            i_weights=1000, i_img=0, i_testset=0, i_video=0, scan_steps=4,
            max_steps=steps, no_reload=no_reload)
        return run_training(cfg, 1, device="cpu")[0]

    whole = run("whole", 8, True)
    run("halves", 4, True)
    resumed = run("halves", 4, False)
    assert resumed["global_step"] == whole["global_step"] == 8
    for a, b in zip(named_params(whole["params"]).values(),
                    named_params(resumed["params"]).values()):
        assert torch.equal(a, b)


def test_explore_buckets_need_the_width_on_the_host():
    fx, cfg = port_setup(explore_buckets=True)
    nerf_step, _ = make_stage1_steps(cfg, fx.H, fx.W, fx.focal)
    c = fast_loop.draw_device_controls(SEED, 1, 6, 4, 8, N_RAND, 64)
    state = init_stage1_state(fx.tparams())
    pool = torch.from_numpy(fx.pool[:N_RAND].copy())
    with pytest.raises(ValueError, match="width"):
        nerf_step(state, fx.tscene, pool, torch.from_numpy(
            fx.ids[:N_RAND].copy()), c, 5e-4)
