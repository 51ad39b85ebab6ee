"""The training slice's stateless pieces against the JAX package, on the
CPU: ``explore_expand`` and ``gap_jitter``, the all-views epipolar gather,
the ray pool and ``rays_from_pool``, the LR schedules and the host-side
controls of the loop.

Tolerances. Sample surgery: ``2e-7`` (f32 arithmetic on values in [0, 1],
the same operations in the same order; the sort moves values, it does not
round). The gather: the JAX suite's bound for its own gathers against each
other, ``1e-6``, on the colours of points whose projection is not within
1e-4 of the out-of-bounds edge (a last-bit difference in the projection
flips that test; ``tests/test_torch_render.py`` explains it). Rays: ``1e-6``
(NDC maps differ in the last bit). The pool, the LR values and the controls
are equal exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pronerf_tpu.ops import sampling as j_sampling
from pronerf_tpu.ops import warp as j_warp
from pronerf_tpu.render import raygen as j_raygen
from pronerf_tpu.train import loop as j_loop
from pronerf_tpu.train import state as j_state
from pronerf_tpu_torch.ops import sampling as t_sampling
from pronerf_tpu_torch.ops import warp as t_warp
from pronerf_tpu_torch.render import raygen as t_raygen
from pronerf_tpu_torch.train import loop as t_loop
from pronerf_tpu_torch.train import state as t_state
from torch_train_common import Setup, T, configs

torch.set_num_threads(2)


def sorted_depths(n=32, S=8, seed=0):
    rng = np.random.default_rng(seed)
    return np.sort(rng.random((n, S)).astype(np.float32), axis=-1)


@pytest.mark.parametrize("direction_up", [True, False])
@pytest.mark.parametrize("n_mult", range(1, 9))
def test_explore_expand_matches_jax(n_mult, direction_up):
    z = sorted_depths(seed=n_mult)
    want, nv = j_sampling.explore_expand(jnp.asarray(z), n_mult, direction_up,
                                         1e-6, 1.0, 64)
    got, got_nv = t_sampling.explore_expand(T(z), n_mult, direction_up, 1e-6,
                                            1.0, 64)
    assert got_nv == int(nv) == 8 * n_mult
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-7)
    assert (got[:, 8 * n_mult:] == 1.0).all()
    # gradients flow through the permutation of the sort: d sum(w * z_exp)
    # / dz against jax.grad of the same sum
    w = np.random.default_rng(1).random((32, 64)).astype(np.float32)
    import jax

    jg = jax.grad(lambda zz: jnp.sum(jnp.asarray(w) * j_sampling.explore_expand(
        zz, n_mult, direction_up, 1e-6, 1.0, 64)[0]))(jnp.asarray(z))
    zt = T(z).requires_grad_()
    (T(w) * t_sampling.explore_expand(zt, n_mult, direction_up, 1e-6, 1.0,
                                      64)[0]).sum().backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(jg), atol=1e-5)


@pytest.mark.parametrize("max_noise", [0.99, 1.0 - 2e-6])
@pytest.mark.parametrize("direction_up", [True, False])
def test_gap_jitter_matches_jax(direction_up, max_noise):
    z = sorted_depths(seed=3)
    noise = np.random.default_rng(4).normal(size=(32, 64)).astype(np.float32)
    noise[0, :4] = 9.0  # clipped at max_noise
    want = j_sampling.gap_jitter(None, jnp.asarray(z), 0.0, 1.0, direction_up,
                                 max_noise, noise=jnp.asarray(noise[:, :8]))
    got = t_sampling.gap_jitter(T(z), 0.0, 1.0, direction_up, max_noise,
                                noise=T(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-7)
    # without noise, a draw from the generator: in the gaps, in order
    drawn = t_sampling.gap_jitter(T(z), 0.0, 1.0, direction_up, max_noise,
                                  generator=torch.Generator().manual_seed(0))
    assert (torch.diff(drawn, dim=-1) >= 0).all()
    assert not torch.equal(drawn, T(z))


@pytest.mark.parametrize("pack", ["u8", "f32", False])
def test_epipolar_colors_all_views_matches_jax(pack):
    su = Setup(pack=pack)
    rng = np.random.default_rng(5)
    n, S, V = 48, 8, 4
    view_idx = rng.integers(0, 6, size=(n, V)).astype(np.int32)
    o = su.batch[:n, 0]
    d = su.batch[:n, 1]
    z3d = (1.0 / (1.0 - np.sort(rng.random((n, S)), -1) * 0.9)).astype(
        np.float32)
    want = np.asarray(j_warp.epipolar_colors(
        su.jscene["images"], su.jscene["fused_mats"], su.jscene["K"],
        jnp.asarray(view_idx), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(z3d)))
    got = t_warp.epipolar_colors(
        su.tscene["images"], su.tscene["fused_mats"], su.tscene["K"],
        T(view_idx), T(o), T(d), T(z3d)).numpy()
    assert got.shape == want.shape == (n, V, S, 3)
    # points whose projection lies away from the image border by 1e-4
    pts = o[:, None, :] + d[:, None, :] * z3d[..., None]
    M = np.asarray(su.jscene["fused_mats"])[view_idx]
    p = np.einsum("nvij,nsj->nvsi", M[..., :3], pts) + M[..., None, :, 3]
    K = np.asarray(su.jscene["K"])
    z = np.abs(p[..., 2]) + 1e-8
    xn = 2 * (K[0, 0] * p[..., 0] / z + K[0, 2]) / (su.W - 1) - 1
    yn = 2 * (K[1, 1] * p[..., 1] / z + K[1, 2]) / (su.H - 1) - 1
    safe = (np.abs(np.abs(xn) - 1) > 1e-4) & (np.abs(np.abs(yn) - 1) > 1e-4)
    assert safe.mean() > 0.95 and (got[safe].sum(-1) > 0).mean() > 0.3
    np.testing.assert_allclose(got[safe], want[safe], atol=1e-6)
    assert not t_warp.per_view_gather_auto(su.tscene["images"])


def test_rays_from_pool_matches_jax():
    su = Setup()
    want = j_raygen.rays_from_pool(jnp.asarray(su.batch[:, :2]),
                                   jnp.asarray(su.ids), su.H, su.W, su.focal)
    got = t_raygen.rays_from_pool(T(su.batch[:, :2]), T(su.ids), su.H, su.W,
                                  su.focal)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.shape == want[k].shape, k
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), atol=1e-6,
                                   err_msg=k)


def test_build_ray_pool_equals_jax_numpy_path_bit_for_bit(monkeypatch):
    """Both packages forced onto their NumPy form: the JAX package by taking
    its native builder away, the port by its own switch. (The default, native
    form: tests/test_torch_native.py.)"""
    import pronerf_tpu.native

    monkeypatch.setattr(pronerf_tpu.native, "build_ray_pool_native",
                        lambda *a, **k: None)
    su = Setup()
    sc = su.sc
    i_train = [0, 2, 3, 5]
    jrng, trng = np.random.default_rng(11), np.random.default_rng(11)
    want = j_raygen.build_ray_pool(sc["images"], sc["poses"], sc["K"], i_train,
                                   4, jrng)
    got = t_raygen.build_ray_pool(sc["images"], sc["poses"], sc["K"], i_train,
                                  4, trng, native=False)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # and the Generator is left in the same state
    assert trng.integers(0, 2**31) == jrng.integers(0, 2**31)


def test_lr_schedules_match_jax():
    for step in (0, 1, 2, 999, 250_000, 500_000):
        assert t_state.stage1_lr(step, 5e-4, 250) == \
            j_state.stage1_lr(step, 5e-4, 250)
        assert t_state.stage2_lr(step, 3e-4, 250) == \
            j_state.stage2_lr(step, 3e-4, 250)
    # the /2: stage 1 at step 2k decays as stage 2 at k
    assert t_state.stage1_lr(2000, 5e-4, 250) == t_state.stage2_lr(
        1000, 5e-4, 250)


def test_draw_controls_equals_jax_step_for_step():
    jcfg, tcfg = configs()
    jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
    seeds = set()
    for step in range(1, 41):
        want = j_loop._draw_controls(jrng, 6, jcfg, step)
        got = t_loop._draw_controls(trng, 6, tcfg, step)
        assert got["n_mult"] == int(want["n_mult"])
        assert got["dir_expand"] == bool(want["dir_expand"])
        assert got["dir_jitter"] == bool(want["dir_jitter"])
        np.testing.assert_array_equal(got["neighbor_subset"].numpy(),
                                      np.asarray(want["neighbor_subset"]))
        assert got["target_t"].shape == (3,)
        # the step's generator is seeded as JAX keys the step
        seed = tcfg.seed * 1_000_003 + step
        assert got["rng"].initial_seed() == seed
        seeds.add(seed)
    assert len(seeds) == 40
