"""One full step of each of the three step functions (stage-1 NeRF, stage-1
sampler, stage 2) against the JAX package's, on the CPU: the loss, the
updated params and both Adam moments, from the same params, batch, controls
and noise; and the port's ``explore_buckets`` width invariance.

Tolerances. Loss ``1e-6`` relative. Moments: ``mu = 0.1 g`` and ``nu = 0.001
g^2`` after one step, so the gradients' bounds of ``torch_train_common``
(``GRAD_NORM_REL``, ``GRAD_MAX_REL``), doubled for nu. Params: ``p - lr u``
with u = g / (|g| + eps) after one step, about the sign of g: everywhere
within 2 lr, and within 1e-3 lr on 99% of the elements of the step's params
(u turns on the last bits of g where |g| is near 0 or a kink flip moved g;
measured: 2 of 4,096 elements of one tensor). That the port applies ``p - lr
u`` to its own moments exactly is checked apart.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pronerf_tpu.train import stage1 as j_stage1
from pronerf_tpu.train import stage2 as j_stage2
from pronerf_tpu_torch.models.pronerf import RenderStatics, render_rays
from pronerf_tpu_torch.render.raygen import rays_from_pool
from pronerf_tpu_torch.train import stage1 as t_stage1
from pronerf_tpu_torch.train import stage2 as t_stage2
from pronerf_tpu_torch.train.state import adam_init, adam_step, named_params
from torch_train_common import (
    N_RAYS,
    Setup,
    T,
    assert_trees_close,
    configs,
    controls,
    named_numpy,
)

torch.set_num_threads(2)

LR = 5e-4


def adam_of(opt_state):
    """optax's ScaleByAdamState (alone, or last in a chain)."""
    return opt_state[-1] if type(opt_state) is tuple else opt_state


def check_step(jstate, jmetrics, tstate, tmetrics, opt_key, nets):
    assert abs(float(tmetrics["loss"]) - float(jmetrics["loss"])) <= \
        1e-6 * float(jmetrics["loss"])
    assert abs(float(tmetrics["psnr"]) - float(jmetrics["psnr"])) <= 1e-4
    assert tstate["global_step"] == int(jstate["global_step"]) == 1
    ja = adam_of(jstate[opt_key])
    to = tstate[opt_key]
    assert to["count"] == int(ja.count) == 1
    mu, nu = named_numpy_partial(ja.mu, nets), named_numpy_partial(ja.nu, nets)
    assert_trees_close(to["mu"], mu, "mu")
    assert_trees_close(to["nu"], nu, "nu", power=2)
    jp = named_numpy(jstate["params"])
    d = np.concatenate([
        np.abs(v.detach().numpy() - jp[k]).ravel()
        for k, v in named_params(tstate["params"]).items()])
    # the share is the check; the max is a sanity check that also catches a
    # non-finite update (after one Adam step from zero moments |u| <= 1 on
    # both sides, so a finite difference is at most 2 lr)
    assert d.max() <= 2 * LR and (d <= 1e-3 * LR).mean() >= 0.99


def named_numpy_partial(tree, nets):
    """Moments over a subset of the nets (``opt_nerf`` holds the NeRF's)."""
    if nets == ["nerf"]:
        full = named_numpy({"nerf": tree, "sampler": _zeros["sampler"],
                            "refine": _zeros["refine"]})
        return {k: v for k, v in full.items() if k.startswith("nerf.")}
    return named_numpy(tree)


_zeros = {}


def jax_inputs(su):
    return (su.jscene, jnp.asarray(su.batch), jnp.asarray(su.ids))


def port_inputs(su):
    return (su.tscene, T(su.batch), T(su.ids))


@pytest.mark.parametrize("n_mult,weight_decay", [(2, 0.0), (8, 0.0),
                                                 (5, 1e-3)])
def test_stage1_nerf_step_matches_jax(n_mult, weight_decay):
    su = Setup()
    _zeros.update({k: v for k, v in su.jparams_copy().items() if k != "nerf"})
    jcfg, tcfg = configs(weight_decay=weight_decay)
    jc, tc = controls(N_RAYS, n_mult, True, n_mult % 2 == 0)
    nerf_j, _ = j_stage1.make_stage1_steps(jcfg, su.H, su.W, su.focal)
    jstate, jm = nerf_j(
        j_stage1.init_stage1_state(su.jparams_copy(), weight_decay),
        *jax_inputs(su), jc, LR)
    nerf_t, _ = t_stage1.make_stage1_steps(tcfg, su.H, su.W, su.focal)
    tstate, tm = nerf_t(t_stage1.init_stage1_state(su.tparams(), weight_decay),
                        *port_inputs(su), tc, LR)
    check_step(jstate, jm, tstate, tm, "opt_nerf", ["nerf"])
    # the sampler step's optimizer was not touched
    assert tstate["opt_s"]["count"] == 0
    assert all(not v.any() for v in tstate["opt_s"]["mu"].values())


@pytest.mark.parametrize("weight_decay", [0.0, 1e-3])
def test_stage1_sampler_step_matches_jax(weight_decay):
    su = Setup()
    jcfg, tcfg = configs(weight_decay=weight_decay)
    jc, tc = controls(N_RAYS, 3)
    _, sampler_j = j_stage1.make_stage1_steps(jcfg, su.H, su.W, su.focal)
    jstate, jm = sampler_j(
        j_stage1.init_stage1_state(su.jparams_copy(), weight_decay),
        *jax_inputs(su), jc, LR)
    _, sampler_t = t_stage1.make_stage1_steps(tcfg, su.H, su.W, su.focal)
    tstate, tm = sampler_t(
        t_stage1.init_stage1_state(su.tparams(), weight_decay),
        *port_inputs(su), tc, LR)
    check_step(jstate, jm, tstate, tm, "opt_s", None)
    assert tstate["opt_nerf"]["count"] == 0


@pytest.mark.parametrize("a_mmrgb,dir_jitter", [(0.0, True), (1.0, False)])
def test_stage2_step_matches_jax(a_mmrgb, dir_jitter):
    su = Setup()
    jcfg, tcfg = configs(a_mmrgb=a_mmrgb)
    jc, tc = controls(N_RAYS, 3, dir_jitter=dir_jitter, width=8)
    step_j = j_stage2.make_stage2_step(jcfg, su.H, su.W, su.focal)
    jstate, jm = step_j(j_stage2.init_stage2_state(su.jparams_copy()),
                        *jax_inputs(su), jc, LR)
    step_t = t_stage2.make_stage2_step(tcfg, su.H, su.W, su.focal)
    tstate, tm = step_t(t_stage2.init_stage2_state(su.tparams()),
                        *port_inputs(su), tc, LR)
    check_step(jstate, jm, tstate, tm, "opt", None)
    # the vestigial NeRF optimizer is never stepped
    assert tstate["opt_nerf"]["count"] == 0


def test_adam_with_two_overlapping_states():
    """opt_nerf (the NeRF) and opt_s (all nets) keep apart moments for the
    same parameters; each step touches only its own."""
    su = Setup()
    params = su.tparams()
    a, b = adam_init(named_params(params, ["nerf"])), adam_init(
        named_params(params))
    named = named_params(params, ["nerf"])
    grads = [torch.ones_like(p) for p in named.values()]
    adam_step(a, named, grads, 1e-3)
    assert a["count"] == 1 and b["count"] == 0
    key = "nerf.rgb.bias"
    assert torch.allclose(a["mu"][key], torch.full_like(a["mu"][key], 0.1))
    assert not b["mu"][key].any()
    # u = mu_hat / (sqrt(nu_hat) + eps) = 1 / (1 + 1e-8): p moved by lr,
    # up to the f32 rounding of p (|p| < 0.5)
    before = su.tparams()["nerf"].rgb.bias
    np.testing.assert_allclose(
        (before - params["nerf"].rgb.bias).detach().numpy(), 1e-3, rtol=0,
        atol=6e-8)


@pytest.mark.parametrize("n_mult", [1, 2, 3, 5])
def test_explore_buckets_width_invariance(n_mult):
    """With the noise drawn at the full width and sliced, the NeRF branch at
    the width that covers S * n_mult renders what the full width renders
    (the parked slots carry no weight), and the bucketed step equals the
    plain one."""
    su = Setup()
    _, tc = controls(N_RAYS, n_mult, True, True)
    params = su.tparams()
    rays = rays_from_pool(T(su.batch[:, :2]), T(su.ids), su.H, su.W, su.focal)
    statics = RenderStatics.stage1_nerf(N_samples=8, N_point_ray_enc=48,
                                        num_neighbor=4)
    widths = t_stage1.explore_widths(
        dataclasses.replace(configs()[1], explore_buckets=True), 64)
    assert widths == [8, 16, 32, 64]
    width = next(w for w in widths if w // 8 >= n_mult)
    with torch.no_grad():
        full = render_rays(params, rays, su.tscene, tc, statics)
        part = render_rays(params, rays, su.tscene, tc,
                           dataclasses.replace(statics, max_expand=width))
    np.testing.assert_allclose(part["rgb1"].numpy(), full["rgb1"].numpy(),
                               atol=1e-5)
    states = []
    for buckets in (False, True):
        cfg = configs(explore_buckets=buckets)[1]
        step, _ = t_stage1.make_stage1_steps(cfg, su.H, su.W, su.focal)
        ctl = {k: v for k, v in tc.items()
               if k not in ("raw_noise", "jitter_noise")}
        ctl["rng"] = torch.Generator().manual_seed(5)
        states.append(step(t_stage1.init_stage1_state(su.tparams()),
                           *port_inputs(su), ctl, LR))
    (s0, m0), (s1, m1) = states
    assert abs(float(m0["loss"]) - float(m1["loss"])) <= 1e-5 * float(
        m0["loss"])
    p0, p1 = named_params(s0["params"]), named_params(s1["params"])
    for k in p0:
        np.testing.assert_allclose(p1[k].detach().numpy(),
                                   p0[k].detach().numpy(), atol=1e-3 * LR,
                                   err_msg=k)


def test_adam_step_applies_its_own_moments_exactly():
    """After one step, p == p0 - lr * (mu / bc1) / (sqrt(nu / bc2) + eps),
    computed in f32 from the moments the step kept, and the moments are
    (1 - b) g + b m of the gradient given."""
    su = Setup()
    params = su.tparams()
    p0 = {k: v.detach().clone() for k, v in named_params(params).items()}
    named = named_params(params)
    gen = torch.Generator().manual_seed(3)
    grads = [torch.randn(p.shape, generator=gen) * 1e-3 for p in named.values()]
    state = adam_init(named)
    adam_step(state, named, grads, LR, weight_decay=1e-3)
    bc1 = 1.0 - torch.tensor(0.9) ** 1
    bc2 = 1.0 - torch.tensor(0.999) ** 1
    for (k, p), g in zip(named.items(), grads):
        g = g + 1e-3 * p0[k]
        assert torch.equal(state["mu"][k], (1.0 - 0.9) * g)
        assert torch.equal(state["nu"][k], (1.0 - 0.999) * (g * g))
        u = (state["mu"][k] / bc1) / (torch.sqrt(state["nu"][k] / bc2) + 1e-8)
        assert torch.equal(p.detach(), p0[k] - LR * u), k


def test_train_precision_bf16_step_matches_jax():
    """``train_precision = 'bf16'``: bf16 operands with f32 accumulation in
    the nets (the folded MinMax forward, the per-ray view term), params and
    optimizer in f32, in both packages. The bound is the JAX suite's own for
    its bf16 paths against each other, 0.02, on the loss relative to its
    size; and the step must differ from the f32 one (the path is taken)."""
    su = Setup()
    losses = {}
    for prec in ("bf16", "f32"):
        jcfg, tcfg = configs(train_precision=prec)
        jc, tc = controls(N_RAYS, 3)
        _, sampler_j = j_stage1.make_stage1_steps(jcfg, su.H, su.W, su.focal)
        _, jm = sampler_j(j_stage1.init_stage1_state(su.jparams_copy()),
                          *jax_inputs(su), jc, LR)
        _, sampler_t = t_stage1.make_stage1_steps(tcfg, su.H, su.W, su.focal)
        _, tm = sampler_t(t_stage1.init_stage1_state(su.tparams()),
                          *port_inputs(su), tc, LR)
        losses[prec] = (float(tm["loss"]), float(jm["loss"]))
    got, want = losses["bf16"]
    assert abs(got - want) <= 0.02 * want
    assert got != losses["f32"][0]
