"""``render_rays`` under the three training statics against the JAX
package's, on the CPU: the outputs, the stage's loss and its gradient with
respect to every parameter it trains (``jax.value_and_grad`` on the JAX
side, torch autograd here), on the same params, rays, controls and the
noise JAX itself draws (``torch_train_common.controls``).

Tolerances. Outputs: the f32 bounds of ``tests/test_torch_render.py`` for
the same comparison on the serving path (``5e-5``, depth ``5e-4``, disp
``1e-3``; measured here: 4e-6 at most, disp 7e-6). Loss: ``1e-6``
relative. Gradients: ``torch_train_common.GRAD_NORM_REL`` /
``GRAD_MAX_REL`` (the reason, with what was measured, stands there).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pronerf_tpu.models.pronerf import RenderStatics as JStatics
from pronerf_tpu.models.pronerf import render_rays as j_render_rays
from pronerf_tpu.ops.metrics import img2mse as j_mse
from pronerf_tpu.render.raygen import rays_from_pool as j_rays_from_pool
from pronerf_tpu_torch.models.pronerf import RenderStatics, render_rays
from pronerf_tpu_torch.ops.metrics import img2mse
from pronerf_tpu_torch.render.raygen import rays_from_pool
from pronerf_tpu_torch.train.state import named_params
from torch_train_common import (
    N_RAYS,
    Setup,
    T,
    assert_trees_close,
    controls,
    named_numpy,
)

torch.set_num_threads(2)

NETS = {"stage1_nerf": ["nerf"], "stage1_sampler": None, "stage2": None}
WIDTH = {"stage1_nerf": 64, "stage1_sampler": 64, "stage2": 8}
KW = dict(N_samples=8, N_point_ray_enc=48, num_neighbor=4)
OUT_ATOL = {"depth": 5e-4, "disp": 1e-3}
CASES = [
    ("stage1_nerf", 1, True, False),
    ("stage1_nerf", 3, False, True),
    ("stage1_nerf", 8, True, True),
    ("stage1_sampler", 3, True, False),
    ("stage2", 3, True, False),
    ("stage2", 5, False, True),
]


def losses(out, target, stage, mse):
    loss = mse(out["rgb1"], target)
    if stage != "stage1_nerf":  # stage 2 with a_mmrgb = 1: every net
        loss = loss + mse(out["rgb0"], target) + mse(out["mm_rgb"], target)
    return loss


def port_grads(su, stage, tc):
    params = su.tparams()
    rays = rays_from_pool(T(su.batch[:, :2]), T(su.ids), su.H, su.W,
                          su.focal)
    out = render_rays(params, rays, su.tscene, tc,
                      getattr(RenderStatics, stage)(**KW))
    loss = losses(out, T(su.batch[:, 2]), stage, img2mse)
    named = named_params(params, NETS[stage])
    grads = torch.autograd.grad(loss, list(named.values()))
    return out, loss, dict(zip(named, grads))


@pytest.mark.parametrize("stage,n_mult,dir_expand,dir_jitter", CASES)
def test_render_rays_and_gradients_match_jax(stage, n_mult, dir_expand,
                                             dir_jitter):
    su = Setup()
    jc, tc = controls(N_RAYS, n_mult, dir_expand, dir_jitter,
                      width=WIDTH[stage])
    jrays = j_rays_from_pool(jnp.asarray(su.batch[:, :2]), jnp.asarray(su.ids),
                             su.H, su.W, su.focal)
    jstatics = getattr(JStatics, stage)(**KW)
    target = jnp.asarray(su.batch[:, 2])

    def jloss(p):
        out = j_render_rays(p, jrays, su.jscene, jc, jstatics)
        return losses(out, target, stage, j_mse), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        su.jparams)
    out, loss, grads = port_grads(su, stage, tc)

    assert set(out) == set(jout)
    for k, v in out.items():
        want = np.asarray(jout[k])
        assert v.shape == want.shape, k
        np.testing.assert_allclose(v.detach().numpy(), want,
                                   atol=OUT_ATOL.get(k, 5e-5), err_msg=k)
    assert abs(float(loss.detach()) - float(jl)) <= 1e-6 * float(jl)
    want_g = named_numpy(jg)
    if NETS[stage]:
        # the frozen nets get no gradient in JAX either
        assert all(not np.any(v) for k, v in want_g.items()
                   if not k.startswith("nerf."))
        want_g = {k: v for k, v in want_g.items() if k.startswith("nerf.")}
    assert_trees_close(grads, want_g, "grads against JAX")


def test_frozen_nets_keep_no_graph_in_the_nerf_step():
    """stop_sampler_grad: the sampler and refine nets run under no_grad, so
    the NeRF step neither differentiates nor keeps activations for them."""
    su = Setup()
    _, tc = controls(N_RAYS, 2)
    params = su.tparams()
    rays = rays_from_pool(T(su.batch[:, :2]), T(su.ids), su.H, su.W, su.focal)
    out = render_rays(params, rays, su.tscene, tc,
                      RenderStatics.stage1_nerf(**KW))
    assert not out["mm_rgb"].requires_grad and not out["rgb0"].requires_grad
    assert out["rgb1"].requires_grad and not out["depth0"].requires_grad
    with pytest.raises(RuntimeError):
        torch.autograd.grad(out["rgb1"].sum(),
                            list(params["sampler"].parameters()))


def test_draws_come_from_the_generator_when_not_given():
    """Without pre-drawn noise, stage 2 draws jitter and sigma noise from
    ``controls['rng']``: the same seed gives the same render, another seed
    another one."""
    su = Setup()
    _, tc = controls(N_RAYS, 2, dir_jitter=True, width=8)
    del tc["raw_noise"], tc["jitter_noise"]
    params = su.tparams()
    rays = rays_from_pool(T(su.batch[:, :2]), T(su.ids), su.H, su.W, su.focal)
    statics = RenderStatics.stage2(**KW)

    def render(seed):
        ctl = dict(tc, rng=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return render_rays(params, rays, su.tscene, ctl, statics)["rgb1"]

    assert torch.equal(render(1), render(1))
    assert not torch.equal(render(1), render(2))
