"""The port's MLP modules against the JAX package's forwards, on the CPU.

Weights come from the JAX initialiser and cross as numpy through
``convert``; inputs are made with numpy from a seed.

Tolerances. f32: ``atol 2e-5`` (the JAX package's own bound for the same
nets against its kernels): both sides do f32 sums of at most 319 terms in
another order. bf16: both sides round every dot to bfloat16, but a sum taken
in another order can fall on the other side of a rounding boundary, one unit
in the last place = 2^-8 relative, and the next layers carry it on; on
outputs of size ~1 after 8 to 12 layers a few such units, ``atol 0.03``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pronerf_tpu.models import mlp as j_mlp
from pronerf_tpu_torch import convert
from pronerf_tpu_torch.models import mlp as t_mlp

# The suite runs several workers side by side; two threads a worker keep
# PyTorch's CPU kernels from crowding the other workers' tests.
torch.set_num_threads(2)

F32_ATOL = 2e-5
BF16_ATOL = 0.03


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def T(a):
    return torch.from_numpy(np.array(a))


def nerf_inputs(n=40, S=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, S, 63)).astype(np.float32),
            rng.uniform(-1, 1, (n, 27)).astype(np.float32))


def test_convert_stores_weights_out_by_in():
    jp = j_mlp.init_nerf_mlp(jax.random.PRNGKey(0))
    net = convert.nerf_from_numpy(as_numpy(jp))
    assert net.skips == (4,)
    assert tuple(net.pts[5].weight.shape) == (256, 63 + 256)
    np.testing.assert_array_equal(
        net.views.weight.detach().numpy(), np.asarray(jp["views"]["w"]).T)
    np.testing.assert_array_equal(
        net.rgb.bias.detach().numpy(), np.asarray(jp["rgb"]["b"]))
    assert sum(p.numel() for p in net.parameters()) == j_mlp.count_params(jp)
    mp = j_mlp.init_minmax_mlp(jax.random.PRNGKey(1), 6, 256, 40, 11, (2,))
    mm = convert.minmax_from_numpy(as_numpy(mp))
    assert mm.skips == (2,) and mm.layers[3].weight.shape == (256, 296)


def test_init_matches_the_linear_bound_and_the_generator():
    a = t_mlp.NeRFMLP(generator=torch.Generator().manual_seed(3))
    b = t_mlp.NeRFMLP(generator=torch.Generator().manual_seed(3))
    c = t_mlp.NeRFMLP(generator=torch.Generator().manual_seed(4))
    assert torch.equal(a.pts[5].weight, b.pts[5].weight)
    assert not torch.equal(a.pts[5].weight, c.pts[5].weight)
    for lin in (a.pts[0], a.pts[5], a.views, a.rgb):
        bound = 1.0 / lin.weight.shape[1] ** 0.5
        assert lin.weight.abs().max() <= bound and lin.bias.abs().max() <= bound
        assert lin.weight.abs().max() > 0.9 * bound


@pytest.mark.parametrize("per_ray_dirs", [False, True])
def test_nerf_mlp_f32(per_ray_dirs):
    """f32 module against ``nerf_mlp_apply``. With ``per_ray_dirs`` the port's
    serving forward runs in f32 (split dots, per-ray view term) and must
    still equal the plain concatenating forward."""
    jp = j_mlp.init_nerf_mlp(jax.random.PRNGKey(0))
    net = convert.nerf_from_numpy(as_numpy(jp))
    x, d = nerf_inputs()
    want = j_mlp.nerf_mlp_apply(
        jp, jnp.asarray(x),
        jnp.broadcast_to(jnp.asarray(d)[:, None, :], (*x.shape[:2], 27)))
    with torch.no_grad():
        if per_ray_dirs:
            got = net(T(x), T(d), torch.float32)
        else:
            got = net(T(x), T(d)[:, None, :].expand(-1, x.shape[1], -1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


def test_nerf_mlp_bf16_serving():
    jp = j_mlp.init_nerf_mlp(jax.random.PRNGKey(2))
    net = convert.nerf_from_numpy(as_numpy(jp))
    x, d = nerf_inputs(seed=1)
    want = j_mlp.nerf_mlp_apply(jp, jnp.asarray(x), jnp.asarray(d), (4,),
                                jnp.bfloat16)
    with torch.no_grad():
        got = net(T(x), T(d), torch.bfloat16)
    assert got.dtype == torch.float32 and got.shape == (40, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BF16_ATOL)


@pytest.mark.parametrize("skips", [(), (2,)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_minmax_mlp(dtype, skips):
    jp = j_mlp.init_minmax_mlp(jax.random.PRNGKey(3), 6, 256, 144, 35, skips)
    net = convert.minmax_from_numpy(as_numpy(jp))
    x = np.random.default_rng(2).normal(size=(50, 144)).astype(np.float32)
    jdt, tdt, atol = ((None, None, F32_ATOL) if dtype == "f32"
                      else (jnp.bfloat16, torch.bfloat16, BF16_ATOL))
    want = j_mlp.minmax_mlp_apply(jp, jnp.asarray(x), skips, jdt)
    with torch.no_grad():
        got = net(T(x), tdt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


@pytest.mark.parametrize("reps,rest,out_w", [(48, 0, 27), (8, 96, 35)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_minmax_folded(dtype, reps, rest, out_w):
    """The folded forward against the JAX folded forward, and (f32) against
    the unfolded module on the tiled input it stands for."""
    jp = j_mlp.init_minmax_mlp(jax.random.PRNGKey(4), 6, 256, 6 * reps + rest,
                               out_w)
    net = convert.minmax_from_numpy(as_numpy(jp))
    rng = np.random.default_rng(3)
    x_rep = rng.normal(size=(60, 6)).astype(np.float32)
    x_rest = rng.random((60, rest)).astype(np.float32) if rest else None
    jdt, tdt, atol = ((jnp.float32, torch.float32, F32_ATOL) if dtype == "f32"
                      else (jnp.bfloat16, torch.bfloat16, BF16_ATOL))
    want = j_mlp.minmax_mlp_apply_folded(
        jp, jnp.asarray(x_rep), reps,
        None if x_rest is None else jnp.asarray(x_rest), jdt)
    with torch.no_grad():
        got = t_mlp.minmax_mlp_apply_folded(
            net, T(x_rep), reps, None if x_rest is None else T(x_rest), tdt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
        if dtype == "f32":
            tiled = np.tile(x_rep, (1, reps))
            if x_rest is not None:
                tiled = np.concatenate([tiled, x_rest], axis=1)
            np.testing.assert_allclose(
                got.numpy(), net(T(tiled)).numpy(), atol=F32_ATOL)
