"""Shared fixtures of the training tests of the port (``test_torch_train*``):
one small scene, small nets, a ray batch and the step's controls, made once
with numpy / the JAX package and handed to both packages.

Sizes: a 6-view 24x18 synthetic scene; NeRF 3 x 64 (the skip at 4 is never
reached), sampler and refine 2 x 32; 64 rays; 8 samples, 4 neighbours, 48
signature points, as the release configs.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from pronerf_tpu import config as j_config
from pronerf_tpu.models import init_pronerf_params as j_init
from pronerf_tpu.render import prepare_scene as j_prepare_scene
from pronerf_tpu.utils.synthetic import make_scene
from pronerf_tpu_torch import config as t_config
from pronerf_tpu_torch import convert
from pronerf_tpu_torch.render.raygen import build_ray_pool
from pronerf_tpu_torch.render.raygen import prepare_scene as t_prepare_scene

H, W, VIEWS, N_RAYS = 18, 24, 6, 64
NETS = dict(netdepth=3, netwidth=64, mmnetdepth=2, mmnetwidth=32)


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def T(a):
    return torch.from_numpy(np.array(a))


def configs(**kw):
    """The JAX package's Config and the port's, with the same fields."""
    jcfg = j_config.Config(N_samples=8, N_point_ray_enc=48, num_neighbor=4,
                           raw_noise_std=1.0, N_rand=N_RAYS, **NETS)
    jcfg = dataclasses.replace(jcfg, **kw)
    return jcfg, t_config.Config(**dataclasses.asdict(jcfg))


_SETUPS = {}


def Setup(pack="u8", seed=0):
    """The fixture of one image form, made once a process."""
    if (pack, seed) not in _SETUPS:
        _SETUPS[pack, seed] = _Setup(pack, seed)
    return _SETUPS[pack, seed]


class _Setup:
    """Scene (both packages, one image form), params (JAX init, carried
    across), and a batch of the ray pool (the default form, native where
    the host runtime's library loads, as the JAX trainer's; equal to the
    JAX package's bit for bit, tests/test_torch_native.py)."""

    def __init__(self, pack, seed):
        sc = make_scene(n_views=VIEWS, H=H, W=W, seed=seed)
        self.sc = sc
        self.H, self.W, self.focal = sc["hwf"]
        self.jscene = j_prepare_scene(sc["images"], sc["poses"], sc["K"],
                                      pack_corners=pack)
        self.tscene = t_prepare_scene(sc["images"], sc["poses"], sc["K"],
                                      pack_corners=pack, device="cpu")
        self.jparams = j_init(jax.random.PRNGKey(seed), **NETS)
        pool, ids = build_ray_pool(sc["images"], sc["poses"], sc["K"],
                                   list(range(VIEWS)), 4,
                                   np.random.default_rng(seed))
        self.batch, self.ids = pool[:N_RAYS], ids[:N_RAYS]

    def jparams_copy(self):
        """A copy of the JAX params (the JAX steps donate their state)."""
        return jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True),
                                      self.jparams)

    def tparams(self):
        """A fresh copy of the params as the port's modules."""
        return convert.params_from_numpy(as_numpy(self.jparams))


def controls(n_rays, n_mult=3, dir_expand=True, dir_jitter=False,
             subset=(0, 2, 3, 4), width=64, key=7):
    """(JAX controls, port controls) of one step: the same host choices, and
    JAX's own draws of the noise (``noise_key, jitter_key =
    split(rng)``, then N(0, 1) at ``[n_rays, width]``: 64 in stage 1, S in
    stage 2) handed to both."""
    rng = jax.random.PRNGKey(key)
    nk, jk = jax.random.split(rng)
    raw = np.asarray(jax.random.normal(nk, (n_rays, width), jnp.float32))
    jit = np.asarray(jax.random.normal(jk, (n_rays, width), jnp.float32))
    jc = {
        "rng": rng, "n_mult": jnp.int32(n_mult),
        "dir_expand": jnp.asarray(dir_expand),
        "dir_jitter": jnp.asarray(dir_jitter),
        "neighbor_subset": jnp.asarray(subset, jnp.int32),
        "target_t": jnp.zeros((3,), jnp.float32),
        "raw_noise": jnp.asarray(raw), "jitter_noise": jnp.asarray(jit),
    }
    tc = {
        "rng": None, "n_mult": n_mult, "dir_expand": dir_expand,
        "dir_jitter": dir_jitter,
        "neighbor_subset": torch.tensor(subset, dtype=torch.int64),
        "target_t": torch.zeros(3), "raw_noise": T(raw),
        "jitter_noise": T(jit),
    }
    return jc, tc


def named_numpy(tree):
    """A JAX params-shaped tree (params, grads, moments) in the port's names
    and layout: ``{'<net>.<parameter>': numpy}``."""
    mods = convert.params_from_numpy(as_numpy(tree))
    return {f"{net}.{k}": v.detach().numpy()
            for net, m in mods.items() for k, v in m.named_parameters()}


# Gradients (and the Adam moments made of them) of one step, port against
# JAX, each tensor relative to its size: f32 rounding alone keeps them within
# 2e-5 (measured: 2e-6 to 2e-5). But a NeRF pre-activation or a composite
# input that lies within the last bits of a ReLU kink passes gradient in one
# evaluation and not in the other; one such point shifts one row of a
# weight and, through its backward, the layers below it. With the
# exploration step's 1,500 to 4,000 points a ray batch, measured over 32
# control sets of the NeRF step: 7 with such a flip, the largest moving a
# tensor by 2.8e-3 in norm and 3.9e-3 at an element (the port against a
# float64 evaluation shows the same events). The bound: 5e-3 in norm and
# 1e-2 at any element. A wrong detach, draw or layer moves the gradients by
# their own size.
GRAD_NORM_REL, GRAD_MAX_REL = 5e-3, 1e-2


def assert_trees_close(got: dict, want: dict, what: str, power: int = 1):
    """Every tensor of ``got`` against its counterpart in ``want``, relative
    to that one's size: within ``GRAD_NORM_REL`` in norm and
    ``GRAD_MAX_REL`` at any element (``power`` times both, for a tree of
    squares such as Adam's nu)."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, w in want.items():
        g = got[k].detach().numpy() if torch.is_tensor(got[k]) else got[k]
        assert g.shape == w.shape, (what, k)
        d = np.abs(g - w)
        norm = float(np.linalg.norm(d) / np.linalg.norm(w))
        top = float(d.max() / np.abs(w).max())
        assert norm <= power * GRAD_NORM_REL and top <= power * GRAD_MAX_REL, \
            (what, k, norm, top)
