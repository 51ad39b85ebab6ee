"""DoNeRF (``netarch = 'donerf'``) and ``sample_pdf`` in the port against the
JAX package, on the CPU: the skip grammar, ``init_donerf`` and
``donerf_apply``, a rendered frame, one step of each stage-1 kind, the
checkpoint reader (a JAX trainer's DoNeRF expdir read, served and resumed by
the port), and the inverse-CDF sampler with ``det=True``.

Small nets (DoNeRF 4 x 32, the view features entering at layer 4 * 7 // 8 =
3; sampler and refine 2 x 32). Weights come from the JAX initialiser through
``convert`` wherever the two are compared.

Tolerances: f32 ``atol 1e-5`` on the MLP (the same products, summed in
another order), the render bounds of tests/test_torch_render.py (f32 5e-5,
depth 5e-4, disp 1e-3; bf16 0.02) but 2e-4 on the f32 sigma logits: the
Kaiming weights (std sqrt(2 / fan_in), against the NeRF MLP's uniform
1 / sqrt(fan_in)) carry the top PE frequency's last-bit difference (about
3e-5 in sin(2^9 x), tests/test_torch_ops.py) into logits of size ~1 with a
larger gain (measured: 5.1e-5 at one of 2,560 elements). For a step the
bounds of
tests/test_torch_train_steps.py (loss 1e-6 relative, moments by
``torch_train_common.assert_trees_close``). ``sample_pdf``: ``atol 1e-5``
(linspace and cumsum round alike up to the last bit).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pronerf_tpu.models import RenderStatics as JStatics
from pronerf_tpu.models import donerf as j_donerf
from pronerf_tpu.models import init_pronerf_params as j_init
from pronerf_tpu.models import render_rays as j_render_rays
from pronerf_tpu.ops import sampling as j_sampling
from pronerf_tpu.render import prepare_scene as j_prepare_scene
from pronerf_tpu.render.raygen import rays_for_pose as j_rays_for_pose
from pronerf_tpu.train import checkpoint as j_ckpt
from pronerf_tpu.train import stage1 as j_stage1
from pronerf_tpu.utils.synthetic import make_scene
from pronerf_tpu_torch import convert
from pronerf_tpu_torch.models import donerf as t_donerf
from pronerf_tpu_torch.models.pronerf import (
    RenderStatics,
    init_pronerf_params,
    render_rays,
)
from pronerf_tpu_torch.ops import sampling as t_sampling
from pronerf_tpu_torch.train import checkpoint as t_ckpt
from pronerf_tpu_torch.train import stage1 as t_stage1
from pronerf_tpu_torch.train.state import named_params
from torch_train_common import (
    N_RAYS,
    T,
    as_numpy,
    assert_trees_close,
    configs,
    controls,
    named_numpy,
)

torch.set_num_threads(2)

NETS = dict(netarch="donerf", netdepth=4, netwidth=32, mmnetdepth=2,
            mmnetwidth=32)
KEYS = ("rgb0", "rgb1", "depth", "disp", "acc", "weights", "mm_rgb",
        "depth0", "sigma")


@pytest.mark.parametrize("skip", ["0::63-7:63:", "", "0::63-4:5-6:63:90",
                                  "3", "2:7", "5:10:", "1::12"])
def test_skip_grammar_matches_jax(skip):
    assert t_donerf.parse_skip_grammar(skip, 90) == \
        j_donerf.parse_skip_grammar(skip, 90)


def test_auto_skip_and_bad_entries():
    for D in (4, 8, 16):
        assert t_donerf.auto_skip(D) == j_donerf.auto_skip(D)
        assert t_donerf.parse_skip_grammar(t_donerf.auto_skip(D), 90) == {
            0: (0, 63), D * 7 // 8: (63, 90)}
    for bad in ("a:1", "1:2:3:4", "0::63-x"):
        with pytest.raises(ValueError, match="bad skip entry"):
            t_donerf.parse_skip_grammar(bad, 90)
        with pytest.raises(ValueError, match="bad skip entry"):
            j_donerf.parse_skip_grammar(bad, 90)


def test_init_donerf_is_kaiming_normal_with_jax_shapes():
    net = t_donerf.init_donerf(torch.Generator().manual_seed(0), D=8, W=256)
    jnet = j_donerf.init_donerf(jax.random.PRNGKey(0), D=8, W=256)
    assert len(net.layers) == len(jnet["layers"]) == 8 and net.skip == 7
    for lin, p in zip(net.layers, jnet["layers"]):
        assert tuple(lin.weight.shape) == tuple(np.asarray(p["w"]).T.shape)
        assert not lin.bias.any()
        fan_in = lin.weight.shape[1]
        std = float(lin.weight.std())
        # N(0, 2 / fan_in): the sample std of >= 1,024 draws within 10%
        assert abs(std / (2.0 / fan_in) ** 0.5 - 1) < 0.1, (fan_in, std)
    again = t_donerf.init_donerf(torch.Generator().manual_seed(0), D=8, W=256)
    assert all(torch.equal(a.weight, b.weight)
               for a, b in zip(net.layers, again.layers))


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_donerf_apply_matches_jax(compute_dtype):
    jnet = j_donerf.init_donerf(jax.random.PRNGKey(1), D=4, W=32)
    net = convert.donerf_from_numpy(as_numpy(jnet))
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (7, 5, 63)).astype(np.float32)
    d = rng.uniform(-1, 1, (7, 5, 27)).astype(np.float32)
    cdt = None if compute_dtype is None else torch.bfloat16
    with torch.no_grad():
        got = t_donerf.donerf_apply(net, T(x), T(d), compute_dtype=cdt)
    want = j_donerf.donerf_apply(
        jnet, jnp.asarray(x), jnp.asarray(d),
        compute_dtype=None if compute_dtype is None else jnp.bfloat16)
    assert got.shape == (7, 5, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5 if cdt is None else 0.02)


def test_donerf_from_numpy_rejects_a_skip_elsewhere():
    jnet = as_numpy(j_donerf.init_donerf(jax.random.PRNGKey(1), D=8, W=32,
                                         skip_layer=4))
    with pytest.raises(ValueError, match="layer 7"):
        convert.donerf_from_numpy(jnet)


@pytest.fixture(scope="module")
def frame():
    H, W, ref = 16, 20, [0, 2, 3, 4]
    sc = make_scene(n_views=5, H=H, W=W, seed=0)
    pose = sc["poses"][1]
    jparams = j_init(jax.random.PRNGKey(0), **NETS)
    return {
        "jparams": jparams,
        "params": convert.params_from_numpy(as_numpy(jparams)),
        "jscene": j_prepare_scene(sc["images"][ref], sc["poses"][ref],
                                  sc["K"]),
        "scene": convert.scene_from_numpy(sc["images"][ref],
                                          sc["poses"][ref], sc["K"]),
        "jrays": j_rays_for_pose(H, W, sc["K"], pose),
        "jcontrols": {"rng": jax.random.PRNGKey(0),
                      "target_t": jnp.asarray(pose[:3, 3])},
        "controls": {"target_t": T(pose[:3, 3])},
    }


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_donerf_frame_matches_jax(frame, compute_dtype):
    assert isinstance(frame["params"]["nerf"], t_donerf.DoNeRFMLP)
    kw = dict(compute_dtype=compute_dtype, netarch="donerf")
    want = j_render_rays(frame["jparams"], frame["jrays"], frame["jscene"],
                         frame["jcontrols"], JStatics.infer(**kw))
    with torch.no_grad():
        got = render_rays(frame["params"],
                          {k: T(v) for k, v in frame["jrays"].items()},
                          frame["scene"], frame["controls"],
                          RenderStatics.infer(**kw))
    for k in KEYS:
        g, w = got[k].numpy(), np.asarray(want[k], np.float32)
        assert g.shape == w.shape, k
        if compute_dtype is None:
            atol = {"depth": 5e-4, "disp": 1e-3, "sigma": 2e-4}.get(k, 5e-5)
        elif k == "disp":
            rel = np.abs(g - w) / np.abs(w)
            assert np.mean(rel <= 0.05) >= 0.98
            continue
        else:
            atol = 0.05 if k == "sigma" else 0.02
        np.testing.assert_allclose(g, w, atol=atol, err_msg=k)
    # the fused kernels implement the NeRF MLP, not DoNeRF
    with pytest.raises(ValueError, match="donerf"):
        render_rays(frame["params"], {}, frame["scene"], frame["controls"],
                    RenderStatics.infer(use_kernels=True, **kw))


@pytest.mark.parametrize("kind", ["nerf", "sampler"])
def test_donerf_stage1_step_matches_jax(kind):
    sc = make_scene(n_views=6, H=18, W=24, seed=0)
    H, W, focal = sc["hwf"]
    from pronerf_tpu_torch.render.raygen import build_ray_pool, prepare_scene

    pool, ids = build_ray_pool(sc["images"], sc["poses"], sc["K"],
                               list(range(6)), 4, np.random.default_rng(0))
    batch, ids = pool[:N_RAYS], ids[:N_RAYS]
    jscene = j_prepare_scene(sc["images"], sc["poses"], sc["K"])
    tscene = prepare_scene(sc["images"], sc["poses"], sc["K"], device="cpu")
    jparams = j_init(jax.random.PRNGKey(0), **NETS)
    np_params = as_numpy(jparams)  # the JAX step donates its state
    tparams = convert.params_from_numpy(np_params)
    jcfg, tcfg = configs(**NETS)
    jc, tc = controls(N_RAYS, 3, True, False)
    lr = 5e-4
    j_steps = j_stage1.make_stage1_steps(jcfg, H, W, focal)
    t_steps = t_stage1.make_stage1_steps(tcfg, H, W, focal)
    pick = 0 if kind == "nerf" else 1
    jstate, jm = j_steps[pick](j_stage1.init_stage1_state(jparams), jscene,
                               jnp.asarray(batch), jnp.asarray(ids), jc, lr)
    tstate, tm = t_steps[pick](t_stage1.init_stage1_state(tparams), tscene,
                               T(batch), T(ids), tc, lr)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        1e-6 * float(jm["loss"])
    opt = "opt_nerf" if kind == "nerf" else "opt_s"
    adam = jstate[opt][-1] if type(jstate[opt]) is tuple else jstate[opt]
    if kind == "nerf":
        full = {"nerf": adam.mu, "sampler": np_params["sampler"],
                "refine": np_params["refine"]}
        mu = {k: v for k, v in named_numpy(full).items()
              if k.startswith("nerf.")}
    else:
        mu = named_numpy(adam.mu)
    assert_trees_close(tstate[opt]["mu"], mu, "mu")
    assert any(k.startswith("nerf.layers.3.") for k in mu)


def test_donerf_checkpoint_reader_and_resume(tmp_path):
    """A JAX trainer's DoNeRF expdir: the port reads its nets and moments,
    serves it, and resumes it."""
    from pronerf_tpu import config as j_config
    from pronerf_tpu.train.loop import run_training as j_run_training
    from pronerf_tpu_torch.config import Config
    from pronerf_tpu_torch.render.infer import load_params_for_inference
    from pronerf_tpu_torch.train.loop import run_training

    kw = dict(datadir="synthetic:24x18x9", N_rand=64, i_print=1,
              i_weights=1000, i_img=0, i_testset=0, i_video=0, tile_rays=0,
              basedir=str(tmp_path), expname="d1", weight_decay=0.0, **NETS)
    path = "configs/llff/fern/fern_epi.txt"
    _, exp = j_run_training(j_config.Config.from_file(path, max_steps=2,
                                                      **kw), 1)
    ckpt = j_ckpt.latest_checkpoint(exp)
    raw = j_ckpt.load_checkpoint(ckpt)
    ck = t_ckpt.load_checkpoint(ckpt)
    want = convert.donerf_from_numpy(as_numpy(raw["network_fn"]))
    assert set(ck["network_fn"]) == set(want.state_dict())
    for k, v in want.state_dict().items():
        assert torch.equal(ck["network_fn"][k], v), k
    mu = ck["optimizer"]["mu"]
    assert "nerf.layers.3.weight" in mu and ck["optimizer"]["count"] == 1
    cfg = Config.from_file(path, **kw)
    params = load_params_for_inference(ckpt, cfg, "cpu")
    assert isinstance(params["nerf"], t_donerf.DoNeRFMLP)
    for k, v in want.state_dict().items():
        assert torch.equal(params["nerf"].state_dict()[k], v), k
    state, _ = run_training(cfg.replace(max_steps=1), 1, device="cpu")
    assert state["global_step"] == 3


def test_sample_pdf_det_matches_jax_and_draws_stay_in_the_bins():
    rng = np.random.default_rng(5)
    bins = np.sort(rng.random((12, 9)), axis=-1).astype(np.float32)
    weights = rng.random((12, 8)).astype(np.float32)
    weights[0] = 0.0  # an all-zero ray: the 1e-5 floor makes it uniform
    got = t_sampling.sample_pdf(T(bins), T(weights), 16, det=True)
    want = j_sampling.sample_pdf(jax.random.PRNGKey(0), jnp.asarray(bins),
                                 jnp.asarray(weights), 16, det=True)
    assert got.shape == (12, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    draws = t_sampling.sample_pdf(T(bins), T(weights), 64,
                                  generator=torch.Generator().manual_seed(1))
    assert torch.all(draws >= T(bins[:, :1]) - 1e-6)
    assert torch.all(draws <= T(bins[:, -1:]) + 1e-6)
    again = t_sampling.sample_pdf(T(bins), T(weights), 64,
                                  generator=torch.Generator().manual_seed(1))
    assert torch.equal(draws, again)
