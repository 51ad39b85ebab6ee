"""The port's transposed serving graph (``models/pronerf_t.py``, the
transposed gathers of ``ops/warp.py``) and its int8 serving path, against the
JAX package and against the port's own row-major graph, on the CPU.

The port's kernels run as their plain versions (CPU tensors), the JAX
kernels in interpret mode. Weights come from the JAX initialiser through
``convert.params_from_numpy``; rays and scenes are made once and handed to
both as numpy. Renders use a HELD-OUT pose (pose 1 from source views 0, 2,
3, 4) for the reason given in ``test_torch_render.py``.

Tolerances. Gathers and mean fills against JAX: ``atol 1e-6`` (the JAX
tests' bound); against the port's row-major gather on the same projections:
equal bit for bit. ``render_rays_t`` against JAX's: the f32 and bf16 bounds
of ``test_torch_render.py`` (``5e-5`` / ``0.02``, ``depth 5e-4``, ``sigma
0.05`` in bf16, ``disp`` relative on 98% of the rays). Transposed frame
against the row-major frame: ``atol 2e-2``, the JAX test's bound. int8
render against JAX's int8 render on the same panels: the bf16 bounds (the
graphs up to the NeRF kernel are the bf16 ones, and the int8 chain adds code
flips of a few thousandths of the raw logits' spread); against the port's
bf16 kernel path: PSNR of ``rgb1`` above 32 dB and ``depth`` within 0.05,
the JAX test's bounds, and because freshly initialised nets give
near-transparent rays on which those two would pass a zero output, also
``sigma`` within a quarter of its spread.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pronerf_tpu.kernels import fused_nerf_q as j_fq
from pronerf_tpu.models import RenderStatics as JStatics
from pronerf_tpu.models import init_pronerf_params as j_init
from pronerf_tpu.models import pronerf_t as j_pt
from pronerf_tpu.models import render_rays as j_render_rays
from pronerf_tpu.ops import warp as j_warp
from pronerf_tpu.render import prepare_scene as j_prepare_scene
from pronerf_tpu.render.raygen import rays_for_pose as j_rays_for_pose
from pronerf_tpu.utils.synthetic import make_scene
from pronerf_tpu_torch import convert
from pronerf_tpu_torch.models import pronerf_t as t_pt
from pronerf_tpu_torch.models.pronerf import RenderStatics, render_rays
from pronerf_tpu_torch.ops import warp as t_warp
from pronerf_tpu_torch.ops.encoding import plucker
from pronerf_tpu_torch.ops.sampling import bin_constrain
from pronerf_tpu_torch.render.renderer import make_frame_renderer

# The suite runs several workers side by side; two threads a worker keep
# PyTorch's CPU kernels from crowding the other workers' tests.
torch.set_num_threads(2)

KEYS = ("rgb0", "rgb1", "depth", "disp", "acc", "weights", "mm_rgb",
        "depth0", "sigma")
H, W = 16, 20
REF = [0, 2, 3, 4]


def T(a):
    return torch.from_numpy(np.array(a))


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class Fixture:
    def __init__(self):
        sc = make_scene(n_views=5, H=H, W=W, seed=0)
        self.sc, self.pose = sc, sc["poses"][1]
        self.jscene = j_prepare_scene(sc["images"][REF], sc["poses"][REF],
                                      sc["K"])
        self.jparams = j_init(jax.random.PRNGKey(0))
        self.jrays = j_rays_for_pose(H, W, sc["K"], self.pose)
        self.jcontrols = {"rng": jax.random.PRNGKey(0),
                          "target_t": jnp.asarray(self.pose[:3, 3])}
        self.params = convert.params_from_numpy(as_numpy(self.jparams))
        self.scene = convert.scene_from_numpy(
            sc["images"][REF], sc["poses"][REF], sc["K"])
        self.rays = {k: T(v) for k, v in self.jrays.items()}
        self.controls = {"target_t": T(self.pose[:3, 3])}

    def port(self, fn, statics, params=None):
        with torch.no_grad():
            out = fn(params or self.params, self.rays, self.scene,
                     self.controls, statics)
        assert set(out) == set(KEYS)
        return {k: v.numpy() for k, v in out.items()}

    def jax(self, fn, statics, params=None):
        out = fn(params or self.jparams, self.jrays, self.jscene,
                 self.jcontrols, statics)
        assert set(out) == set(KEYS)
        return {k: np.asarray(v, np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def fx():
    return Fixture()


def gather_inputs(fx, n=64, s=8):
    rng = np.random.default_rng(0)
    or_o = np.asarray(fx.jrays["or_o"][:n])
    or_d = np.asarray(fx.jrays["or_d"][:n])
    z3d = np.sort(rng.uniform(1.0, 8.0, (n, s)).astype(np.float32), axis=1)
    return or_o, or_d, z3d, np.array([0, 2, 3, 1], np.int32)


def assert_close_nine(got, want, bf16):
    for k in KEYS:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
        if k == "disp" and bf16:
            # disp = acc / depth of a near-transparent ray jumps where bf16
            # noise moves one sample's relu(mm_mul) across zero (see
            # test_torch_render.py): at least 98% of the rays hold the bound
            rel = np.abs(got[k] - want[k]) / np.abs(want[k])
            assert np.all(np.isfinite(got[k])) and np.mean(rel <= 0.05) >= 0.98
        elif bf16:
            np.testing.assert_allclose(
                got[k], want[k], atol=0.05 if k == "sigma" else 0.02,
                err_msg=k)
        else:
            atol = {"depth": 5e-4, "disp": 1e-3}.get(k, 5e-5)
            np.testing.assert_allclose(got[k], want[k], atol=atol, err_msg=k)


# ---------------------------------------------------------------- gathers --

def test_epipolar_colors_shared_t_matches_jax(fx):
    or_o, or_d, z3d, view_ids = gather_inputs(fx)
    want = j_warp.epipolar_colors_shared_t(
        fx.jscene["images"], fx.jscene["fused_mats"], fx.jscene["K"],
        jnp.asarray(view_ids), jnp.asarray(or_o.T), jnp.asarray(or_d.T),
        jnp.asarray(z3d.T))
    got = t_warp.epipolar_colors_shared_t(
        fx.scene["images"], fx.scene["fused_mats"], fx.scene["K"],
        T(view_ids), T(or_o.T), T(or_d.T), T(z3d.T))
    assert got.shape == (4, 3, 8, 64) and got.dtype == torch.float32
    assert float(got.max()) > 0.1  # the scene is seen
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_epipolar_colors_shared_t_bit_equal_to_the_row_major_sampler(fx):
    """Given identical projections (the transposed graph's written-out
    formula, replicated row-major), the transposed gather / unpack / lerp
    equals the port's row-major u8 sampler bit for bit."""
    or_o, or_d, z3d, view_ids = (T(a) for a in gather_inputs(fx))
    scene = fx.scene
    K = scene["K"]
    pts = or_o[:, None, :] + or_d[:, None, :] * z3d[..., None]  # [N, S, 3]
    refs = []
    for v in view_ids:
        M = scene["fused_mats"][v]
        p = [M[i, 0] * pts[..., 0] + M[i, 1] * pts[..., 1]
             + M[i, 2] * pts[..., 2] + M[i, 3] for i in range(3)]
        z = torch.abs(p[2]) + 1e-8
        u = K[0, 0] * p[0] / z + K[0, 2]
        vv = K[1, 1] * p[1] / z + K[1, 2]
        xn, yn = 2.0 * u / (W - 1) - 1.0, 2.0 * vv / (H - 1) - 1.0
        # the written-out projection agrees with project_points to well
        # under a hundredth of a pixel
        xe, ye = t_warp.project_points(pts, M, K, H, W)
        assert float((xn - xe).abs().max()) < 2e-3
        assert float((yn - ye).abs().max()) < 2e-3
        refs.append(t_warp.bilinear_sample_packed_u8(
            scene["images"], v.expand(xn.shape), xn, yn))  # [N, S, 3]
    ref = torch.stack(refs, dim=1)  # [N, V, S, 3]
    got_t = t_warp.epipolar_colors_shared_t(
        scene["images"], scene["fused_mats"], K, view_ids,
        or_o.T.contiguous(), or_d.T.contiguous(), z3d.T.contiguous())
    assert torch.equal(got_t.permute(3, 0, 2, 1), ref)
    assert int((ref.sum(-1) > 0).sum()) > ref.shape[0]  # valid colours exist


def test_transposed_out_emit_matches_jax_and_the_default_form(fx):
    or_o, or_d, z3d, view_ids = gather_inputs(fx)
    want = j_warp.epipolar_colors_shared(
        fx.jscene["images"], fx.jscene["fused_mats"], fx.jscene["K"],
        jnp.asarray(view_ids), jnp.asarray(or_o), jnp.asarray(or_d),
        jnp.asarray(z3d), transposed_out=True)
    args = (fx.scene["images"], fx.scene["fused_mats"], fx.scene["K"],
            T(view_ids), T(or_o), T(or_d), T(z3d))
    got = t_warp.epipolar_colors_shared(*args, transposed_out=True)
    assert got.shape == (4, 24, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    rows = t_warp.epipolar_colors_shared(*args)  # [N, V, S, 3]
    assert torch.equal(got, rows.permute(1, 2, 3, 0).reshape(4, 24, 64))
    got_bf = t_warp.epipolar_colors_shared(
        *args, out_dtype=torch.bfloat16, transposed_out=True)
    assert got_bf.dtype == torch.bfloat16
    assert torch.equal(got_bf, got.to(torch.bfloat16))
    with pytest.raises(ValueError, match="u8"):
        t_warp.epipolar_colors_shared(
            torch.zeros(4, H, W, 3), *args[1:], transposed_out=True)


def invalid_colors(shape, seed=1):
    rng = np.random.default_rng(seed)
    colors = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    colors[rng.uniform(size=shape[:3]) < 0.3] = 0.0  # invalid warps
    return colors  # [N, V, S, 3]


def test_mean_fill_invalid_t_matches_jax_and_the_row_major_fill():
    colors = invalid_colors((37, 4, 8, 3))
    colors_t = colors.transpose(1, 3, 2, 0)  # [V, 3, S, N]
    got = t_warp.mean_fill_invalid_t(T(colors_t))
    want = j_warp.mean_fill_invalid_t(jnp.asarray(colors_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    rows = t_warp.mean_fill_invalid(T(colors))
    np.testing.assert_allclose(got.permute(3, 0, 2, 1).numpy(), rows.numpy(),
                               atol=1e-6)


def test_mean_fill_invalid_sct_matches_jax_and_the_row_major_fill():
    colors = invalid_colors((29, 4, 8, 3), seed=2)
    colors_t = colors.transpose(1, 2, 3, 0)  # [V, S, 3, N]
    got = t_warp.mean_fill_invalid_sct(T(colors_t))
    want = j_warp.mean_fill_invalid_sct(jnp.asarray(colors_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    rows = t_warp.mean_fill_invalid(T(colors))
    np.testing.assert_allclose(got.permute(3, 0, 1, 2).numpy(), rows.numpy(),
                               atol=1e-6)


def test_windowed_transposed_gather_raises_by_name(fx):
    """The windowed form of the transposed gather is ported: a covering
    window (7 ray tiles, H source rows) equals the unwindowed gather bit for
    bit and JAX's windowed gather; the transposed graph renders with
    windows on (tests/test_torch_gathers.py holds it against JAX with
    windows that miss). What raises by name is a scene that is not the u8
    corner pack."""
    or_o, or_d, z3d, view_ids = gather_inputs(fx, n=60)
    args = (fx.scene["images"], fx.scene["fused_mats"], fx.scene["K"],
            T(view_ids), T(or_o.T), T(or_d.T), T(z3d.T))
    got = t_warp.epipolar_colors_shared_t(*args, n_tiles=7, window_rows=H)
    assert torch.equal(got, t_warp.epipolar_colors_shared_t(*args))
    want = j_warp.epipolar_colors_shared_t(
        fx.jscene["images"], fx.jscene["fused_mats"], fx.jscene["K"],
        jnp.asarray(view_ids), jnp.asarray(or_o.T), jnp.asarray(or_d.T),
        jnp.asarray(z3d.T), n_tiles=7, window_rows=H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    statics = RenderStatics.infer(compute_dtype="bfloat16", use_kernels=True,
                                  transposed=True, gather_tiles=4,
                                  gather_window_rows=8)
    out = fx.port(t_pt.render_rays_t, statics)
    assert all(np.isfinite(v).all() for k, v in out.items() if k != "disp")
    with pytest.raises(ValueError, match="u8"):
        t_warp.epipolar_colors_shared_t(
            torch.zeros(4, H, W, 3), fx.scene["fused_mats"], fx.scene["K"],
            T(view_ids), T(or_o.T), T(or_d.T), T(z3d.T))


# ------------------------------------------------------ the small twins ----

def test_refine_rest_row_perm_equals_jax():
    for v, s in ((4, 8), (2, 4), (3, 5)):
        perm = t_pt.refine_rest_row_perm(v, s)
        assert perm == j_pt.refine_rest_row_perm(v, s)
        assert sorted(perm) == list(range(3 * v * s))


def test_plucker_t_and_bin_constrain_t_equal_their_row_major_twins(fx):
    o, d = fx.rays["ndc_o"][:50], fx.rays["ndc_d"][:50]
    got = t_pt._plucker_t(o.T.contiguous(), d.T.contiguous())
    np.testing.assert_allclose(got.T.numpy(), plucker(o, d).numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(j_pt._plucker_t(jnp.asarray(o.numpy().T),
                                   jnp.asarray(d.numpy().T))), atol=1e-6)
    rng = np.random.default_rng(3)
    depths = T(np.sort(rng.random((50, 8)).astype(np.float32), axis=1))
    sig = T(rng.random((50, 8)).astype(np.float32))
    assert torch.equal(
        t_pt._bin_constrain_t(depths.T.contiguous(), sig.T.contiguous(),
                              0.0, 1.0).T,
        bin_constrain(depths, sig, 0.0, 1.0))


def test_transposed_eligible_follows_jax(fx):
    base = dict(compute_dtype="bfloat16", transposed=True)
    for kw in (dict(), dict(epi_layout="svc"), dict(add_offsets=False),
               dict(clamp_raw=True), dict(mmnetskips=(2,)),
               dict(noise_std=1.0)):
        ts = dataclasses.replace(RenderStatics.infer(use_kernels=True, **base),
                                 **kw)
        js = dataclasses.replace(JStatics.infer(use_pallas=True, **base), **kw)
        assert t_pt.transposed_eligible(ts, fx.scene["images"]) == \
            j_pt.transposed_eligible(js, fx.jscene["images"]), kw
    ok = RenderStatics.infer(use_kernels=True, **base)
    assert t_pt.transposed_eligible(ok, fx.scene["images"])
    assert not t_pt.transposed_eligible(
        RenderStatics.infer(use_kernels=False, **base), fx.scene["images"])
    assert not t_pt.transposed_eligible(ok, torch.zeros(4, H, W, 3))
    with pytest.raises(ValueError, match="transposed_eligible"):
        fx.port(t_pt.render_rays_t, RenderStatics.infer(use_kernels=False))


# ----------------------------------------------------- the graph as a whole --

@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_render_rays_t_against_jax_all_keys(fx, dtype):
    want = fx.jax(j_pt.render_rays_t, JStatics.infer(
        compute_dtype=dtype, use_pallas=True, transposed=True,
        pallas_block_rays=128))
    got = fx.port(t_pt.render_rays_t, RenderStatics.infer(
        compute_dtype=dtype, use_kernels=True, transposed=True))
    assert_close_nine(got, want, bf16=dtype is not None)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_render_rays_t_matches_the_ports_row_major_graph(fx, dtype):
    """The JAX test's bulk and tail bounds between the two graphs."""
    statics = RenderStatics.infer(compute_dtype=dtype, use_kernels=True,
                                  transposed=True, fuse_composite=True)
    ref = fx.port(render_rays, statics)
    got = fx.port(t_pt.render_rays_t, statics)
    bulk, tail = (2e-2, 5e-2) if dtype == "bfloat16" else (2e-3, 5e-3)
    for k in ("rgb1", "rgb0", "mm_rgb", "depth", "acc", "depth0"):
        diff = np.abs(got[k] - ref[k])
        assert np.percentile(diff, 99) < bulk, (k, np.percentile(diff, 99))
        assert (diff > tail).mean() < 0.01, (k, diff.max())
    # near-transparent rays: the relative size matters too
    assert np.abs(got["sigma"] - ref["sigma"]).max() < 0.25 * ref["sigma"].std()


def test_transposed_emit_in_render_rays_changes_nothing(fx):
    """``gather_transposed=1`` hands the refine kernel the same rows, so all
    nine outputs are equal; against JAX's the bf16 bounds hold."""
    statics = RenderStatics.infer(compute_dtype="bfloat16", use_kernels=True)
    base = fx.port(render_rays, statics)
    emit = fx.port(render_rays,
                   dataclasses.replace(statics, gather_transposed=1))
    for k in KEYS:
        np.testing.assert_array_equal(emit[k], base[k], err_msg=k)
    svc = dataclasses.replace(statics, epi_layout="svc")
    a = fx.port(render_rays, svc)
    b = fx.port(render_rays, dataclasses.replace(svc, gather_transposed=1))
    for k in KEYS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    want = fx.jax(j_render_rays, JStatics.infer(
        compute_dtype="bfloat16", use_pallas=True, pallas_block_rays=128,
        gather_transposed=1))
    assert_close_nine(emit, want, bf16=True)


def test_frame_renderer_transposed_against_row_major_and_jax(fx):
    from pronerf_tpu.render.renderer import make_frame_renderer as j_make

    kw = dict(compute_dtype="bfloat16", use_kernels=True)
    rows = make_frame_renderer(RenderStatics.infer(**kw), H, W, fx.sc["K"], 0,
                               device="cpu")(fx.params, fx.scene, fx.pose)
    statics_t = RenderStatics.infer(transposed=True, **kw)
    whole = make_frame_renderer(statics_t, H, W, fx.sc["K"], 0, device="cpu")(
        fx.params, fx.scene, fx.pose)
    tiled = make_frame_renderer(statics_t, H, W, fx.sc["K"], 96,
                                device="cpu")(fx.params, fx.scene, fx.pose)
    want = j_make(JStatics.infer(compute_dtype="bfloat16", use_pallas=True,
                                 transposed=True, pallas_block_rays=128),
                  H, W, fx.sc["K"], tile_rays=0)(fx.jparams, fx.jscene,
                                                 jnp.asarray(fx.pose))
    assert set(whole) == set(rows) == set(want)
    for k, v in whole.items():
        assert v.shape == rows[k].shape
        np.testing.assert_allclose(v.numpy(), rows[k].numpy(), atol=2e-2,
                                   err_msg=k)
        np.testing.assert_allclose(tiled[k].numpy(), v.numpy(), atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k], np.float32),
                                   atol=2e-2, err_msg=k)
    # a float scene is not eligible: the renderer keeps the row-major graph
    float_scene = convert.scene_from_numpy(
        fx.sc["images"][REF], fx.sc["poses"][REF], fx.sc["K"],
        pack_corners=False)
    out = make_frame_renderer(statics_t, H, W, fx.sc["K"], 0, device="cpu")(
        fx.params, float_scene, fx.pose)
    assert np.all(np.isfinite(out["rgb1"].numpy()))


# ------------------------------------------------------------- int8 render --

def test_render_rays_int8_against_jax_on_the_same_panels(fx):
    j_packed = j_fq.pack_nerf_params_int8(fx.jparams["nerf"])
    want = fx.jax(
        j_render_rays,
        JStatics.infer(compute_dtype="bfloat16", use_pallas=True,
                       pallas_block_rays=128, quant="int8"),
        params=dict(fx.jparams, nerf_packed_q=j_packed))
    got = fx.port(
        render_rays,
        RenderStatics.infer(compute_dtype="bfloat16", use_kernels=True,
                            quant="int8"),
        params=dict(fx.params, nerf_packed_q=convert.packed_q_from_numpy(
            as_numpy(j_packed))))
    assert_close_nine(got, want, bf16=True)


def test_render_rays_int8_close_to_the_bf16_kernel_path(fx):
    statics = RenderStatics.infer(compute_dtype="bfloat16", use_kernels=True)
    bf16 = fx.port(render_rays, statics)
    q = fx.port(render_rays, dataclasses.replace(statics, quant="int8"))
    assert np.all(np.isfinite(q["rgb1"]))
    mse = np.mean((bf16["rgb1"].astype(np.float64) - q["rgb1"]) ** 2)
    assert -10.0 * np.log10(max(mse, 1e-12)) > 32.0
    np.testing.assert_allclose(q["depth"], bf16["depth"], atol=0.05)
    assert np.abs(q["sigma"] - bf16["sigma"]).max() < \
        0.25 * bf16["sigma"].std() + 0.02
    # fuse_composite is ignored on the int8 path: raw + ops.composite
    qf = fx.port(render_rays, dataclasses.replace(statics, quant="int8",
                                                  fuse_composite=True))
    for k in KEYS:
        np.testing.assert_array_equal(qf[k], q[k], err_msg=k)
    with pytest.raises(ValueError, match="quant"):
        fx.port(render_rays, dataclasses.replace(statics, quant="int4"))


@pytest.mark.parametrize("kw", [dict(quant="int8"), dict(transposed=True),
                                dict(gather_transposed=1)],
                         ids=["int8", "transposed", "transposed_emit"])
def test_run_inference_new_paths_on_cpu(tmp_path, capsys, kw):
    from pronerf_tpu_torch.config import Config
    from pronerf_tpu_torch.render.infer import _infer_statics, run_inference

    cfg = Config.from_file(
        "configs/llff/fern/fern_trt.txt", datadir="synthetic:24x18x9",
        use_trt=True, tile_rays=0, use_pallas=True, basedir=str(tmp_path),
        ft_path="", **kw)
    statics = _infer_statics(cfg, use_bf16=True)
    for name, value in kw.items():
        assert getattr(statics, name) == value
    result = run_inference(cfg, device="cpu")
    capsys.readouterr()
    assert result["rgbs1"].shape == (2, 18, 24, 3)
    assert np.all(np.isfinite(result["rgbs1"]))
    assert np.all(np.isfinite(result["psnrs"]))
    base = run_inference(cfg.replace(quant="none", transposed=False,
                                     gather_transposed=-1), device="cpu")
    capsys.readouterr()
    np.testing.assert_allclose(result["rgbs1"], base["rgbs1"], atol=2e-2)
    np.testing.assert_allclose(result["depths"], base["depths"], atol=5e-2)
    # quant reaches the statics only with the kernels on
    off = _infer_statics(cfg.replace(use_pallas=False, quant="int8"), True)
    assert off.quant == "none" and not off.use_kernels
