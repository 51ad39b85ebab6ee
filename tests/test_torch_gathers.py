"""The gathers of ``ops/warp.py`` beyond the shared-view row fetch, and the
statics that select them, against the JAX package on the CPU: the split
(three word) and nearest (whole-pixel) samplers, the per-view training
gather, the windowed gather of full-resolution serving in its row-major,
split and transposed-emit forms and in the transposed graph
(``epipolar_colors_shared_t``), ``resolve_gather_statics``, and the slice
through ``render_rays`` / ``render_rays_t`` and the frame renderer with
windows on and a ragged last tile.

Scene: ``make_scene`` of 5 views (held-out target pose 1 from views 0, 2,
3, 4), rays from the JAX ray generator handed to both as numpy. Small
windows (a few of 16 to 24 source rows) so that windows miss points.

Tolerances: colours ``atol 1e-5`` with EQUAL invalid masks, as
tests/test_torch_ops.py (the two packages differ in the last bits of the
lerp; XLA contracts it into FMAs); within the port the split and the
windowed forms are held to the row form bit for bit where the JAX package
claims it. Renders: the bounds of tests/test_torch_render.py (f32 ``5e-5``,
depth ``5e-4``, disp ``1e-3``; bf16 ``0.02``, sigma ``0.05``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pronerf_tpu.models import RenderStatics as JStatics
from pronerf_tpu.models import init_pronerf_params as j_init
from pronerf_tpu.models import render_rays as j_render_rays
from pronerf_tpu.models.pronerf_t import render_rays_t as j_render_rays_t
from pronerf_tpu.ops import warp as j_warp
from pronerf_tpu.render import prepare_scene as j_prepare_scene
from pronerf_tpu.render import renderer as j_renderer
from pronerf_tpu.render.raygen import rays_for_pose as j_rays_for_pose
from pronerf_tpu.utils.synthetic import make_scene
from pronerf_tpu_torch import convert
from pronerf_tpu_torch.models.pronerf import RenderStatics, render_rays
from pronerf_tpu_torch.models.pronerf_t import render_rays_t
from pronerf_tpu_torch.ops import warp as t_warp
from pronerf_tpu_torch.render import renderer as t_renderer

torch.set_num_threads(2)

ATOL = 1e-5
REF = [0, 2, 3, 4]
KEYS = ("rgb0", "rgb1", "depth", "disp", "acc", "weights", "mm_rgb",
        "depth0", "sigma")


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol=ATOL, **kw):
    np.testing.assert_allclose(
        got.detach().numpy() if torch.is_tensor(got) else np.asarray(got),
        np.asarray(want), atol=atol, rtol=0, **kw)


def same_colours(got, want, channel_axis=-1):
    """atol 1e-5 and the same invalid (all-zero) points."""
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape
    close(got, want)
    np.testing.assert_array_equal(g.sum(channel_axis) == 0,
                                  w.sum(channel_axis) == 0)


class Scene:
    """Both packages' scenes of one image form, and a frame's rays and
    candidate depths."""

    def __init__(self, H, W, pack="u8", n_zero=0):
        sc = make_scene(n_views=5, H=H, W=W, seed=0)
        self.H, self.W, self.sc = H, W, sc
        self.js = j_prepare_scene(sc["images"][REF], sc["poses"][REF],
                                  sc["K"], pack_corners=pack)
        self.ts = convert.scene_from_numpy(sc["images"][REF],
                                           sc["poses"][REF], sc["K"],
                                           pack_corners=pack)
        jr = j_rays_for_pose(H, W, sc["K"], sc["poses"][1])
        self.o, self.d = np.array(jr["or_o"]), np.array(jr["or_d"])
        # the frame renderer's zero-direction pads, which place no window
        if n_zero:
            self.o[-n_zero:] = 0.0
            self.d[-n_zero:] = 0.0
        n = H * W
        self.z3d = (1.0 / (1.0 - 0.9 * np.random.default_rng(10).random(
            (n, 8)))).astype(np.float32)
        self.vids = np.array([2, 0, 3, 1])

    def jargs(self, transposed=False):
        o, d, z = self.o, self.d, self.z3d
        if transposed:
            o, d, z = o.T, d.T, z.T
        return (self.js["images"], self.js["fused_mats"], self.js["K"],
                jnp.asarray(self.vids), jnp.asarray(o), jnp.asarray(d),
                jnp.asarray(z))

    def targs(self, transposed=False):
        o, d, z = self.o, self.d, self.z3d
        if transposed:
            o, d, z = o.T.copy(), d.T.copy(), z.T.copy()
        return (self.ts["images"], self.ts["fused_mats"], self.ts["K"],
                T(self.vids), T(o), T(d), T(z))


@pytest.fixture(scope="module")
def scene():
    return Scene(24, 32, n_zero=40)


# ------------------------------------------------------------ samplers --

def sampler_inputs(seed=9):
    rng = np.random.default_rng(seed)
    img = rng.random((3, 9, 11, 3)).astype(np.float32)
    img[1] = np.maximum(img[1], 0.6)  # corner bytes >= 128: negative words
    xn = rng.uniform(-1.2, 1.2, (40, 8)).astype(np.float32)
    yn = rng.uniform(-1.2, 1.2, (40, 8)).astype(np.float32)
    # on the border, and exactly half a pixel off a centre (ties of the
    # nearest rounding: half to even in both)
    xn[0, :4] = [-1.0, 1.0, 0.0, 1.0]
    yn[0, :4] = [-1.0, 1.0, 1.0, -1.0]
    xn[1, :3] = [2 * 0.5 / 10 - 1, 2 * 1.5 / 10 - 1, 2 * 2.5 / 10 - 1]
    yn[1, :3] = [2 * 0.5 / 8 - 1, 2 * 3.5 / 8 - 1, 2 * 6.5 / 8 - 1]
    vid = rng.integers(0, 3, (40, 8)).astype(np.int32)
    return img, vid, xn, yn


def test_split_sampler_equals_the_row_form_and_jax():
    img, vid, xn, yn = sampler_inputs()
    packed = t_warp.build_corner_stack_u8(T(img))
    got = t_warp.bilinear_sample_packed_u8_split(packed, T(vid), T(xn), T(yn))
    row = t_warp.bilinear_sample_packed_u8(packed, T(vid), T(xn), T(yn))
    assert torch.equal(got, row)  # bit for bit, as the JAX package's test
    want = j_warp.bilinear_sample_packed_u8_split(
        j_warp.build_corner_stack_u8(jnp.asarray(img)), jnp.asarray(vid),
        jnp.asarray(xn), jnp.asarray(yn))
    same_colours(got, want)


def test_nearest_pack_and_sampler_match_jax():
    img, vid, xn, yn = sampler_inputs()
    packed = t_warp.build_rgb_word_u8(T(img))
    jpacked = j_warp.build_rgb_word_u8(jnp.asarray(img))
    assert packed.dtype == torch.int32 and packed.shape == (3, 9, 11)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    assert t_warp.is_nearest_pack(packed) and not t_warp.is_u8_pack(packed)
    got = t_warp.nearest_sample_packed_u8(packed, T(vid), T(xn), T(yn))
    want = j_warp.nearest_sample_packed_u8(jpacked, jnp.asarray(vid),
                                           jnp.asarray(xn), jnp.asarray(yn))
    same_colours(got, want)
    # every colour is a whole pixel of the image (8-bit)
    g = got.numpy() * 255
    assert np.abs(g - np.round(g)).max() < 1e-4


# --------------------------------------------------- training gathers --

@pytest.mark.parametrize("pack,split", [("u8", False), ("u8", True),
                                        ("u8-nearest", False)])
def test_all_views_training_gather_forms_match_jax(pack, split):
    sc = Scene(16, 20, pack=pack)
    n = 96
    view_idx = np.random.default_rng(3).integers(0, 4, (n, 4)).astype(
        np.int32)
    jargs = sc.jargs()
    targs = sc.targs()
    want = j_warp.epipolar_colors(
        *jargs[:3], jnp.asarray(view_idx), jargs[4][:n], jargs[5][:n],
        jargs[6][:n], split=split)
    got = t_warp.epipolar_colors(
        *targs[:3], T(view_idx), targs[4][:n], targs[5][:n], targs[6][:n],
        split=split)
    same_colours(got, want)
    assert 0 < (got.numpy().sum(-1) == 0).mean() < 1


@pytest.mark.parametrize("split", [False, True])
def test_per_view_gather_equals_all_views_and_jax(split):
    sc = Scene(16, 20)
    n = 96
    view_idx = np.random.default_rng(4).integers(0, 4, (n, 4)).astype(
        np.int32)
    jargs, targs = sc.jargs(), sc.targs()
    got = t_warp.epipolar_colors_per_view(
        *targs[:3], T(view_idx), targs[4][:n], targs[5][:n], targs[6][:n],
        split=split)
    all_views = t_warp.epipolar_colors(
        *targs[:3], T(view_idx), targs[4][:n], targs[5][:n], targs[6][:n])
    assert torch.equal(got, all_views)
    want = j_warp.epipolar_colors_per_view(
        *jargs[:3], jnp.asarray(view_idx), jargs[4][:n], jargs[5][:n],
        jargs[6][:n], split=split)
    same_colours(got, want)


# ------------------------------------------------- shared-view gathers --

@pytest.mark.parametrize("pack,split", [("u8", True), ("u8-nearest", False)])
def test_shared_gather_split_and_nearest_match_jax(pack, split):
    sc = Scene(16, 20, pack=pack)
    got = t_warp.epipolar_colors_shared(*sc.targs(), split=split)
    want = j_warp.epipolar_colors_shared(*sc.jargs(), split=split)
    same_colours(got, want)
    if split:
        assert torch.equal(got, t_warp.epipolar_colors_shared(*sc.targs()))
    got_bf = t_warp.epipolar_colors_shared(*sc.targs(), split=split,
                                           out_dtype=torch.bfloat16)
    assert torch.equal(got_bf, got.to(torch.bfloat16))


WINDOWS = [(3, 6), (4, 30), (5, 3), (7, 11)]  # (n_tiles, window_rows)
FORMS = [dict(), dict(split=True), dict(transposed_out=True)]


@pytest.mark.parametrize("n_tiles,window_rows", WINDOWS)
@pytest.mark.parametrize("form", range(len(FORMS)))
def test_windowed_gather_matches_jax(scene, n_tiles, window_rows, form):
    """Ragged tiles (768 rays in 5 or 7 tiles: pads of direction 1.0, which
    place windows), the frame's zero-direction pads (which do not), and
    windows that miss."""
    kw = FORMS[form]
    got = t_warp.epipolar_colors_shared_windowed(
        *scene.targs(), n_tiles, window_rows, **kw)
    want = j_warp.epipolar_colors_shared_windowed(
        *scene.jargs(), n_tiles, window_rows, **kw)
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape
    close(got, want)
    if kw.get("transposed_out"):  # [V, S*3, N] -> the validity of (v, s, n)
        g = g.reshape(4, 8, 3, -1).transpose(3, 0, 1, 2)
        w = w.reshape(4, 8, 3, -1).transpose(3, 0, 1, 2)
    np.testing.assert_array_equal(g.sum(-1) == 0, w.sum(-1) == 0)
    # within the port: every form holds the row form's values bit for bit
    rows = t_warp.epipolar_colors_shared_windowed(
        *scene.targs(), n_tiles, window_rows)
    if kw.get("transposed_out"):
        assert torch.equal(got, rows.permute(1, 2, 3, 0).reshape(4, 24, -1))
    else:
        assert torch.equal(got, rows)
    got_bf = t_warp.epipolar_colors_shared_windowed(
        *scene.targs(), n_tiles, window_rows, out_dtype=torch.bfloat16, **kw)
    assert torch.equal(got_bf, got.to(torch.bfloat16))


@pytest.mark.parametrize("n_tiles,window_rows", WINDOWS)
def test_windowed_transposed_graph_gather_matches_jax(scene, n_tiles,
                                                      window_rows):
    got = t_warp.epipolar_colors_shared_t(
        *scene.targs(transposed=True), n_tiles=n_tiles,
        window_rows=window_rows)
    want = j_warp.epipolar_colors_shared_t(
        *scene.jargs(transposed=True), n_tiles=n_tiles,
        window_rows=window_rows)
    same_colours(got, want, channel_axis=1)


def test_windows_that_miss_and_windows_that_cover(scene):
    """A covering window equals the unwindowed gather bit for bit; a small
    one marks points invalid that the unwindowed gather reads, and nothing
    else: where the window hits, the colours are the unwindowed ones."""
    full = t_warp.epipolar_colors_shared(*scene.targs())
    for form in FORMS:
        cover = t_warp.epipolar_colors_shared_windowed(
            *scene.targs(), 3, scene.H, **form)
        ref = (full.permute(1, 2, 3, 0).reshape(4, 24, -1)
               if form.get("transposed_out") else full)
        assert torch.equal(cover, ref)
    cover_t = t_warp.epipolar_colors_shared_t(
        *scene.targs(transposed=True), n_tiles=3, window_rows=scene.H)
    assert torch.equal(cover_t, t_warp.epipolar_colors_shared_t(
        *scene.targs(transposed=True)))
    small = t_warp.epipolar_colors_shared_windowed(*scene.targs(), 5, 3)
    valid_full = full.sum(-1) > 0
    valid_small = small.sum(-1) > 0
    missed = valid_full & ~valid_small
    assert not (valid_small & ~valid_full).any()
    assert 0.05 < float(missed.float().mean()) < 0.9
    assert torch.equal(small[valid_small], full[valid_small])


# ------------------------------------------------------ the statics --

@pytest.mark.parametrize("hw,rays,want", [
    ((378, 504), 0, (0, 0)),             # below the cliff: off
    ((756, 1008), 0, (8, 198)),          # the whole frame in one call
    ((756, 1008), 262144, (3, 198)),     # 262,144-ray calls
    ((1512, 2016), 0, (31, 99)),
])
def test_resolve_gather_statics_matches_jax(hw, rays, want):
    H, W = hw
    rays = rays or H * W
    got = t_renderer.resolve_gather_statics(
        RenderStatics.infer(gather_tiles=-1), H, W, rays)
    jwant = j_renderer.resolve_gather_statics(
        JStatics.infer(gather_tiles=-1), H, W, rays)
    assert (got.gather_tiles, got.gather_window_rows) == (
        jwant.gather_tiles, jwant.gather_window_rows) == want
    assert t_renderer.GATHER_CLIFF_BYTES == j_renderer.GATHER_CLIFF_BYTES
    # explicit settings are kept as they are
    for tiles, rows in ((0, 0), (4, 0), (6, 40)):
        st = RenderStatics.infer(gather_tiles=tiles, gather_window_rows=rows)
        assert t_renderer.resolve_gather_statics(st, H, W, rays) is st


def test_infer_statics_and_frame_renderer_resolve_as_jax_at_1008x756():
    """``_infer_statics`` passes ``gather_tiles`` through (-1 by default)
    and the frame renderer resolves it at the serving tile size, as the
    JAX package does: 8 ray tiles of 198-row windows at 1008x756, off at
    504x378."""
    from pronerf_tpu.config import Config as JConfig
    from pronerf_tpu.render.infer import _infer_statics as j_infer_statics
    from pronerf_tpu_torch.config import Config
    from pronerf_tpu_torch.render.infer import _infer_statics

    path = "configs/llff/fern/fern_trt.txt"
    for HW, want in (((756, 1008), (8, 198)), ((378, 504), (0, 0))):
        for tile in (0, 262144):
            cfg = Config.from_file(path, use_trt=True, tile_rays=tile,
                                   use_pallas=True)
            jcfg = JConfig.from_file(path, use_trt=True, tile_rays=tile,
                                     use_pallas=True)
            st = _infer_statics(cfg, use_bf16=True)
            jst = j_infer_statics(jcfg, use_bf16=True)
            assert st.gather_tiles == jst.gather_tiles == -1
            K = np.eye(3)
            render = t_renderer.make_frame_renderer(st, *HW, K, tile,
                                                    device="cpu")
            rays = tile if tile and tile < HW[0] * HW[1] else HW[0] * HW[1]
            jres = j_renderer.resolve_gather_statics(jst, *HW, rays)
            got = render.statics
            fields = {f.name for f in dataclasses.fields(got)} - {
                "use_kernels"}
            assert {f: getattr(got, f) for f in fields} == {
                f: getattr(jres, f) for f in fields}
            assert got.use_kernels == jres.use_pallas
            if tile == 0:
                assert (got.gather_tiles, got.gather_window_rows) == want


# --------------------------------------------------------- the slice --

class Render:
    """A 16x20 frame's render through both packages (the fixture of
    tests/test_torch_render.py)."""

    H, W = 16, 20

    def __init__(self):
        sc = make_scene(n_views=5, H=self.H, W=self.W, seed=0)
        self.sc, self.pose = sc, sc["poses"][1]
        self.jscene = j_prepare_scene(sc["images"][REF], sc["poses"][REF],
                                      sc["K"])
        self.jparams = j_init(jax.random.PRNGKey(0))
        self.jrays = j_rays_for_pose(self.H, self.W, sc["K"], self.pose)
        self.jcontrols = {"rng": jax.random.PRNGKey(0),
                          "target_t": jnp.asarray(self.pose[:3, 3])}
        self.params = convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, self.jparams))
        self.scene = convert.scene_from_numpy(
            sc["images"][REF], sc["poses"][REF], sc["K"])
        self.rays = {k: T(v) for k, v in self.jrays.items()}
        self.controls = {"target_t": T(self.pose[:3, 3])}

    def both(self, fn_t, fn_j, compute_dtype, use_kernels, **kw):
        want = fn_j(self.jparams, self.jrays, self.jscene, self.jcontrols,
                    JStatics.infer(compute_dtype=compute_dtype,
                                   use_pallas=use_kernels,
                                   pallas_block_rays=128, **kw))
        with torch.no_grad():
            got = fn_t(self.params, self.rays, self.scene, self.controls,
                       RenderStatics.infer(compute_dtype=compute_dtype,
                                           use_kernels=use_kernels, **kw))
        return ({k: v.numpy() for k, v in got.items()},
                {k: np.asarray(v, np.float32) for k, v in want.items()})


@pytest.fixture(scope="module")
def render():
    return Render()


def assert_render_close(got, want, bf16):
    for k in KEYS:
        assert got[k].shape == want[k].shape, k
        if bf16:
            if k == "disp":  # as tests/test_torch_render.py: 98% of rays
                rel = np.abs(got[k] - want[k]) / np.abs(want[k])
                assert np.mean(rel <= 0.05) >= 0.98
                continue
            atol = 0.05 if k == "sigma" else 0.02
        else:
            atol = {"depth": 5e-4, "disp": 1e-3}.get(k, 5e-5)
        np.testing.assert_allclose(got[k], want[k], atol=atol, err_msg=k)


WINDOWED = dict(gather_tiles=4, gather_window_rows=2)


@pytest.mark.parametrize("compute_dtype,use_kernels,extra", [
    (None, False, {}),
    (None, False, dict(gather_split=True)),
    ("bfloat16", True, {}),
    ("bfloat16", True, dict(gather_transposed=1)),
    ("bfloat16", True, dict(gather_split=True)),
])
def test_render_rays_windowed_matches_jax(render, compute_dtype, use_kernels,
                                          extra):
    got, want = render.both(render_rays, j_render_rays, compute_dtype,
                            use_kernels, **WINDOWED, **extra)
    assert_render_close(got, want, compute_dtype is not None)
    # the windows miss here: the frame differs from the unwindowed one
    with torch.no_grad():
        plain = render_rays(
            render.params, render.rays, render.scene, render.controls,
            RenderStatics.infer(compute_dtype=compute_dtype,
                                use_kernels=use_kernels, **extra))
    assert not np.array_equal(got["rgb0"], plain["rgb0"].numpy())


def test_render_rays_t_windowed_matches_jax(render):
    got, want = render.both(render_rays_t, j_render_rays_t, "bfloat16", True,
                            transposed=True, **WINDOWED)
    assert_render_close(got, want, True)


def test_split_and_transposed_emit_render_equal_the_row_form(render):
    """The split fetch and the transposed emit give the kernel path the
    colours of the row fetch bit for bit, so the whole render is equal."""
    outs = []
    with torch.no_grad():
        for kw in ({}, dict(gather_split=True), dict(gather_transposed=1)):
            outs.append(render_rays(
                render.params, render.rays, render.scene, render.controls,
                RenderStatics.infer(compute_dtype="bfloat16",
                                    use_kernels=True, **WINDOWED, **kw)))
    for out in outs[1:]:
        for k in KEYS:
            assert torch.equal(torch.nan_to_num(out[k]),
                               torch.nan_to_num(outs[0][k])), k


@pytest.mark.parametrize("transposed", [False, True])
def test_frame_renderer_windowed_ragged_tile_matches_jax(render, transposed):
    """320 rays in calls of 96 (the last holds 32): the port pads the last
    call to 96 zero rays, as the JAX renderer pads every call, so each
    call's ray tiles, and with them the windows, begin where JAX's do."""
    statics = RenderStatics.infer(compute_dtype="bfloat16", use_kernels=True,
                                  transposed=transposed, **WINDOWED)
    jstatics = JStatics.infer(compute_dtype="bfloat16", use_pallas=True,
                              pallas_block_rays=128, transposed=transposed,
                              **WINDOWED)
    K = render.sc["K"]
    got = t_renderer.make_frame_renderer(
        statics, render.H, render.W, K, 96, device="cpu")(
            render.params, render.scene, render.pose)
    want = j_renderer.make_frame_renderer(jstatics, render.H, render.W, K,
                                          tile_rays=96)(
        render.jparams, render.jscene, jnp.asarray(render.pose))
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k], np.float32),
                                   atol=0.02, err_msg=k)
    # without the pad the last call's 32 rays would form tiles of 8 and
    # place their own windows: the pad is what the frame depends on
    whole = t_renderer.make_frame_renderer(
        statics, render.H, render.W, K, 0, device="cpu")(
            render.params, render.scene, render.pose)
    assert not torch.equal(whole["rgb0"], got["rgb0"])
