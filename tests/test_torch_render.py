"""The slice as a whole: the port's ``render_rays``, frame renderer and
serving entry point against the JAX package, on the CPU.

Fixture: ``make_scene(n_views=5, H=16, W=20)``, the scene of the JAX
package's own kernel tests. Weights come from the JAX initialiser through
``convert.params_from_numpy``; rays are made once (by the JAX ray generator)
and handed to both as numpy. The port's kernels run as their plain versions
(CPU tensors), the JAX kernels in interpret mode, their positional
encoding taken from the f32 points as the port's (``torch_jax_pe``).

The main comparisons render a HELD-OUT pose (pose 1 from source views
0, 2, 3, 4), as served frames are. With the target pose among the source
views, every sample of a ray projects exactly onto a pixel centre of that
view; a last-bit difference in the projection then moves border pixels
across the out-of-bounds test and zeroes a colour. One test keeps that
fixture, for the keys the JAX test checks on it.

Tolerances. f32: ``atol 5e-5``, ``depth 5e-4`` (the JAX test's bounds for
its own kernel path against its plain path), ``disp 1e-3`` as the JAX
composite test. bf16 against JAX bf16: ``0.02`` on colours and depths (the
JAX test's bound between its two bf16 paths), ``0.05`` on sigma logits;
``disp`` = 1 / (depth / acc) is compared relative to its size, on at least
98% of the rays (the reason stands at the comparison).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pronerf_tpu.models import RenderStatics as JStatics
from pronerf_tpu.models import init_pronerf_params as j_init
from pronerf_tpu.models import render_rays as j_render_rays
from pronerf_tpu.render import prepare_scene as j_prepare_scene
from pronerf_tpu.render.raygen import rays_for_pose as j_rays_for_pose
from pronerf_tpu.render.renderer import make_frame_renderer as j_make_renderer
from pronerf_tpu.utils.synthetic import make_scene
from pronerf_tpu_torch import convert
from pronerf_tpu_torch.models.pronerf import RenderStatics, render_rays
from pronerf_tpu_torch.render.raygen import rays_for_pose
from pronerf_tpu_torch.render.renderer import make_frame_renderer
from torch_jax_pe import jax_kernels_with_f32_pe  # noqa: F401 (autouse: f32 PE)

# The suite runs several workers side by side; two threads a worker keep
# PyTorch's CPU kernels from crowding the other workers' tests.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("rgb0", "rgb1", "depth", "disp", "acc", "weights", "mm_rgb",
        "depth0", "sigma")
H, W = 16, 20


class Fixture:
    def __init__(self, ref, **nets):
        sc = make_scene(n_views=5, H=H, W=W, seed=0)
        self.sc, self.pose = sc, sc["poses"][1]
        self.jscene = j_prepare_scene(sc["images"][ref], sc["poses"][ref],
                                      sc["K"])
        self.jparams = j_init(jax.random.PRNGKey(0), **nets)
        self.jrays = j_rays_for_pose(H, W, sc["K"], self.pose)
        self.jcontrols = {"rng": jax.random.PRNGKey(0),
                          "target_t": jnp.asarray(self.pose[:3, 3])}
        self.params = convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, self.jparams))
        self.scene = convert.scene_from_numpy(
            sc["images"][ref], sc["poses"][ref], sc["K"])
        self.rays = {k: torch.from_numpy(np.array(v))
                     for k, v in self.jrays.items()}
        self.controls = {"target_t": torch.from_numpy(self.pose[:3, 3].copy())}

    def both(self, compute_dtype=None, use_kernels=False, jax_kw=(), **kw):
        """Both packages' ``render_rays`` under the inference statics
        replaced by ``kw`` (JAX's by ``jax_kw`` too)."""
        want = j_render_rays(
            self.jparams, self.jrays, self.jscene, self.jcontrols,
            dataclasses.replace(JStatics.infer(
                compute_dtype=compute_dtype, use_pallas=use_kernels,
                pallas_block_rays=128), **kw, **dict(jax_kw)))
        with torch.no_grad():
            got = render_rays(
                self.params, self.rays, self.scene, self.controls,
                dataclasses.replace(RenderStatics.infer(
                    compute_dtype=compute_dtype, use_kernels=use_kernels),
                    **kw))
        assert set(got) == set(want) == set(KEYS)
        return ({k: v.numpy() for k, v in got.items()},
                {k: np.asarray(v, np.float32) for k, v in want.items()})


@pytest.fixture(scope="module")
def held_out():
    return Fixture(ref=[0, 2, 3, 4])


# (use_kernels, fused): the kernel-free path; the raw-kernel route, which
# the kernel path takes where the NeRF kernel cannot composite (here the
# served statics with the stage-1 raw clamp), the raw kernel and
# ops.composite; the served route, compositing inside the NeRF kernel
# (JAX's under its fuse_composite).
PATHS = [(False, False), (True, False), (True, True)]


def path_kw(use_kernels, fused):
    """The statics' replacements of a path of ``PATHS``, and JAX's."""
    if not use_kernels:
        return {}, {}
    if not fused:
        return {"clamp_raw": True}, {}
    return {}, {"fuse_composite": True}


@pytest.mark.parametrize("use_kernels,fused", PATHS)
def test_render_rays_f32_all_keys(held_out, use_kernels, fused):
    kw, jax_kw = path_kw(use_kernels, fused)
    got, want = held_out.both(None, use_kernels, jax_kw, **kw)
    for k in KEYS:
        assert got[k].shape == want[k].shape, k
        atol = {"depth": 5e-4, "disp": 1e-3}.get(k, 5e-5)
        np.testing.assert_allclose(got[k], want[k], atol=atol, err_msg=k)


@pytest.mark.parametrize("use_kernels,fused", PATHS)
def test_render_rays_bf16_all_keys(held_out, use_kernels, fused):
    kw, jax_kw = path_kw(use_kernels, fused)
    got, want = held_out.both("bfloat16", use_kernels, jax_kw, **kw)
    for k in KEYS:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
        if k == "disp":
            # With freshly initialised nets a ray is almost transparent
            # (acc ~ 1e-5), and disp = acc / depth is the ratio of two sums
            # of a few such weights. Where bf16 noise moves one sample's
            # relu(mm_mul) across zero the ratio jumps, so single rays (one
            # of 320 here) may leave the bound: at least 98% must hold it.
            rel = np.abs(got[k] - want[k]) / np.abs(want[k])
            assert np.all(np.isfinite(got[k])) and np.mean(rel <= 0.05) >= 0.98
        else:
            np.testing.assert_allclose(
                got[k], want[k], atol=0.05 if k == "sigma" else 0.02,
                err_msg=k)


def test_render_rays_paths_agree_within_the_port(held_out):
    """Both kernel routes (plain versions) against the kernel-free path
    under the same statics, f32: the query points built per (s, c) row
    equal those built from the [n, S, 3] offsets."""

    def render(use_kernels, **kw):
        with torch.no_grad():
            return render_rays(
                held_out.params, held_out.rays, held_out.scene,
                held_out.controls, dataclasses.replace(
                    RenderStatics.infer(use_kernels=use_kernels), **kw))

    for key in PATHS[1:]:
        kw, _ = path_kw(*key)
        got, base = render(True, **kw), render(False, **kw)
        for k in KEYS:
            atol = {"depth": 5e-4, "disp": 1e-3}.get(k, 5e-5)
            np.testing.assert_allclose(got[k].numpy(), base[k].numpy(),
                                       atol=atol, err_msg=f"{key} {k}")
    z_mean = base["depth0"].numpy()
    assert z_mean.shape == (H * W,) and np.all((z_mean > 0) & (z_mean < 1))


def test_render_rays_on_the_jax_tests_own_fixture():
    """Target pose among the five source views, as in the JAX package's
    tests, on the keys those tests check."""
    fx = Fixture(ref=[0, 1, 2, 3, 4])
    got, want = fx.both(None, True)
    for k, atol in (("rgb1", 5e-5), ("depth", 5e-4), ("weights", 5e-5)):
        np.testing.assert_allclose(got[k], want[k], atol=atol, err_msg=k)


def test_unported_branches_raise_by_name():
    """Every branch of ``render_rays`` is ported: the windowed, split,
    per-view and nearest gathers and DoNeRF run
    (tests/test_torch_gathers.py, tests/test_torch_donerf.py). What still
    raises is what the JAX package cannot run either, by name: an unknown
    ``quant`` or ``netarch``, the fused kernels on a training branch, the
    int8 kernel on DoNeRF (it implements the NeRF MLP; DoNeRF's own kernel
    is bf16), the transposed emit of a split or non-u8 gather."""
    fx_statics = RenderStatics.infer(compute_dtype="bfloat16")
    for kw, err, word in (
            (dict(quant="int4"), ValueError, "quant"),
            (dict(netarch="mip"), ValueError, "netarch"),
            (dict(netarch="donerf", use_kernels=True, quant="int8"),
             ValueError, "donerf")):
        with pytest.raises(err, match=word):
            render_rays({}, {}, {}, {}, dataclasses.replace(fx_statics, **kw))
    from pronerf_tpu_torch.ops.warp import (
        epipolar_colors_shared,
        epipolar_colors_shared_windowed,
    )

    for split, images in ((True, torch.zeros(4, H, W, 3, dtype=torch.int32)),
                          (False, torch.zeros(4, H, W, 3))):
        with pytest.raises(ValueError, match="transposed_out"):
            epipolar_colors_shared(images, None, None, None, None, None,
                                   None, split=split, transposed_out=True)
    with pytest.raises(ValueError, match="u8"):
        epipolar_colors_shared_windowed(torch.zeros(4, H, W, 3), None, None,
                                        None, None, None, None, 4, 8)
    # the training branches run (tests/test_torch_train_render.py, the
    # per-view gather tests/test_torch_gathers.py); the fused kernels take
    # no training branch
    for factory in (RenderStatics.stage1_nerf, RenderStatics.stage1_sampler,
                    RenderStatics.stage2):
        with pytest.raises(ValueError, match="deterministic"):
            render_rays({}, {}, {}, {},
                        dataclasses.replace(factory(), use_kernels=True))


def test_render_statics_twin_has_the_same_fields_and_defaults():
    """The port's fields are JAX's, with ``use_kernels`` for ``use_pallas``,
    less JAX's composite switch (the port's kernel path composites in the
    NeRF kernel wherever the statics allow it) and its Pallas block of
    rays (the CUDA kernels fix their tile at build time)."""
    j = {f.name: f.default for f in dataclasses.fields(JStatics)}
    t = {f.name: f.default for f in dataclasses.fields(RenderStatics)}
    assert j.pop("use_pallas") == t.pop("use_kernels")
    for name in ("fuse_composite", "pallas_block_rays"):  # JAX's alone
        j.pop(name)
    assert j == t
    ji, ti = JStatics.infer(), RenderStatics.infer()
    for name in t:
        assert getattr(ji, name) == getattr(ti, name), name
    hash(RenderStatics.infer(compute_dtype="bfloat16", use_kernels=True))


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_frame_renderer_whole_frame_tiled_and_jax(held_out, compute_dtype):
    """Whole frame in one tile, tiles of 96 rays (ragged: 320 = 3 * 96 + 32)
    and the JAX renderer give the same frame."""
    fx = held_out
    use_kernels = compute_dtype is not None
    statics = RenderStatics.infer(compute_dtype=compute_dtype,
                                  use_kernels=use_kernels)
    whole = make_frame_renderer(statics, H, W, fx.sc["K"], 0, device="cpu")(
        fx.params, fx.scene, fx.pose)
    tiled = make_frame_renderer(statics, H, W, fx.sc["K"], 96, device="cpu")(
        fx.params, fx.scene, fx.pose)
    want = j_make_renderer(
        JStatics.infer(compute_dtype=compute_dtype, use_pallas=use_kernels,
                       pallas_block_rays=128),
        H, W, fx.sc["K"], tile_rays=0)(fx.jparams, fx.jscene,
                                       jnp.asarray(fx.pose))
    assert set(whole) == set(want)
    atol = 5e-5 if compute_dtype is None else 0.02
    for k, v in whole.items():
        assert v.shape == want[k].shape == ((H, W, 3) if v.dim() == 3 else (H, W))
        # a tile is rendered by the same code on fewer rows: same values
        np.testing.assert_allclose(tiled[k].numpy(), v.numpy(), atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(
            v.numpy(), np.asarray(want[k], np.float32),
            atol=5e-4 if (k == "depth" and compute_dtype is None) else atol,
            err_msg=k)


@pytest.mark.parametrize("tile_rays", [0, 96])
def test_frame_renderer_stays_eager_on_the_cpu(held_out, tile_rays):
    """On the CPU ``render_frame`` runs every call eagerly, however often it
    sees one parameter set and scene (on the card the second call captures
    a CUDA graph): ``frame_eager`` moves once a call, ``frame_replays`` and
    ``graph_captures`` not at all, and each call returns tensors of its
    own, equal to the frame body's."""
    from pronerf_tpu_torch.utils import profiling

    fx = held_out
    render = make_frame_renderer(served_statics("viewer_cell"), H, W,
                                 fx.sc["K"], tile_rays, device="cpu")
    names = ("frame_eager", "frame_replays", "graph_captures")
    before = {k: profiling.COUNTERS[k] for k in names}
    outs = [render(fx.params, fx.scene, fx.pose) for _ in range(3)]
    assert {k: profiling.COUNTERS[k] - before[k] for k in names} == {
        "frame_eager": 3, "frame_replays": 0, "graph_captures": 0}
    with torch.no_grad():
        want = render.frame(render.pack(fx.params), fx.scene,
                            torch.as_tensor(fx.pose, dtype=torch.float32))
    for k, v in want.items():
        assert len({o[k].data_ptr() for o in outs}) == len(outs), k
        for o in outs:
            assert torch.equal(o[k].nan_to_num(), v.nan_to_num()), k


# The headline bench's second serving point: num_neighbor = 2 (bench.py),
# whose refine net reads C = 6 + 3 * 2 * 8 = 54 rows, in both graphs of the
# serving frame.
V2_FORMS = {"default": {}, "transposed": {"transposed": True}}


@pytest.fixture(scope="module")
def two_views():
    return Fixture(ref=[0, 2, 3, 4], num_neighbor=2)


@pytest.mark.parametrize("form", list(V2_FORMS))
def test_frame_renderer_two_neighbours_against_jax(two_views, form):
    """The whole frame at ``num_neighbor = 2`` under the serving statics of
    ``fern_trt.txt`` with ``use_trt`` (bf16, the fused kernels, the whole
    frame in one tile) against the JAX package's frame: the bf16 bound of
    the frame test above (0.02 on every key; the transposed frame's own
    test has the same)."""
    from pronerf_tpu.config import Config as JConfig
    from pronerf_tpu.models import pronerf_t as j_pt
    from pronerf_tpu.render.infer import _infer_statics as j_infer_statics
    from pronerf_tpu_torch.config import Config
    from pronerf_tpu_torch.models import pronerf_t as t_pt
    from pronerf_tpu_torch.render.infer import _infer_statics

    fx = two_views
    over = dict(num_neighbor=2, use_trt=True, tile_rays=0, use_pallas=True)
    statics = dataclasses.replace(_infer_statics(Config.from_file(
        "configs/llff/fern/fern_trt.txt", **over), True), **V2_FORMS[form])
    jstatics = dataclasses.replace(j_infer_statics(JConfig.from_file(
        "configs/llff/fern/fern_trt.txt", **over), True),
        pallas_block_rays=128, **V2_FORMS[form])
    assert (statics.num_neighbor, statics.N_samples) == (2, 8)
    assert statics.use_kernels and statics.compute_dtype == "bfloat16"
    renderer = make_frame_renderer(statics, H, W, fx.sc["K"], 0,
                                   device="cpu")
    refine = renderer.pack(fx.params)["refine_packed"]
    assert refine["w0_t"].shape == (256, 6 + 3 * 2 * 8)
    if form == "transposed":
        perm = t_pt.refine_rest_row_perm(2, 8)
        assert perm == j_pt.refine_rest_row_perm(2, 8)
        assert renderer.pack(fx.params)["refine_packed_t"]["w0_t"].shape \
            == (256, 54)
    got = renderer(fx.params, fx.scene, fx.pose)
    want = j_make_renderer(jstatics, H, W, fx.sc["K"], tile_rays=0)(
        fx.jparams, fx.jscene, jnp.asarray(fx.pose))
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.shape == want[k].shape, k
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k], np.float32),
                                   atol=0.02, err_msg=k)


def served_statics(build):
    """``fern_trt``'s serving statics as the benchmark's viewer cell builds
    them (``RenderStatics.infer(**statics)`` of its configuration), as
    ``infer`` / ``eval --use-trt`` build them (``_infer_statics``), and the
    cell's with ``quant = int8``."""
    if build == "use_trt":
        from pronerf_tpu_torch.config import Config
        from pronerf_tpu_torch.render.infer import _infer_statics

        cfg = Config.from_file("configs/llff/fern/fern_trt.txt",
                               use_trt=True, tile_rays=0, use_pallas=True)
        return _infer_statics(cfg, use_bf16=cfg.use_trt)
    config = json.loads((ROOT / "benchmark/configs/fern_trt.json").read_text())
    statics = config["statics"] | ({"quant": "int8"} if build == "int8"
                                   else {})
    return RenderStatics.infer(**statics)


@pytest.fixture
def nerf_calls(monkeypatch):
    """Calls of the NeRF kernels' plain versions (the ops' CPU
    implementations, which call them through their modules) and of
    ``ops.composite`` from ``render_rays``."""
    from pronerf_tpu_torch.kernels import fused_nerf, fused_nerf_q
    from pronerf_tpu_torch.models import pronerf

    calls = {}
    for mod, name in ((fused_nerf, "fused_nerf_composite_plain"),
                      (fused_nerf, "fused_nerf_raw_plain"),
                      (fused_nerf_q, "fused_nerf_raw_q_plain"),
                      (pronerf, "composite")):
        calls[name] = 0

        def counted(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("build", ["viewer_cell", "use_trt", "int8"])
def test_served_frame_composites_in_the_nerf_kernel(held_out, nerf_calls,
                                                    monkeypatch, build,
                                                    white_bkgd):
    """The served statics composite inside the NeRF kernel: one
    ``fused_nerf_composite`` a frame and no raw kernel (int8: its raw kernel
    and ``ops.composite``). The launch counters of ``profiling.COUNTERS``
    move with the kernels' ``launches`` (on the card one a launch; here the
    ops run their plain versions and neither moves).

    The fused composite's outputs equal ``ops.composite`` over the raw
    values the kernel's chain computed, at the f32 bounds of the tests
    above (NaN disp where a ray's weights are all zero, on both sides)."""
    from pronerf_tpu_torch.kernels import fused_nerf as t_fn
    from pronerf_tpu_torch.ops.composite import composite
    from pronerf_tpu_torch.utils import profiling

    fx = held_out
    statics = dataclasses.replace(served_statics(build),
                                  white_bkgd=white_bkgd)
    assert statics.use_kernels and statics.compute_dtype == "bfloat16"
    int8 = build == "int8"
    kernels = {"nerf_composite_launches": t_fn.fused_nerf_composite_t,
               "nerf_raw_launches": t_fn.fused_nerf_raw_t}
    render = make_frame_renderer(statics, H, W, fx.sc["K"], 0, device="cpu")
    counters = {k: profiling.COUNTERS[k] for k in kernels}
    launches = {k: fn.launches for k, fn in kernels.items()}
    render(fx.params, fx.scene, fx.pose)
    assert nerf_calls == dict(fused_nerf_composite_plain=0 if int8 else 1,
                              fused_nerf_raw_plain=0,
                              fused_nerf_raw_q_plain=int8, composite=int8)
    for k, fn in kernels.items():
        assert (profiling.COUNTERS[k] - counters[k]
                == fn.launches - launches[k] == 0), k
    if int8:
        return

    # the composite's inputs and the chain's raw values, as the kernel's
    # plain version received and computed them
    seen = {}
    plain, chain = t_fn.fused_nerf_composite_plain, t_fn._forward_plain

    def composite_plain(*a, **kw):
        seen["args"] = a
        return plain(*a, **kw)

    def forward_plain(*a):  # raw as fused_nerf_raw_plain builds it
        rgb, sigma = chain(*a)
        seen["raw"] = torch.cat([rgb, sigma[..., None]], dim=-1).float()
        return rgb, sigma

    monkeypatch.setattr(t_fn, "fused_nerf_composite_plain", composite_plain)
    monkeypatch.setattr(t_fn, "_forward_plain", forward_plain)
    with torch.no_grad():
        got = render_rays(render.pack(fx.params), fx.rays, fx.scene,
                          fx.controls, render.statics)
    _, _, _, z_t, mm_add_t, mm_mul_t = seen["args"][:6]
    # the op's tensors as the card's kernel takes them (it raises otherwise)
    for t in seen["args"][1:7]:
        assert t.dtype == torch.float32 and t.is_contiguous()
    want = composite(seen["raw"], z_t.T, fx.rays["ndc_d"], mm_add=mm_add_t.T,
                     mm_mul=mm_mul_t.T, white_bkgd=white_bkgd)
    want["rgb1"], want["sigma"] = want.pop("rgb"), seen["raw"][..., 3]
    for k in ("rgb1", "depth", "acc", "disp", "weights", "sigma"):
        g, w = got[k].numpy(), want[k].numpy()
        assert np.all(np.isnan(g) == np.isnan(w)), k
        atol = {"depth": 5e-4, "disp": 1e-3}.get(k, 5e-5)
        np.testing.assert_allclose(g, w, atol=atol, err_msg=k)


# the kernel path's forms, as replacements of the bf16 kernel statics: the
# served one, int8, the raw-kernel route and the transposed graph, in bf16
# and in f32 (whose MinMax nets run as kernels in that graph alone)
PACKED_FORMS = {"default": {}, "int8": {"quant": "int8"},
                "raw_route": {"clamp_raw": True},
                "transposed": {"transposed": True},
                "transposed_f32": {"transposed": True, "compute_dtype": None}}


@pytest.mark.parametrize("form", list(PACKED_FORMS))
def test_packed_params_render_as_the_raw_ones(held_out, monkeypatch, form):
    """The graph ``graph_for`` picks (``render_rays_t`` for the transposed
    form, ``render_rays`` else) on the nets alone packs what it reads on
    entry, and renders bit for bit what it renders on
    ``pack_serving_params``' output, where no pack function is called."""
    from pronerf_tpu_torch.kernels import fused_minmax, fused_nerf, fused_nerf_q
    from pronerf_tpu_torch.models.pronerf import pack_serving_params
    from pronerf_tpu_torch.models.pronerf_t import graph_for, render_rays_t

    fx = held_out
    statics = dataclasses.replace(RenderStatics.infer(
        compute_dtype="bfloat16", use_kernels=True), **PACKED_FORMS[form])
    graph = graph_for(statics, fx.scene["images"])
    assert (graph is render_rays_t) == form.startswith("transposed")
    packed = pack_serving_params(fx.params, statics)
    args = (fx.rays, fx.scene, fx.controls, statics)
    with torch.no_grad():
        want = graph(fx.params, *args)

        def refuse(*a, **kw):
            raise AssertionError("packed params were packed again")

        for mod, name in ((fused_minmax, "pack_minmax_params"),
                          (fused_nerf, "pack_nerf_params"),
                          (fused_nerf_q, "pack_nerf_params_int8")):
            monkeypatch.setattr(mod, name, refuse)
        got = graph(packed, *args)
    assert set(got) == set(want) == set(KEYS)
    for k in KEYS:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   equal_nan=True, msg=k)


def test_rays_for_pose_matches_jax(held_out):
    rays = rays_for_pose(H, W, held_out.sc["K"], held_out.pose, device="cpu")
    assert set(rays) == set(held_out.jrays)
    for k, v in rays.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(held_out.jrays[k]),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_run_inference_synthetic_on_cpu(tmp_path, capsys, use_kernels):
    from pronerf_tpu_torch.config import Config
    from pronerf_tpu_torch.render.infer import run_inference

    cfg = Config.from_file(
        "configs/llff/fern/fern_trt.txt", datadir="synthetic:24x18x9",
        use_trt=True, tile_rays=0, use_pallas=use_kernels,
        basedir=str(tmp_path), ft_path="")
    result = run_inference(cfg, timing_reps=1, device="cpu")
    out = capsys.readouterr().out
    assert "rendering with random weights" in out and "Total flops:" in out
    assert result["rgbs1"].shape == (2, 18, 24, 3)
    assert len(result["psnrs"]) == 2 and np.all(np.isfinite(result["psnrs"]))
    assert np.all(np.isfinite(result["ssims"])) and len(result["times_ms"]) == 2
    assert np.all(np.isfinite(result["rgbs1"]))
    saved = sorted(p.name for p in
                   (tmp_path / cfg.expname / "renderonly_test").iterdir())
    assert saved[:2] == ["000.png", "001.png"] and "gt_001.png" in saved
    png = (tmp_path / cfg.expname / "renderonly_test" / "000.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    # an LLFF datadir is read (tests/test_torch_data.py); a missing one
    # raises, naming it
    with pytest.raises(FileNotFoundError, match="data/nerf_llff_data/fern"):
        run_inference(cfg.replace(datadir="data/nerf_llff_data/fern"),
                      device="cpu")
    # a checkpoint of the JAX package (flax msgpack) is served: its nets are
    # the ones rendered (tests/test_torch_checkpoint_jax.py holds the frame
    # against the JAX render)
    from pronerf_tpu.train.checkpoint import save_checkpoint as j_save

    jparams = jax.tree_util.tree_map(np.asarray, j_init(jax.random.PRNGKey(3)))
    j_ckpt = j_save(tmp_path / "370000.ckpt", {
        "global_step": np.int32(1), "network_fn": jparams["nerf"],
        "mmr_network_fn": jparams["sampler"],
        "refine_net": jparams["refine"]})
    served = run_inference(cfg.replace(ft_path=j_ckpt, max_images=1),
                           device="cpu")
    assert "Loading weights from" in capsys.readouterr().out
    from pronerf_tpu_torch.render.infer import load_params_for_inference

    params = load_params_for_inference(j_ckpt, cfg, "cpu")
    want = convert.params_from_numpy(jparams)
    for net in ("nerf", "sampler", "refine"):
        for k, v in want[net].state_dict().items():
            assert torch.equal(params[net].state_dict()[k], v), (net, k)
    assert np.all(np.isfinite(served["rgbs1"]))
    assert not np.array_equal(served["rgbs1"], result["rgbs1"][:1])


@pytest.mark.parametrize("name", ["fern_epi.txt", "fern_refine.txt",
                                  "fern_trt.txt"])
def test_own_config_copy_parses_the_release_configs_like_jax(name, capsys):
    from pronerf_tpu import config as j_config
    from pronerf_tpu_torch import config as t_config

    path = f"configs/llff/fern/{name}"
    got = t_config.Config.from_file(path, use_trt=True, tile_rays=None)
    want = j_config.Config.from_file(path, use_trt=True, tile_rays=None)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.tile_rays == 8192 and got.use_trt is True
    assert t_config.Config.field_names() == j_config.Config.field_names()
    assert len(t_config.enforce_flag_contract(got)) == len(
        j_config.enforce_flag_contract(want))
    with pytest.raises(NotImplementedError):
        t_config.enforce_flag_contract(got.replace(render_only=True))
    with pytest.raises(KeyError):
        t_config._coerce(t_config.Config, "no_such_key", "1")


def test_own_synthetic_copy_makes_the_same_scenes():
    from pronerf_tpu.utils import synthetic as j_syn
    from pronerf_tpu_torch.utils import synthetic as t_syn

    assert t_syn.parse_synthetic_spec("synthetic:504x378x17") == \
        j_syn.parse_synthetic_spec("synthetic:504x378x17")
    assert t_syn.parse_synthetic_spec("synthetic") == \
        j_syn.parse_synthetic_spec("synthetic")
    for make_t, make_j in ((t_syn.make_scene, j_syn.make_scene),
                           (t_syn.make_consistent_scene,
                            j_syn.make_consistent_scene)):
        a = make_t(n_views=3, H=10, W=12, seed=5)
        b = make_j(n_views=3, H=10, W=12, seed=5)
        assert a["hwf"] == b["hwf"]
        for k in ("images", "poses", "K", "bds"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pipeline_macs_copy_matches_jax():
    from pronerf_tpu.utils.profiling import pipeline_macs as j_macs
    from pronerf_tpu_torch.utils.profiling import pipeline_macs as t_macs

    assert t_macs(378, 504) == j_macs(378, 504)
    assert t_macs(20, 30, num_neighbor=2, N_samples=4) == \
        j_macs(20, 30, num_neighbor=2, N_samples=4)
