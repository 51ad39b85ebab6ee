"""The exported renderer (``pronerf_tpu_torch/render/export.py``, the
``export`` / ``export-trt`` verbs and ``infer --from-export``) and the four
kernels as ``torch.library`` ops, on the CPU (the ops run their plain
versions; ``chip_smoke.py --only export`` runs the programs on the card,
where the ops launch the CUDA kernels).

- the round trip, from the directory and from the ``.pt2`` path, equals the
  live renderer bit for bit: f32 in tiles, bf16, the non-default statics
  (DoNeRF, ``N_samples = 4``, ``num_neighbor = 2``) rebuilt from the
  manifest, and the three kernel forms (default, int8, transposed), whose
  programs name their ``pronerf::`` ops (twins of
  ``tests/test_renderer.py:62-130``);
- the port's exported frame against the JAX package's ``export_renderer``
  + ``load_exported_renderer`` call on converted params;
- the manifest has the JAX manifest's keys;
- ``torch.library.opcheck`` on each op;
- ``export`` then ``infer --from-export`` on a written LLFF capture (twin
  of ``tests/test_cli_llff.py:63-78``);
- a program traced for one device type refuses to load for another.

Tolerance, port against JAX: the frame bounds of ``tests/test_torch_render.py``
for f32 (``atol 5e-5``, ``depth 5e-4``: the JAX test's bounds between its
own two paths), on a held-out pose (the reason stands in that file).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pronerf_tpu.models import RenderStatics as JStatics
from pronerf_tpu.models import init_pronerf_params as j_init
from pronerf_tpu.render import prepare_scene as j_prepare_scene
from pronerf_tpu.render.export import export_renderer as j_export_renderer
from pronerf_tpu.render.export import (
    load_exported_renderer as j_load_exported_renderer,
)
from pronerf_tpu.utils.synthetic import make_scene
from pronerf_tpu_torch import convert
from pronerf_tpu_torch.cli import main
from pronerf_tpu_torch.kernels import fused_minmax as fm
from pronerf_tpu_torch.kernels import fused_nerf as fn
from pronerf_tpu_torch.kernels import fused_nerf_q as fq
from pronerf_tpu_torch.models.mlp import MinMaxMLP
from pronerf_tpu_torch.models.pronerf import RenderStatics, init_pronerf_params
from pronerf_tpu_torch.render.export import (
    expected_artifact_paths,
    export_renderer,
    load_exported_renderer,
    statics_from_manifest,
)
from pronerf_tpu_torch.render.raygen import prepare_scene
from pronerf_tpu_torch.render.renderer import make_frame_renderer

torch.set_num_threads(2)

CPU = "cpu"


def _setup(seed=0, n_views=5, **init_kw):
    sc = make_scene(n_views=n_views, H=20, W=24, seed=seed)
    # source views 0, 2, 3, ...: pose 1 is held out
    src = [i for i in range(n_views) if i != 1]
    scene = prepare_scene(sc["images"][src], sc["poses"][src], sc["K"],
                          device=CPU)
    params = init_pronerf_params(torch.Generator().manual_seed(seed),
                                 device=CPU, **init_kw)
    return sc, scene, params


def _frames_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# small nets where no kernel runs (the kernels take 256-wide ones)
SMALL = dict(netdepth=3, netwidth=32, mmnetdepth=2, mmnetwidth=32)
VARIANTS = {
    # name: (statics, tile_rays, init kwargs, the program's pronerf ops)
    "f32_tiles": (RenderStatics.infer(), 256, SMALL, set()),
    "bf16": (RenderStatics.infer(compute_dtype="bfloat16"), 0, SMALL, set()),
    "donerf_S4_V2": (RenderStatics.infer(netarch="donerf", N_samples=4,
                                         num_neighbor=2), 0,
                     dict(netarch="donerf", N_samples=4, num_neighbor=2,
                          netdepth=4, netwidth=32, mmnetdepth=2,
                          mmnetwidth=32),
                     set()),
    "kernels": (RenderStatics.infer(compute_dtype="bfloat16",
                                    use_kernels=True), 0, dict(mmnetdepth=2),
                {"fused_minmax", "depth_sort", "query_prep",
                 "fused_nerf_composite"}),
    # the raw-kernel route (under the stage-1 raw clamp): the raw kernel
    # and ops.composite
    "kernels_eager_composite": (dataclasses.replace(RenderStatics.infer(
        compute_dtype="bfloat16", use_kernels=True), clamp_raw=True), 0,
        dict(mmnetdepth=2), {"fused_minmax", "depth_sort", "query_prep",
                              "fused_nerf_raw"}),
    "kernels_int8": (RenderStatics.infer(compute_dtype="bfloat16",
                                         use_kernels=True, quant="int8"), 0,
                     dict(mmnetdepth=2),
                     {"fused_minmax", "depth_sort", "query_prep",
                      "fused_nerf_raw_q"}),
    "kernels_transposed": (RenderStatics.infer(
        compute_dtype="bfloat16", use_kernels=True, transposed=True), 0,
        dict(mmnetdepth=2),
        {"fused_minmax", "fused_nerf_composite"}),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_export_roundtrip_equals_the_live_renderer(name, tmp_path):
    statics, tile, init_kw, ops = VARIANTS[name]
    sc, scene, params = _setup(seed=len(name), **init_kw)
    H, W, _ = sc["hwf"]
    paths = export_renderer(params, scene, tmp_path, H, W, sc["K"],
                            tile_rays=tile, statics=statics, arch=init_kw,
                            device=CPU)
    assert paths == expected_artifact_paths(tmp_path)
    for p in paths.values():
        assert p.exists(), p
    live = make_frame_renderer(statics, H, W, sc["K"], tile, device=CPU)
    c2w = sc["poses"][1][:3, :4]
    want = live(params, scene, c2w)
    for where in (tmp_path, paths["executable"]):
        call, loaded, loaded_scene, manifest = load_exported_renderer(
            where, device=CPU)
        assert statics_from_manifest(manifest) == live.statics
        assert manifest["H"] == H and manifest["platforms"] == ["cpu"]
        assert manifest["compute_dtype"] == (statics.compute_dtype
                                             or "float32")
        # served purely from the artifact: bundled params and scene
        _frames_equal(call(loaded, loaded_scene, c2w), want)
    # the live params through the program too, and the program names the
    # kernels' ops
    _frames_equal(call(params, scene, c2w), want)
    program = torch.export.load(paths["executable"])
    named = {str(n.target).split(".")[1] for n in program.graph.nodes
             if n.op == "call_function"
             and str(n.target).startswith("pronerf.")}
    assert named == ops


def test_exported_frame_against_jax_export(tmp_path):
    sc = make_scene(n_views=5, H=16, W=20, seed=0)
    H, W, _ = sc["hwf"]
    src = [0, 2, 3, 4]
    jparams = j_init(jax.random.PRNGKey(0), **SMALL)
    jscene = j_prepare_scene(sc["images"][src], sc["poses"][src], sc["K"])
    j_export_renderer(jparams, jscene, tmp_path / "jax", H, W, sc["K"],
                      tile_rays=0, statics=JStatics.infer())
    jcall, jp, js, jman = j_load_exported_renderer(tmp_path / "jax")
    c2w = sc["poses"][1][:3, :4]
    want = jcall(jp, js, jnp.asarray(c2w))

    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams))
    scene = prepare_scene(sc["images"][src], sc["poses"][src], sc["K"],
                          device=CPU)
    export_renderer(params, scene, tmp_path / "port", H, W, sc["K"],
                    tile_rays=0, statics=RenderStatics.infer(),
                    arch=SMALL, device=CPU)
    call, tp, ts, man = load_exported_renderer(tmp_path / "port", device=CPU)
    got = call(tp, ts, c2w)
    for k in ("rgb1", "rgb0", "depth", "mm_rgb", "depth0"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=5e-4 if k == "depth" else 5e-5,
                                   err_msg=k)
    # the manifest's keys are the JAX manifest's; its statics too, but for
    # the kernels' switch, named by each package (use_pallas, use_kernels),
    # and the two JAX fields the port does not carry (its composite switch
    # and its Pallas block of rays)
    assert set(man) == set(jman)
    rename = {"use_kernels": "use_pallas"}
    assert {rename.get(k, k) for k in man["statics"]} == set(
        jman["statics"]) - {"fuse_composite", "pallas_block_rays"}
    assert json.loads((tmp_path / "port" / "manifest.json").read_text()) == \
        man


# ----------------------------------------------------------------- ops --

def _minmax_args(dtype):
    net = MinMaxMLP(2, 256, 6 * 8 + 12, 35,
                    generator=torch.Generator().manual_seed(0))
    packed = fm.pack_minmax_params(net, 8, dtype)
    x_t = torch.randn(6 + 12, 11, generator=torch.Generator().manual_seed(1))
    panels = [packed[n] for n in fm.panel_names(fm._depth(packed))]
    return panels, x_t


def _nerf_args(S=3, N=7, int8=False):
    nerf = init_pronerf_params(torch.Generator().manual_seed(2),
                               mmnetdepth=2)["nerf"]
    g = torch.Generator().manual_seed(3)
    pts = torch.rand(3 * S, N, generator=g) * 2 - 1
    vcon = torch.randn(128, N, generator=g)
    if int8:
        packed = fq.pack_nerf_params_int8(nerf)
        return [packed[n] for n in fq.PANELS], pts, vcon
    packed = fn.pack_nerf_params(nerf, torch.bfloat16)
    return [packed[n] for n in fn._WEIGHT_ORDER], pts, vcon


def _donerf_args(S, N):
    from pronerf_tpu_torch.models.donerf import init_donerf

    packed = fn.pack_donerf_params(
        init_donerf(torch.Generator().manual_seed(2), D=4, W=32))
    g = torch.Generator().manual_seed(3)
    return (fn._donerf_panels(packed), torch.rand(3 * S, N, generator=g) * 2
            - 1, torch.randn(4, N, generator=g))


@pytest.mark.parametrize("op", ["fused_minmax", "fused_minmax_f32",
                                "fused_nerf_raw", "fused_nerf_composite",
                                "fused_nerf_raw_q", "fused_donerf_raw",
                                "fused_donerf_composite"])
def test_opcheck(op):
    if op.startswith("fused_minmax"):
        dtype = torch.float32 if op.endswith("f32") else torch.bfloat16
        panels, x_t = _minmax_args(dtype)
        for transpose_out in (True, False):
            torch.library.opcheck(fm.fused_minmax_op,
                                  (panels, [], x_t, transpose_out))
        want = fm.fused_minmax_plain(dict(zip(fm.panel_names(2), panels)),
                                     x_t)
        assert torch.equal(fm.fused_minmax_op(panels, [], x_t, True), want)
        return
    S, N = 3, 7
    donerf = op.startswith("fused_donerf")
    panels, pts, vcon = (_donerf_args(S, N) if donerf
                         else _nerf_args(S, N, int8=op.endswith("_q")))
    if op.endswith("_composite"):
        comp_op = fn.fused_donerf_composite_op if donerf \
            else fn.fused_nerf_composite_op
        g = torch.Generator().manual_seed(4)
        z = torch.sort(torch.rand(S, N, generator=g), dim=0).values
        # mm_mul > 0: every ray has weight, so no disp is 0 / 0 (NaN,
        # which no two runs compare equal on)
        extra = (z, torch.randn(S, N, generator=g),
                 torch.rand(S, N, generator=g) + 0.5,
                 torch.rand(1, N, generator=g) + 0.5)
        if donerf:  # Kaiming logits of a few units: sigma + mm_add > 0
            extra = (z, extra[1].abs() + 10.0, *extra[2:])
        torch.library.opcheck(comp_op,
                              (panels, [], pts, vcon, *extra, S, False))
        out = comp_op(panels, [], pts, vcon, *extra, S, True)
        assert [tuple(t.shape) for t in out] == [
            (N, 3), (N,), (N,), (N,), (N, S), (N, S)]
        return
    opf = (fn.fused_donerf_raw_op if donerf else fq.fused_nerf_raw_q_op
           if op.endswith("_q") else fn.fused_nerf_raw_op)
    torch.library.opcheck(opf, (panels, [], pts, vcon, S))
    assert tuple(opf(panels, [], pts, vcon, S).shape) == (N, S, 4)


def test_ops_count_no_launch_on_the_cpu():
    panels, x_t = _minmax_args(torch.bfloat16)
    before = fm.fused_minmax_t.launches
    fm.fused_minmax_op(panels, [], x_t, True)
    assert fm.fused_minmax_t.launches == before
    # a pack on the CPU carries no kernel blob; the wrappers hand the ops
    # none there
    packed = fm.pack_minmax_params(
        MinMaxMLP(2, 256, 60, 35, generator=torch.Generator()), 8)
    assert fm.BLOBS_KEY not in packed


# ------------------------------------------------------ command line --

@pytest.fixture(scope="module")
def llff_root(tmp_path_factory):
    from pronerf_tpu.utils.fixtures import (
        write_colmap_model,
        write_llff_dataset,
    )

    root = tmp_path_factory.mktemp("llff_export")
    write_llff_dataset(root, n=8, H=32, W=40, focal=36.0)
    write_colmap_model(root, n_images=8, n_points=50)
    return root


def _common(root, basedir, expname):
    return ["--device", "cpu", "--", "--datadir", str(root), "--factor", "1",
            "--basedir", str(basedir), "--expname", expname, "--N_rand",
            "128", "--i_print", "1", "--i_weights", "2", "--i_testset", "0",
            "--mmnetdepth", "2"]


def test_export_then_infer_from_export_on_a_capture(llff_root, tmp_path,
                                                    capsys):
    main(["train-stage1", "--no-reload", "--max-steps", "2"]
         + _common(llff_root, tmp_path, "s1"))
    ck = sorted((tmp_path / "s1").glob("*.ckpt"))[-1]
    capsys.readouterr()
    # export at the data resolution with the serving statics, then serve
    # from the artifact
    paths = main(["export", "--use-trt", "--checkpoint", str(ck),
                  "--height", "32", "--width", "40"]
                 + _common(llff_root, tmp_path, "exp"))
    export_dir = tmp_path / "exp" / "export"
    assert paths["executable"] == export_dir / "render_frame.pt2"
    assert f"Exported AOT renderer to {paths['executable']}" in \
        capsys.readouterr().out
    res = main(["infer", "--from-export", str(export_dir), "--max-images",
                "1", "--timing-reps", "2"]
               + _common(llff_root, tmp_path, "exp"))
    out = capsys.readouterr().out
    assert "Mean Test PSNR" in out and "Pipelined render ms/frame" in out
    assert len(res["times_ms"]) == 2 and np.isfinite(res["pipelined_ms"])
    pngs = sorted((tmp_path / "exp" / "export_test").glob("*.png"))
    assert [p.name for p in pngs] == ["000.png"]
    # the served frame is the eval frame of the same checkpoint
    ev = main(["eval", "--use-trt", "--max-images", "1", "--checkpoint",
               str(ck)] + _common(llff_root, tmp_path, "ev"))
    from pronerf_tpu_torch.ops.metrics import to8b
    from pronerf_tpu_torch.utils.png import read_png

    np.testing.assert_array_equal(read_png(pngs[0]), to8b(ev["rgbs1"][0]))
    assert res["psnrs"] == pytest.approx(ev["psnrs"], abs=0)


def test_a_program_loads_only_for_its_device_type(tmp_path, monkeypatch):
    sc, scene, params = _setup()
    H, W, _ = sc["hwf"]
    export_renderer(params, scene, tmp_path, H, W, sc["K"], tile_rays=0,
                    device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match=r"exported for \['cpu'\]"):
        load_exported_renderer(tmp_path, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_exported_renderer(tmp_path)  # the card is the default
