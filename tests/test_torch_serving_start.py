"""The serving process's start: the kernel ops
(``pronerf_tpu_torch/kernels/library.py``) and what a fresh process imports
to serve its first frame, on the CPU (the ops run their plain versions;
``chip_smoke.py --only protocols`` checks the same children on the card,
where the ops launch the kernels).

- in a fresh process, the first frame of every serving form (default,
  ``quant = int8``, ``transposed``, and the raw-kernel route, which the
  kernel path takes where the NeRF kernel cannot composite, here under the
  stage-1 raw clamp; the whole-frame
  gather and the windowed one), ``bench.run_bench``, ``bench_coldstart
  --device cpu`` and the serving verbs of the command line (``eval
  --use-trt``, ``infer --use-trt --timing-reps``, ``render-path --use-trt``)
  leave ``torch._dynamo`` unimported: the ops are registered with
  ``torch.library.Library``, whose implementations are called as they are
  (``torch.library.custom_op`` wraps each one in ``torch._disable_dynamo``,
  which imports ``torch._dynamo`` at the first call);
- the ops' schemas, which exported programs name, are pinned;
- a forward with inputs that require grad equals the plain version, and a
  backward through each op raises;
- a renderer exported on the CPU loads and serves in a fresh process, bit
  for bit.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pronerf_tpu_torch.kernels import depth_sort as ds
from pronerf_tpu_torch.kernels import epipolar_gather as eg
from pronerf_tpu_torch.kernels import fused_minmax as fm
from pronerf_tpu_torch.kernels import fused_nerf as fn
from pronerf_tpu_torch.kernels import fused_nerf_q as fq
from pronerf_tpu_torch.kernels import query_prep as qp
from pronerf_tpu_torch.models.mlp import MinMaxMLP
from pronerf_tpu_torch.models.pronerf import init_pronerf_params
from pronerf_tpu_torch.ops.sampling import sort_sampler_depths

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

# what a child prints last: whether torch._dynamo was imported, and the calls
# of each kernel's plain version (the ops' CPU implementations call them
# through their modules), so that a child shows its frames reached the ops
COUNT_PLAIN = """
import json, sys
import torch
torch.set_num_threads(2)
from pronerf_tpu_torch.kernels import fused_minmax, fused_nerf, fused_nerf_q
PLAIN = {"fused_minmax_plain": fused_minmax, "fused_nerf_raw_plain": fused_nerf,
         "fused_nerf_composite_plain": fused_nerf,
         "fused_nerf_raw_q_plain": fused_nerf_q}
calls = dict.fromkeys(PLAIN, 0)
def counted(name, fn):
    def call(*a, **kw):
        calls[name] += 1
        return fn(*a, **kw)
    return call
for name, mod in PLAIN.items():
    setattr(mod, name, counted(name, getattr(mod, name)))
def report(**extra):
    print(json.dumps({"dynamo": "torch._dynamo" in sys.modules,
                      "calls": calls} | extra))
"""

FRAME = """
import dataclasses
from pronerf_tpu_torch import bench
from pronerf_tpu_torch.render.renderer import make_frame_renderer
form, windowed = sys.argv[1], sys.argv[2] == "windowed"
H, W = 24, 32
s = bench.setup(H=H, W=W, device="cpu")
kw = {"default": {}, "int8": {"quant": "int8"},
      "transposed": {"transposed": True},
      "eager_composite": {"clamp_raw": True}}[form]
if windowed:  # the gather of a 1008x756 frame, at this size
    kw |= {"gather_tiles": 2, "gather_window_rows": 12}
statics = dataclasses.replace(s["statics"], **kw)
render = make_frame_renderer(statics, H, W, s["sc"]["K"], tile_rays=0,
                             device="cpu")
out = render(s["params"], s["scene"], s["c2w"])
report(gather_tiles=render.statics.gather_tiles,
       finite=all(bool(torch.isfinite(v).all()) for v in out.values()))
"""

# the plain versions a frame of each form reaches (the default composites
# inside the NeRF kernel; "eager_composite" is the raw-kernel route, the raw
# kernel and ops.composite)
FORM_CALLS = {
    "default": {"fused_minmax_plain", "fused_nerf_composite_plain"},
    "int8": {"fused_minmax_plain", "fused_nerf_raw_q_plain"},
    "transposed": {"fused_minmax_plain", "fused_nerf_composite_plain"},
    "eager_composite": {"fused_minmax_plain", "fused_nerf_raw_plain"},
}


def _child(body, *args):
    """Run ``COUNT_PLAIN + body`` in a fresh interpreter from the repo's
    root; returns its last JSON line."""
    proc = subprocess.run(
        [sys.executable, "-c", COUNT_PLAIN + body, *map(str, args)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=os.environ | {"PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _reached(calls):
    return {name for name, n in calls.items() if n}


@pytest.mark.parametrize("gather", ["whole", "windowed"])
@pytest.mark.parametrize("form", list(FORM_CALLS))
def test_first_frame_leaves_dynamo_unimported(form, gather):
    got = _child(FRAME, form, gather)
    assert got["finite"]
    assert (got["gather_tiles"] > 0) == (gather == "windowed")
    assert _reached(got["calls"]) == FORM_CALLS[form]
    assert not got["dynamo"]


def test_bench_leaves_dynamo_unimported():
    got = _child("""
from pronerf_tpu_torch import bench
ms, rays_per_s, null, single = bench.run_bench(12, 16, frames_per_loop=2,
                                               reps=1, device="cpu")
report(ms=ms)
""")
    assert got["ms"] > 0
    assert _reached(got["calls"]) == FORM_CALLS["default"]
    assert not got["dynamo"]


def test_bench_coldstart_leaves_dynamo_unimported():
    got = _child("""
from pronerf_tpu_torch.tools import bench_coldstart
line = bench_coldstart.main(["--device", "cpu", "--res", "24x32"])
report(phases=line["phases_s"])
""")
    assert {"first_frame", "reload_first_frame"} <= set(got["phases"])
    assert _reached(got["calls"]) == FORM_CALLS["default"]
    assert not got["dynamo"]


@pytest.fixture(scope="module")
def stage1_checkpoint(tmp_path_factory):
    """A one-step stage-1 checkpoint at the release widths (the kernels
    take 256-wide nets) on a small synthetic scene."""
    from pronerf_tpu_torch.cli import main

    base = tmp_path_factory.mktemp("serving_start")
    main(["train-stage1", "--no-reload", "--max-steps", "1", "--device",
          "cpu", "--", "--datadir", "synthetic:32x24x8", "--basedir",
          str(base), "--expname", "s1", "--mmnetdepth", "2", "--N_rand",
          "128", "--i_testset", "0", "--i_video", "0"])
    return base, sorted((base / "s1").glob("*.ckpt"))[-1]


VERBS = {
    "eval": ["eval", "--use-trt", "--max-images", "1"],
    "infer_timing": ["infer", "--use-trt", "--max-images", "1",
                     "--timing-reps", "2"],
    "render_path": ["render-path", "--use-trt", "--n-frames", "2"],
}


@pytest.mark.parametrize("verb", list(VERBS))
def test_serving_verbs_leave_dynamo_unimported(verb, stage1_checkpoint):
    base, ckpt = stage1_checkpoint
    argv = VERBS[verb] + [
        "--device", "cpu", "--checkpoint", str(ckpt), "--", "--datadir",
        "synthetic:32x24x8", "--basedir", str(base), "--expname", verb,
        "--mmnetdepth", "2"]
    got = _child(f"""
from pronerf_tpu_torch.cli import main
main({argv!r})
report()
""")
    assert _reached(got["calls"]) == FORM_CALLS["default"]
    assert not got["dynamo"]


# ----------------------------------------------------------------- ops --

SCHEMAS = {
    "fused_minmax": "pronerf::fused_minmax(Tensor[] panels, Tensor[] blobs, "
                    "Tensor x_t, bool transpose_out) -> Tensor",
    "fused_nerf_raw": "pronerf::fused_nerf_raw(Tensor[] panels, Tensor[] "
                      "blobs, Tensor pts24_t, Tensor vcon_t, SymInt "
                      "n_samples) -> Tensor",
    "fused_nerf_composite": "pronerf::fused_nerf_composite(Tensor[] panels, "
                            "Tensor[] blobs, Tensor pts24_t, Tensor vcon_t, "
                            "Tensor z_t, Tensor mm_add_t, Tensor mm_mul_t, "
                            "Tensor dnorm_t, SymInt n_samples, bool "
                            "white_bkgd) -> (Tensor, Tensor, Tensor, Tensor, "
                            "Tensor, Tensor)",
    "fused_nerf_raw_q": "pronerf::fused_nerf_raw_q(Tensor[] panels, Tensor[] "
                        "blobs, Tensor pts24_t, Tensor vcon_t, SymInt "
                        "n_samples) -> Tensor",
    "fused_donerf_raw": "pronerf::fused_donerf_raw(Tensor[] panels, "
                        "Tensor[] blobs, Tensor pts24_t, Tensor dcon_t, "
                        "SymInt n_samples) -> Tensor",
    "fused_donerf_composite": "pronerf::fused_donerf_composite(Tensor[] "
                              "panels, Tensor[] blobs, Tensor pts24_t, Tensor "
                              "dcon_t, Tensor z_t, Tensor mm_add_t, Tensor "
                              "mm_mul_t, Tensor dnorm_t, SymInt n_samples, "
                              "bool white_bkgd) -> (Tensor, Tensor, Tensor, "
                              "Tensor, Tensor, Tensor)",
    "epipolar_gather": "pronerf::epipolar_gather(Tensor images, Tensor "
                       "fused_mats, Tensor K, Tensor view_ids, Tensor rays_o, "
                       "Tensor rays_d, Tensor z3d, Tensor head, int n_tiles, "
                       "int window_rows, bool svc, bool count) -> (Tensor, "
                       "Tensor)",
    "depth_sort": "pronerf::depth_sort(Tensor mm_out, SymInt n_samples, "
                  "float near, float far, float ndc_eps) -> (Tensor, Tensor, "
                  "Tensor, Tensor)",
    "query_prep": "pronerf::query_prep(Tensor refine_out, Tensor "
                  "depth_values, Tensor mm_add, Tensor mm_mul, Tensor ndc_o, "
                  "Tensor ndc_d, Tensor viewdirs, Tensor view_w, SymInt "
                  "n_samples, float near, float far, float offset_scale, "
                  "bool add_offsets, SymInt multires_views) -> (Tensor, "
                  "Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
}

OPS = {"fused_minmax": fm.fused_minmax_op,
       "fused_nerf_raw": fn.fused_nerf_raw_op,
       "fused_nerf_composite": fn.fused_nerf_composite_op,
       "fused_nerf_raw_q": fq.fused_nerf_raw_q_op,
       "fused_donerf_raw": fn.fused_donerf_raw_op,
       "fused_donerf_composite": fn.fused_donerf_composite_op,
       "epipolar_gather": eg.epipolar_gather_op,
       "depth_sort": ds.depth_sort_op,
       "query_prep": qp.query_prep_op}


@pytest.mark.parametrize("name", list(SCHEMAS))
def test_op_schema_is_pinned(name):
    op = getattr(torch.ops.pronerf, name).default
    assert str(op._schema) == SCHEMAS[name]
    assert OPS[name] is op


def test_the_export_module_registers_every_op_in_a_fresh_process():
    """A program exported on the card names ``pronerf::epipolar_gather``,
    which ``render_rays`` imports only on the card: importing
    ``render/export.py`` registers every op a saved program may name before
    ``torch.export.load`` resolves them."""
    code = ("import json, torch\n"
            "import pronerf_tpu_torch.render.export\n"
            f"print(json.dumps([hasattr(torch.ops.pronerf, n) "
            f"for n in {list(SCHEMAS)!r}]))")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env=os.environ | {"PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [True] * len(
        SCHEMAS)


def _grad_case(name):
    """``(op args with grad-requiring float inputs, the plain version's
    output on the same inputs)``."""
    g = torch.Generator().manual_seed(7)
    S, N = 3, 7
    if name == "fused_minmax":
        net = MinMaxMLP(2, 256, 6 * 8 + 12, 35, generator=g)
        packed = fm.pack_minmax_params(net, 8, torch.bfloat16)
        x_t = torch.randn(6 + 12, N, generator=g).requires_grad_()
        panels = [packed[n] for n in fm.panel_names(2)]
        return ((panels, [], x_t, True),
                fm.fused_minmax_plain(packed, x_t.detach(), True))
    if name == "depth_sort":
        mm_out = torch.randn(N, 3 * S + 5, generator=g) * 3
        want = sort_sampler_depths(mm_out, S, 0.0, 1.0, 1e-5)
        return (mm_out.requires_grad_(), S, 0.0, 1.0, 1e-5), want
    if name == "query_prep":
        refine_out = torch.randn(N, 4 * S + 5, generator=g)[:, :4 * S + 3]
        depth = torch.sort(torch.rand(N, S, generator=g), dim=-1).values
        rays = [torch.randn(N, 3, generator=g) for _ in range(3)]
        ins = (refine_out, depth, torch.randn(N, S, generator=g),
               torch.rand(N, S, generator=g), *rays,
               torch.randn(128, 283, generator=g)[:, 256:])
        statics = (S, 0.0, 1.0, 1e-2, True, 4)
        want = qp.query_inputs_chain(*ins, *statics)
        return (refine_out.clone().requires_grad_(), *ins[1:], *statics), want
    if name == "epipolar_gather":
        from pronerf_tpu_torch.render.raygen import prepare_scene
        from pronerf_tpu_torch.utils.synthetic import make_scene

        sc = make_scene(n_views=4, H=6, W=8, seed=7)
        scene = prepare_scene(sc["images"], sc["poses"], sc["K"],
                              device="cpu")
        ins = (scene["images"], scene["fused_mats"], scene["K"],
               torch.tensor([1, 0, 3]), torch.randn(N, 3, generator=g) * 0.1,
               torch.randn(N, 3, generator=g) * 0.1 - 1.0,
               torch.rand(N, S, generator=g) * 4 + 1,
               torch.randn(6, N, generator=g))
        want = eg.epipolar_gather_plain(*ins, 2, 3, False, True)
        ins[4].requires_grad_()
        return (*ins, 2, 3, False, True), want
    nerf = init_pronerf_params(g, mmnetdepth=2)["nerf"]
    pts = (torch.rand(3 * S, N, generator=g) * 2 - 1).requires_grad_()
    vcon = torch.randn(128, N, generator=g).requires_grad_()
    if name.startswith("fused_donerf"):
        from pronerf_tpu_torch.models.donerf import init_donerf

        packed = fn.pack_donerf_params(init_donerf(g, D=4, W=32))
        panels = fn._donerf_panels(packed)
        dcon = torch.randn(4, N, generator=g).requires_grad_()
        if name == "fused_donerf_raw":
            return ((panels, [], pts, dcon, S),
                    fn.fused_donerf_raw_plain(packed, pts.detach(),
                                              dcon.detach(), S))
        z = torch.sort(torch.rand(S, N, generator=g), dim=0).values
        extra = (z.requires_grad_(), torch.randn(S, N, generator=g),
                 torch.rand(S, N, generator=g) + 0.5,
                 torch.rand(1, N, generator=g) + 0.5)
        want = fn.fused_donerf_composite_plain(
            packed, pts.detach(), dcon.detach(), z.detach(), *extra[1:], S,
            False)
        return ((panels, [], pts, dcon, *extra, S, False),
                tuple(want[k] for k in fn._COMPOSITE_KEYS))
    if name == "fused_nerf_raw_q":
        packed = fq.pack_nerf_params_int8(nerf)
        return (([packed[n] for n in fq.PANELS], [], pts, vcon, S),
                fq.fused_nerf_raw_q_plain(packed, pts.detach(),
                                          vcon.detach(), S))
    packed = fn.pack_nerf_params(nerf, torch.bfloat16)
    panels = [packed[n] for n in fn._WEIGHT_ORDER]
    if name == "fused_nerf_raw":
        return ((panels, [], pts, vcon, S),
                fn.fused_nerf_raw_plain(packed, pts.detach(), vcon.detach(),
                                        S))
    z = torch.sort(torch.rand(S, N, generator=g), dim=0).values
    extra = (z.requires_grad_(), torch.randn(S, N, generator=g),
             torch.rand(S, N, generator=g) + 0.5,
             torch.rand(1, N, generator=g) + 0.5)
    want = fn.fused_nerf_composite_plain(
        packed, pts.detach(), vcon.detach(), z.detach(), *extra[1:], S,
        False)
    return ((panels, [], pts, vcon, *extra, S, False),
            tuple(want[k] for k in fn._COMPOSITE_KEYS))


@pytest.mark.parametrize("name", list(OPS))
def test_forward_with_grad_inputs_equals_plain_and_backward_raises(name):
    args, want = _grad_case(name)
    got = OPS[name](*args)
    outs = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    assert len(outs) == len(wants)
    for o, w in zip(outs, wants):
        # bit for bit; a ray with no weight has disp 0 / 0 in both
        torch.testing.assert_close(o.detach(), w, rtol=0, atol=0,
                                   equal_nan=True)
    assert outs[0].requires_grad
    with pytest.raises(RuntimeError, match="no autograd formula"):
        sum(o.sum() for o in outs).backward()


# ------------------------------------------------------------- export --

LOAD_AND_SERVE = """
from pronerf_tpu_torch.render.export import load_exported_renderer
export_dir = sys.argv[1]
call, params, scene, manifest = load_exported_renderer(export_dir,
                                                       device="cpu")
c2w = torch.load(f"{export_dir}/c2w.pt")
torch.save(call(params, scene, c2w), f"{export_dir}/served.pt")
report()
"""


def test_exported_renderer_serves_bit_for_bit_in_a_fresh_process(tmp_path):
    from pronerf_tpu_torch.models.pronerf import RenderStatics
    from pronerf_tpu_torch.render.export import export_renderer
    from pronerf_tpu_torch.render.raygen import prepare_scene
    from pronerf_tpu_torch.render.renderer import make_frame_renderer
    from pronerf_tpu_torch.utils.synthetic import make_scene

    sc = make_scene(n_views=5, H=20, W=24, seed=5)
    src = [0, 2, 3, 4]
    scene = prepare_scene(sc["images"][src], sc["poses"][src], sc["K"],
                          device="cpu")
    params = init_pronerf_params(torch.Generator().manual_seed(5),
                                 device="cpu", mmnetdepth=2)
    statics = RenderStatics.infer(compute_dtype="bfloat16",
                                  use_kernels=True)
    export_renderer(params, scene, tmp_path, 20, 24, sc["K"], tile_rays=0,
                    statics=statics, arch=dict(mmnetdepth=2), device="cpu")
    c2w = torch.as_tensor(sc["poses"][1][:3, :4], dtype=torch.float32)
    torch.save(c2w, tmp_path / "c2w.pt")
    want = make_frame_renderer(statics, 20, 24, sc["K"], 0, device="cpu")(
        params, scene, sc["poses"][1][:3, :4])
    got = _child(LOAD_AND_SERVE, tmp_path)
    assert _reached(got["calls"]) == FORM_CALLS["default"]
    served = torch.load(tmp_path / "served.pt")
    assert served.keys() == want.keys()
    for k in want:
        assert torch.equal(served[k], want[k]), k
