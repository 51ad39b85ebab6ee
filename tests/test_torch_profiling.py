"""The port's timing and tracing helpers (``pronerf_tpu_torch/utils/
profiling.py``) and its spans and counters, on the CPU, where the CUDA-graph
form of ``amortized_timer`` cannot run (the card's run is ``chip_smoke.py
--only multi``):

- ``device_timer``, ``amortized_timer`` (the carry feeds the work) and
  ``trace`` (a Chrome trace on disk, the port's spans in it) run;
- with tracing off ``span`` is one shared object and a profiled frame holds
  no ``pn/`` range; under ``tracing()`` a frame is ``pn/frame`` holding
  ``pn/raygen`` and one span a stage of ``render_rays`` (``render_rays_t``)
  in order, and a scan executor's chunk is ``pn/chunk`` holding ``pn/fill``
  and one ``pn/step.<kind>`` a step;
- ``COUNTERS``: one ``param_packs`` a parameter set, ``kernel_loads`` and
  ``kernel_builds`` where a library is loaded or compiled;
- the windowed gathers' device counters: 0 misses through a covering
  window, the direct count of ``_window_rows`` through a narrow one, the
  colours unchanged by counting; none counted outside
  ``tracing(counters=True)``;
- an export under ``tracing()`` holds no profiler op;
- ``render_path`` with ``timing_reps`` prints the JAX package's
  ``Steady-state render ms/frame`` line, and the frame it times equals the
  renderer's frame.
"""

import contextlib
import json
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pronerf_tpu_torch.config import Config
from pronerf_tpu_torch.kernels import build
from pronerf_tpu_torch.models.pronerf import RenderStatics, init_pronerf_params
from pronerf_tpu_torch.ops import warp
from pronerf_tpu_torch.render.export import export_renderer
from pronerf_tpu_torch.render.raygen import (
    build_ray_pool,
    prepare_scene,
    rays_for_pose,
)
from pronerf_tpu_torch.render.renderer import make_frame_renderer, render_path
from pronerf_tpu_torch.train import fast_loop
from pronerf_tpu_torch.train.stage1 import init_stage1_state
from pronerf_tpu_torch.train.stage2 import init_stage2_state
from pronerf_tpu_torch.utils import profiling
from pronerf_tpu_torch.utils.synthetic import make_scene

torch.set_num_threads(2)

STAGES = ["sampler", "sort", "gather", "refine", "nerf", "composite"]


def pn_ranges(prof):
    """The ``pn/`` ranges of a profile as (name without the prefix, start,
    end), in order of their start."""
    out = [(e.name[3:], e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith("pn/")]
    return sorted(out, key=lambda r: r[1])


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_timers_run_on_the_cpu():
    x = torch.randn(64, 64)
    ms = profiling.device_timer(lambda a: a @ a, x, reps=3)
    assert ms > 0
    calls = []

    def step(c):
        calls.append(1)
        return c + (x * (1.0 + 1e-7 * c)).sum() * 1e-9

    per_iter = profiling.amortized_timer(step, torch.zeros(()), iters=4,
                                         reps=2)
    assert per_iter > 0
    assert len(calls) == 4 * 3  # a warm-up call and two timed, of 4 each
    null = profiling.null_dispatch_ms("cpu", reps=3)
    assert profiling.amortized_timer(step, torch.zeros(()), iters=4, reps=2,
                                     null_ms=1e6) < 0 < null


def test_trace_and_profile_categories_on_the_cpu(tmp_path):
    """``trace`` writes the profiler's Chrome trace with the port's spans
    on inside its block, and off after it."""
    x = torch.randn(128, 128)
    with profiling.trace(tmp_path / "tr") as prof:
        with profiling.span("outer"):
            (x @ x).relu()
    assert prof is not None
    assert profiling.span("outer") is profiling.span("other")
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    events = {e.get("name"): e for e in doc["traceEvents"]}
    assert "aten::mm" in events
    outer = events["pn/outer"]
    assert outer["cat"] == "user_annotation"
    mm = events["aten::mm"]
    assert outer["ts"] <= mm["ts"] <= mm["ts"] + mm["dur"] \
        <= outer["ts"] + outer["dur"]


# ------------------------------------------------------------- frames --

# nets the kernels take (NeRF 8 x 256), a small MinMax depth
KERNEL_NETS = dict(mmnetdepth=2)


@pytest.fixture(scope="module")
def frame_scene():
    sc = make_scene(n_views=5, H=12, W=16, seed=0)
    scene = prepare_scene(sc["images"][1:], sc["poses"][1:], sc["K"],
                          device="cpu")
    params = init_pronerf_params(torch.Generator().manual_seed(0),
                                 device="cpu", **KERNEL_NETS)
    return sc, scene, params


def test_span_is_one_shared_object_while_off(frame_scene):
    a, b = profiling.span("frame"), profiling.span("gather")
    assert a is b and isinstance(a, contextlib.nullcontext)
    sc, scene, params = frame_scene
    H, W, _ = sc["hwf"]
    r = make_frame_renderer(
        RenderStatics.infer(compute_dtype="bfloat16", use_kernels=True),
        H, W, sc["K"], 0, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r(params, scene, sc["poses"][0, :3, :4])
    names = {e.name for e in prof.events()}
    assert "aten::sort" in names
    assert not [n for n in names if n.startswith("pn/")]


FRAME_FORMS = {
    # name: (statics, the stages render_rays runs)
    "row_major": (dict(), STAGES),
    "windowed": (dict(gather_tiles=4, gather_window_rows=3), STAGES),
    # the transposed graph composites inside the NeRF kernel
    "transposed": (dict(transposed=True, gather_tiles=4,
                        gather_window_rows=3), STAGES[:-1]),
}


@pytest.mark.parametrize("form", list(FRAME_FORMS))
def test_frame_spans_nest_in_stage_order(frame_scene, form):
    kw, stages = FRAME_FORMS[form]
    sc, scene, params = frame_scene
    H, W, _ = sc["hwf"]
    r = make_frame_renderer(
        RenderStatics.infer(compute_dtype="bfloat16", use_kernels=True,
                            **kw), H, W, sc["K"], 0, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            profiling.tracing():
        r(params, scene, sc["poses"][0, :3, :4])
    spans = pn_ranges(prof)
    assert [s[0] for s in spans] == ["frame", "raygen"] + stages
    for s in spans[1:]:
        assert inside(s, spans[0]), s
    for a, b in zip(spans[1:], spans[2:]):
        assert a[2] <= b[1], (a, b)  # one after the other
    assert profiling.span("frame") is profiling.span("x")  # off again


def test_param_packs_count_one_pack_per_parameter_set(frame_scene):
    sc, scene, params = frame_scene
    H, W, _ = sc["hwf"]
    other = init_pronerf_params(torch.Generator().manual_seed(1),
                                device="cpu", **KERNEL_NETS)
    r = make_frame_renderer(
        RenderStatics.infer(compute_dtype="bfloat16", use_kernels=True),
        H, W, sc["K"], 0, device="cpu")
    c2w = sc["poses"][0, :3, :4]
    packs = profiling.COUNTERS["param_packs"]
    for p, want in ((params, 1), (params, 1), (params, 1), (other, 2),
                    (other, 2), (params, 3)):
        r(params=p, scene=scene, c2w=c2w)
        assert profiling.COUNTERS["param_packs"] - packs == want


def test_export_under_tracing_holds_no_profiler_op(frame_scene, tmp_path):
    sc, scene, params = frame_scene
    H, W, _ = sc["hwf"]
    with profiling.tracing():
        paths = export_renderer(
            params, scene, tmp_path, H, W, sc["K"], tile_rays=0,
            statics=RenderStatics.infer(compute_dtype="bfloat16",
                                        use_kernels=True),
            arch=KERNEL_NETS, device="cpu")
    program = torch.export.load(paths["executable"])
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert any(t.startswith("pronerf.") for t in targets)
    assert not [t for t in targets if "profiler" in t]


# ------------------------------------------------------------- chunks --

K, N_RAND = 4, 64
SMALL_NETS = dict(netdepth=3, netwidth=64, mmnetdepth=2, mmnetwidth=32)


@pytest.mark.parametrize("stage, kinds", [(1, ["nerf", "sampler"] * 2),
                                          (2, ["joint"] * 4)])
def test_chunk_spans(stage, kinds):
    sc = make_scene(n_views=6, H=18, W=24, seed=0)
    H, W, focal = sc["hwf"]
    scene = prepare_scene(sc["images"], sc["poses"], sc["K"], device="cpu")
    pool, ids = build_ray_pool(sc["images"], sc["poses"], sc["K"],
                               list(range(6)), 4, np.random.default_rng(0))
    pool, ids = torch.from_numpy(pool), torch.from_numpy(ids)
    cfg = Config(N_samples=8, N_point_ray_enc=48, num_neighbor=4,
                 raw_noise_std=1.0, N_rand=N_RAND, **SMALL_NETS)
    params = init_pronerf_params(torch.Generator().manual_seed(0),
                                 device="cpu", **SMALL_NETS)
    state = (init_stage1_state if stage == 1 else init_stage2_state)(params)
    ex = fast_loop.make_scan_executor(cfg, H, W, focal, 6, stage, K)
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            profiling.tracing():
        ex(state, scene, pool, ids, 0, 7)
        fast_loop.device_reshuffle(pool, ids, 3)
    spans = pn_ranges(prof)
    top = [s for s in spans if not any(inside(s, o) for o in spans
                                       if o is not s)]
    assert [s[0] for s in top] == ["chunk", "reshuffle"]
    chunk = top[0]
    level = [s for s in spans if s[0] == "fill" or s[0].startswith("step.")]
    assert [s[0] for s in level] == ["fill"] + [f"step.{k}" for k in kinds]
    for s in level:
        assert inside(s, chunk)
    # each eager step renders its rays inside its step span
    for s in level[1:]:
        assert any(r[0] == "gather" and inside(r, s) for r in spans)


# ----------------------------------------------------------- counters --

@pytest.fixture(scope="module")
def gather_inputs():
    """The windowed gathers' arguments at 24x32: a held-out pose's rays
    (its last 40 the frame renderer's zero-direction pads) and candidate
    depths."""
    H, W = 24, 32
    sc = make_scene(n_views=5, H=H, W=W, seed=0)
    ref = [0, 2, 3, 4]
    scene = prepare_scene(sc["images"][ref], sc["poses"][ref], sc["K"],
                          device="cpu")
    rays = rays_for_pose(H, W, sc["K"], sc["poses"][1, :3, :4], "cpu")
    o, d = rays["or_o"].clone(), rays["or_d"].clone()
    o[-40:], d[-40:] = 0.0, 0.0
    z = torch.from_numpy((1.0 / (1.0 - 0.9 * np.random.default_rng(10)
                                 .random((H * W, 8)))).astype(np.float32))
    return (scene["images"], scene["fused_mats"], scene["K"],
            torch.tensor([2, 0, 3, 1]), o, d, z)


def direct_counts(args, n_tiles, window_rows):
    """(points of live rays in the image, those outside their window), by
    the projections and ``_window_rows`` directly."""
    images, mats, K, vids, o, d, z = args
    T, H, W, _ = images.shape
    N = z.shape[0]
    o, d, z = warp._pad_rays(n_tiles, N, o, d, z, 0)
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    live = (d.abs().sum(dim=-1) > 0)[:, None]
    seen = miss = 0
    for vid in vids:
        xn, yn = warp.project_points(pts, warp._view_matrix(mats, vid), K,
                                     H, W)
        inb, _, y0, _, _ = warp._pixel_coords(xn, yn, H, W)
        _, hit = warp._window_rows(y0, inb, live, n_tiles, window_rows, H,
                                   0)
        seen += int((inb & live)[:N].sum())
        miss += int((inb & live & ~hit)[:N].sum())
    return seen, miss


def gather(args, transposed, n_tiles, window_rows):
    if transposed:
        images, mats, K, vids, o, d, z = args
        return warp.epipolar_colors_shared_t(
            images, mats, K, vids, o.T.contiguous(), d.T.contiguous(),
            z.T.contiguous(), n_tiles=n_tiles, window_rows=window_rows)
    return warp.epipolar_colors_shared_windowed(*args, n_tiles, window_rows)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("window_rows", [24, 3])
def test_window_miss_counter(gather_inputs, transposed, window_rows):
    n_tiles = 5  # 768 rays: a ragged last tile, padded
    seen, miss = direct_counts(gather_inputs, n_tiles, window_rows)
    assert seen > 0
    if window_rows == 24:  # the whole view: no miss
        assert miss == 0
    else:
        assert 0 < miss < seen
    plain = gather(gather_inputs, transposed, n_tiles, window_rows)
    with profiling.tracing(counters=True):
        counted = gather(gather_inputs, transposed, n_tiles, window_rows)
        got = profiling.read_device_counters()
    assert got == {"gather_in_image": seen, "gather_window_miss": miss}
    assert torch.equal(counted, plain)
    # outside the block nothing counts, and spans alone count nothing
    gather(gather_inputs, transposed, n_tiles, window_rows)
    with profiling.tracing():
        gather(gather_inputs, transposed, n_tiles, window_rows)
    assert profiling.read_device_counters() == got


def test_kernel_loads_and_builds_are_counted(tmp_path, monkeypatch):
    """A library compiled counts in ``kernel_builds``, one loaded in
    ``kernel_loads`` (once: a second ``load`` takes the loaded one)."""
    monkeypatch.setenv(build.CACHE_ENV, str(tmp_path))
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(build, "_command", lambda name, out: [
        sys.executable, "-c", f"open({str(out)!r}, 'w').close()"])
    before = dict(profiling.COUNTERS)
    name = build.sources()[0]
    lib = build.load(name)
    assert lib == ("lib", str(build.lib_path(name)))
    assert build.load(name) is lib
    built = profiling.COUNTERS["kernel_builds"] - before.get(
        "kernel_builds", 0)
    assert built == len(build.sources())
    assert profiling.COUNTERS["kernel_loads"] - before.get(
        "kernel_loads", 0) == 1
    assert build.build_all() == {}  # every library there: none compiled
    assert profiling.COUNTERS["kernel_builds"] - before.get(
        "kernel_builds", 0) == built


def test_render_path_prints_the_steady_state_line(capsys):
    sc = make_scene(n_views=5, H=12, W=16, seed=0)
    H, W, _ = sc["hwf"]
    scene = prepare_scene(sc["images"][1:], sc["poses"][1:], sc["K"],
                          device="cpu")
    params = init_pronerf_params(torch.Generator().manual_seed(0),
                                 netdepth=3, netwidth=32, mmnetdepth=2,
                                 mmnetwidth=32, device="cpu")
    statics = RenderStatics.infer()
    res = render_path(sc["poses"][:2, :3, :4], params, scene, statics, H, W,
                      sc["K"], tile_rays=0, timing_reps=3, device="cpu")
    out = capsys.readouterr().out
    assert out.count("Render path time:") == 6
    lines = [ln for ln in out.splitlines()
             if ln.startswith("Steady-state render ms/frame (scan x3 minus ")]
    assert len(lines) == 1 and "ms null dispatch): " in lines[0]
    assert res["amortized_ms"] > 0 and res["null_ms"] > 0
    # the body it times is the renderer's frame
    r = make_frame_renderer(statics, H, W, sc["K"], 0, device="cpu")
    with torch.no_grad():
        body = r.frame(r.pack(params), scene,
                       torch.as_tensor(sc["poses"][0, :3, :4]))
    np.testing.assert_array_equal(body["rgb1"].numpy(), res["rgbs1"][0])
    # no timing, no line
    res = render_path(sc["poses"][:1, :3, :4], params, scene, statics, H, W,
                      sc["K"], tile_rays=0, device="cpu")
    assert "Steady-state" not in capsys.readouterr().out
    assert res["amortized_ms"] is None
