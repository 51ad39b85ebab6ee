"""The port's timing and tracing helpers (``pronerf_tpu_torch/utils/
profiling.py``) on the CPU, where the CUDA-graph form of ``amortized_timer``
cannot run (the card's run is ``chip_smoke.py --only multi``):

- ``aggregate_events`` against the JAX package's ``aggregate_xplane_events``
  on the same event lists (the JAX test's case, and seeded random ones);
- ``kernel_category`` on the port's kernel names and PyTorch's;
- ``device_timer``, ``amortized_timer`` (the carry feeds the work),
  ``trace`` (a Chrome trace on disk) and ``profile_categories`` run;
- ``render_path`` with ``timing_reps`` prints the JAX package's
  ``Steady-state render ms/frame`` line, and the frame it times equals the
  renderer's frame.
"""

import json

import numpy as np
import pytest
import torch

from pronerf_tpu.utils.profiling import aggregate_xplane_events
from pronerf_tpu_torch.models.pronerf import RenderStatics, init_pronerf_params
from pronerf_tpu_torch.render.raygen import prepare_scene
from pronerf_tpu_torch.render.renderer import make_frame_renderer, render_path
from pronerf_tpu_torch.utils import profiling
from pronerf_tpu_torch.utils.synthetic import make_scene

torch.set_num_threads(2)


def _category(name):
    head = name.lstrip("%").split(" ")[0].split(".")[0]
    for stem in ("fused_nerf", "while", "conditional", "call", "copy"):
        if head.startswith(stem):
            return stem
    return "fusion" if "fusion" in head else head


JAX_CASE = [("%fused_nerf.1", 700), ("%copy.3", 200),
            ("%loop_body_fusion.2", 100), ("%while.1", 1000),
            ("%conditional.7", 50), ("%call.2", 25)]


def _random_events(seed):
    rng = np.random.default_rng(seed)
    names = ["%fused_nerf.1", "%copy.2", "%while.3", "%call.4", "%add.5",
             "%loop_fusion.6", "%conditional.7", "%sort.8"]
    return [(names[i], int(d)) for i, d in zip(
        rng.integers(0, len(names), 40), rng.integers(1, 10_000, 40))]


@pytest.mark.parametrize("events", [JAX_CASE] + [_random_events(s)
                                                 for s in range(3)])
def test_aggregate_events_equals_jax(events):
    got = profiling.aggregate_events(events, _category)
    want = aggregate_xplane_events(events, _category)
    assert got == want
    per_cat, _, total = got
    assert total == sum(d for n, d in events
                        if _category(n) not in ("while", "conditional",
                                                "call"))
    assert "while" not in per_cat


def test_kernel_category():
    cat = profiling.kernel_category
    assert cat("void nerf_wg_kernel<false>(Params)") == "nerf_wg_kernel"
    assert cat("nerf_q_wg_kernel(QParams)") == "nerf_q_wg_kernel"
    assert cat("minmax_wg_kernel(MParams)") == "minmax_wg_kernel"
    assert cat("void at::native::vectorized_elementwise_kernel<4, "
               "at::native::AddFunctor<float>>(int)") == \
        "at::native::vectorized_elementwise_kernel"
    assert cat("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n") == "gemm"
    assert cat("aten::mul") == "aten::mul"


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
    x = torch.randn(128, 128)
    with profiling.trace(tmp_path / "tr") as prof:
        (x @ x).relu()
    assert prof is not None
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "aten::mm" in names
    per_cat, per_op, total = profiling.profile_categories(
        lambda i: (x @ x + i).relu(), iters=2)
    assert total > 0 and total == sum(per_op.values())
    assert per_cat["aten::mm"] > 0


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
