"""The port's headline bench (``pronerf_tpu_torch/bench.py``) against the
JAX package's root ``bench.py`` on the CPU.

- the configuration, the statics and the scene arrays of each of the three
  points equal those ``run_bench`` builds (the scene's f32 matrices within
  one unit in the last place);
- the frame the bench times, at a small size with JAX's weights carried over
  by ``convert.params_from_numpy``, matches JAX's frame renderer under the
  same statics (the port's kernels as their plain versions, JAX's Pallas
  kernels in interpret mode) within ``tests/test_torch_render.py``'s bound
  for the bf16 serving frame: 0.02 on every key;
- ``pipeline_macs`` equals JAX's at the three points;
- the JSON line has JAX's keys, less the two groups the port does not carry
  over (``_codesign_quality_delta``'s and ``_v_curve_summary``'s), and the
  same numbers from the same measurements; the peak lookup.
"""

import dataclasses
import importlib.util
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pronerf_tpu.cli import DEFAULT_TRT_CONFIG as J_TRT
from pronerf_tpu.config import Config as JConfig
from pronerf_tpu.models import init_pronerf_params as j_init
from pronerf_tpu.render import prepare_scene as j_prepare_scene
from pronerf_tpu.render.infer import _infer_statics as j_infer_statics
from pronerf_tpu.render.renderer import make_frame_renderer as j_renderer
from pronerf_tpu.utils.profiling import pipeline_macs as j_macs
from pronerf_tpu.utils.synthetic import make_scene as j_make_scene
from pronerf_tpu_torch import bench, convert
from pronerf_tpu_torch.utils.profiling import pipeline_macs
from torch_jax_pe import jax_kernels_with_f32_pe  # noqa: F401 (autouse: f32 PE)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
# (H, W, num_neighbor) of the three points
POINTS = [(378, 504, 4), (756, 1008, 4), (756, 1008, 2)]


def jax_bench():
    spec = importlib.util.spec_from_file_location("jax_root_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_setup(num_neighbor):
    """The configuration and statics of ``bench.py:run_bench``."""
    cfg = JConfig.from_file(
        J_TRT, datadir="synthetic", use_trt=True, tile_rays=0,
        use_pallas=True, N_samples=8, num_neighbor=num_neighbor)
    return cfg, j_infer_statics(cfg, use_bf16=True)


@pytest.mark.parametrize("num_neighbor", [4, 2])
def test_config_and_statics_equal_run_bench(num_neighbor):
    jcfg, jst = jax_setup(num_neighbor)
    cfg, st = bench.bench_config(num_neighbor)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    j = dataclasses.asdict(jst)
    t = dataclasses.asdict(st)
    assert j.pop("use_pallas") == t.pop("use_kernels") is True
    # the JAX twin's fields the port does not carry: its composite switch
    # (the port's served frame composites inside the NeRF kernel; JAX's
    # keeps its v5e default, off) and its Pallas block of rays
    assert j.pop("fuse_composite") is False
    j.pop("pallas_block_rays")
    assert j == t
    assert (st.compute_dtype, st.num_neighbor) == ("bfloat16", num_neighbor)


@pytest.mark.parametrize("H,W", [(24, 32), (378, 504)])
def test_scene_arrays_equal_run_bench(H, W):
    """Bit for bit, but ``fused_mats`` (the views' world-to-camera
    matrices, products of f32 matrices taken in another order): within
    2 ** -24, one unit in the last place at their largest size, 1."""
    s = bench.setup(H, W, device="cpu")
    sc = j_make_scene(n_views=17, H=H, W=W, focal=0.8 * W, seed=0)
    want = j_prepare_scene(sc["images"], sc["poses"], sc["K"],
                           pack_corners="u8")
    assert set(s["scene"]) == set(want)
    for k, v in want.items():
        got = s["scene"][k].numpy()
        assert got.dtype == np.asarray(v).dtype and got.shape == v.shape, k
        if k == "fused_mats":
            assert np.abs(np.asarray(v)).max() <= 1.0
            np.testing.assert_allclose(got, np.asarray(v), rtol=0,
                                       atol=2.0 ** -24)
        else:
            np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(s["sc"]["K"], sc["K"])
    np.testing.assert_array_equal(s["c2w"].numpy(), sc["poses"][0])


def test_default_params_are_seeded_release_widths():
    a = bench.setup(12, 16, device="cpu")["params"]
    b = bench.setup(12, 16, device="cpu")["params"]
    assert a["nerf"].state_dict().keys() == b["nerf"].state_dict().keys()
    for net in a:
        for k, v in a[net].state_dict().items():
            assert torch.equal(v, b[net].state_dict()[k]), (net, k)
    refine = a["refine"].state_dict()
    w0 = next(v for k, v in refine.items() if v.dim() == 2)
    assert 256 in w0.shape  # the release width


@pytest.mark.parametrize("num_neighbor", [4, 2])
def test_bench_frame_matches_jax_renderer(num_neighbor):
    """The frame ``run_bench`` times (first view's pose, whole frame in one
    tile, the serving statics) at 24x32, the port against JAX."""
    H, W = 24, 32
    jparams = j_init(jax.random.PRNGKey(0), N_samples=8,
                     num_neighbor=num_neighbor)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams))
    s = bench.setup(H, W, num_neighbor=num_neighbor, device="cpu",
                    params=params)
    got = s["renderer"](s["params"], s["scene"], s["c2w"])
    _, jst = jax_setup(num_neighbor)
    sc = j_make_scene(n_views=17, H=H, W=W, focal=0.8 * W, seed=0)
    jscene = j_prepare_scene(sc["images"], sc["poses"], sc["K"],
                             pack_corners="u8")
    want = j_renderer(dataclasses.replace(jst, pallas_block_rays=128), H, W,
                      sc["K"], tile_rays=0, unroll=True)(
        jparams, jscene, jnp.asarray(sc["poses"][0]))
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.shape == want[k].shape, k
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k], np.float32),
                                   atol=0.02, err_msg=k)


def test_run_bench_on_the_cpu_returns_its_four_numbers():
    ms, rays_per_s, null, single = bench.run_bench(
        12, 16, frames_per_loop=2, reps=1, device="cpu")
    assert ms > 0 and single > 0 and null >= 0
    assert rays_per_s == pytest.approx(12 * 16 / ms * 1e3)


@pytest.mark.parametrize("H,W,num_neighbor", POINTS)
def test_pipeline_macs_equal_jax_at_the_three_points(H, W, num_neighbor):
    assert pipeline_macs(H, W, num_neighbor=num_neighbor) == \
        j_macs(H, W, num_neighbor=num_neighbor)


# what each point's run_bench returns, in the order the mains call it
FAKE = [(9.5, 378 * 504 / 9.5 * 1e3, 0.04, 12.25),
        (37.75, 756 * 1008 / 37.75 * 1e3, 0.05, 41.5),
        (30.5, 756 * 1008 / 30.5 * 1e3, 0.05, 33.0)]


def fake_runs(calls):
    def run_bench(H=378, W=504, frames_per_loop=6, reps=4, num_neighbor=4,
                  **kw):
        calls.append((H, W, frames_per_loop, reps, num_neighbor))
        return FAKE[len(calls) - 1]
    return run_bench


def json_line(fn):
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn()
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_json_line_has_jax_keys_and_numbers(monkeypatch):
    jb = jax_bench()
    jcalls, tcalls = [], []
    monkeypatch.setattr(jb, "run_bench", fake_runs(jcalls))
    monkeypatch.setattr(jb, "_codesign_quality_delta", lambda: {})
    monkeypatch.setattr(jb, "_v_curve_summary", lambda: {})
    want = json_line(jb.main)
    monkeypatch.setattr(bench, "run_bench", fake_runs(tcalls))
    got = json_line(lambda: bench.main(["--device", "cpu"]))
    # the same three points, with the same frames a loop and loops
    assert tcalls == jcalls == [(378, 504, 6, 4, 4), (756, 1008, 4, 3, 4),
                                (756, 1008, 4, 3, 2)]
    assert list(got) == list(want)
    assert list(got["extra"]) == list(want["extra"])
    assert got["metric"] == want["metric"] == \
        "llff_fern_504x378_render_ms_per_frame_bf16"
    text = ("single_dispatch_protocol", "serving_config", "repro_cli")
    for k, v in want["extra"].items():
        if k not in text:
            assert got["extra"][k] == v, k
    for k in ("value", "unit", "vs_baseline"):
        assert got[k] == want[k], k
    assert "pronerf_tpu_torch.cli" in got["extra"]["repro_cli"]
    assert "tunnel" not in json.dumps(got)
    assert not any(k.endswith("_error") for k in got["extra"])


def test_dropped_groups_are_only_the_tpu_probe_keys(monkeypatch):
    """With its probe logs read, JAX's line holds the two groups' keys;
    the port's line is JAX's without them."""
    jb = jax_bench()
    monkeypatch.setattr(jb, "run_bench", fake_runs([]))
    full = json_line(jb.main)["extra"]
    monkeypatch.setattr(bench, "run_bench", fake_runs([]))
    got = json_line(lambda: bench.main(["--device", "cpu"]))["extra"]
    dropped = set(full) - set(got)
    assert set(got) <= set(full)
    assert all(k.startswith(("fast_v2_", "v_curve_")) for k in dropped)
    assert set(jb._codesign_quality_delta()) | set(jb._v_curve_summary()) \
        == dropped


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989.0), ("NVIDIA H100 SXM5 80GB", 989.0),
    ("NVIDIA H100 PCIe", None), ("NVIDIA A100-SXM4-80GB", None),
    ("cpu", None)])
def test_peak_lookup(name, peak):
    assert bench.peak_tflops(name) == peak
    line = bench.result_line(dict(zip(("headline", "full_res", "fast_v2"),
                                      FAKE)), name)
    assert line["extra"]["device_kind"] == name
    if peak is None:
        assert "model_flop_util" not in line["extra"]
    else:
        tflops = 2.0 * sum(pipeline_macs(378, 504).values()) / 9.5e-3 / 1e12
        assert line["extra"]["model_flop_util"] == round(tflops / peak, 4)
