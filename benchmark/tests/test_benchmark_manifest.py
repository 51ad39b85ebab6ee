"""``BENCHMARK.json`` and the files it names: the contract's shapes, every
metric and cell in files of its own found by name, and the harness's
arithmetic (window, percentile, spread, device busy and idle, rooflines,
the mfu) on inputs whose answers are known."""

import json
import re
import shutil
import subprocess
import sys
import types

import pytest

import harness
import work

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_names_units_and_lines():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in MAN[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] in (1, 4)
    for m in MAN["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_configs_files_and_cells_found_by_name():
    cells = {w["name"] for w in MAN["workloads"]}
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        body = harness.load_json("configs", c["name"])
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert (harness.ROOT / body["weights"]).is_file()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        body = harness.load_json("workloads", w["name"])
        for key in ("config", "traffic", "chips", "why"):
            assert body[key] == w[key], key
        assert (harness.BENCH / "traffic" / f"{w['traffic']}.py").is_file()
    assert len(cells) == len(MAN["workloads"])


def test_end_to_end_metrics_and_bounds():
    names = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in names
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        e2e, per_layer = harness.cell_metrics(MAN, cell)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert per_layer


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_declares_what_the_manifest_says(m):
    mod = harness.load_module("metrics", m["name"])
    assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES,
            mod.WORKLOADS) == (m["layer"], m["unit"], m["better"],
                               m["source"], m["moves"], m["workloads"])
    moved = next(e for e in MAN["end_to_end"] if e["name"] == m["moves"])
    for cell in m["workloads"]:
        assert cell in moved.get("workloads", [cell])


def test_statistics():
    assert harness.nearest_rank(list(range(1, 101)), 0.95) == 95
    assert harness.nearest_rank([3.0], 0.95) == 3.0
    assert harness.nearest_rank([5, 1, 4, 2, 3], 0.5) == 3


def fake_trace():
    """Two frames of 10 ms: a nerf kernel, a minmax kernel and a gather
    each, 1 ms idle at each frame's start, a copy at each end."""
    kernels, copies, spans = [], [], []
    for f in range(2):
        t = f * 10_000.0
        spans += [("frame", t, 10_000.0), ("render_frame", t, 3_000.0)]
        kernels += [("void pn::nerf_wg_kernel<false>(float*)", t + 1_000,
                     4_000),
                    ("pn::minmax_wg_kernel<false>(float const*)", t + 5_000,
                     2_000),
                    ("at::native::index_elementwise_kernel", t + 7_000,
                     2_500)]
        copies.append(("Memcpy DtoH", t + 9_500, 500))
    return harness.Trace(kernels, copies, spans, 0.0, 20_000.0, 2)


def test_trace_arithmetic():
    tr = fake_trace()
    assert tr.window_s == pytest.approx(0.02)
    assert tr.device_busy_s() == pytest.approx(0.018)
    assert len(tr.kernels) == 6
    assert tr.kernel_us(("nerf_wg_kernel",)) == pytest.approx(8_000)
    assert tr.kernel_us(("nerf_wg_kernel", "minmax_wg_kernel"),
                        exclude=True) == pytest.approx(5_000)
    assert tr.idle_by_span() == [["render_frame", pytest.approx(0.002)]]
    assert tr.top_ops(1)[0] == ["pn::nerf_wg_kernel<false>", pytest.approx(
        0.008)]


def test_readers_on_a_known_trace(monkeypatch):
    """Each serving reader on ``fake_trace``, where the NeRF and MinMax
    kernels take exactly their bounds and a frame takes 10 ms."""
    cell = harness.load_json("workloads", "fern_trt.view_1008")
    config = harness.load_json("configs", "fern_trt")
    p, st = cell["params"], config["statics"]
    rays, S = p["height"] * p["width"], st["N_samples"]
    nerf_s = work.roofline_s(*work.nerf_kernel(rays, S))
    mm_s = work.roofline_s(*work.minmax_kernel(rays, 6, 3 * S + 3)) \
        + work.roofline_s(*work.minmax_kernel(rays, 102, 4 * S + 3))
    tr = fake_trace()
    tr.kernels = [(n, s, nerf_s * 1e6 if "nerf" in n else
                   mm_s * 1e6 if "minmax" in n else d)
                  for n, s, d in tr.kernels]
    spans = harness.Spans()
    spans.seconds["render_frame"] = [0.003, 0.005]
    outcome = types.SimpleNamespace(
        trace=tr, run=types.SimpleNamespace(cell=cell, config=config,
                                            spans=spans))

    def read(name):
        return harness.load_module("metrics", name).read(outcome)

    assert read("nerf_roofline") == pytest.approx(100.0)
    assert read("minmax_roofline") == pytest.approx(100.0)
    assert read("frame_kernels") == 3
    assert read("frame_host_ms") == pytest.approx(4.0)
    assert read("unfused_ms") == pytest.approx(2.5)
    macs = work.pipeline_macs(p["height"], p["width"])
    assert read("frame_mfu") == pytest.approx(
        100 * 2 * sum(macs.values()) / 0.01 / 989e12)
    outcome.trace = fake_trace()
    assert read("device_idle.serve") == pytest.approx(10.0)
    empty = types.SimpleNamespace(trace=None, run=outcome.run)
    for m in MAN["per_layer"]:
        if m["source"] == "device_trace":
            assert harness.load_module("metrics", m["name"]).read(empty) \
                is None


def test_pipeline_macs_is_the_ports():
    from pronerf_tpu_torch.utils.profiling import pipeline_macs

    assert work.pipeline_macs(756, 1008) == pipeline_macs(756, 1008)


def test_a_cell_and_a_metric_are_added_by_new_files_alone(tmp_path):
    """A copy of the benchmark gains a cell (its workload and traffic
    files) and a per-layer metric (its reader) by new files and manifest
    entries alone; a run of the new cell reports both."""
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    man = json.loads(json.dumps(MAN))
    man["workloads"].append({"name": "toy.cell", "config": "fern_trt",
                             "traffic": "toy", "chips": 1, "why": "a test"})
    man["end_to_end"].append({"name": "toy_ms", "unit": "ms",
                              "better": "lower", "bound": 0.05,
                              "source": "host_clock",
                              "workloads": ["toy.cell"]})
    man["per_layer"].append({"name": "toy.busy", "unit": "%",
                             "better": "higher", "source": "device_trace",
                             "layer": "device", "moves": "toy_ms",
                             "workloads": ["toy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    b = tmp_path / "benchmark"
    (b / "workloads" / "toy.cell.json").write_text(json.dumps(
        {"name": "toy.cell", "config": "fern_trt", "traffic": "toy",
         "chips": 1, "why": "a test", "params": {}, "limits": {"x": 1.0}}))
    (b / "traffic" / "toy.py").write_text(
        "import harness\n"
        "def run(ctx):\n"
        "    tr = harness.Trace([('k', 0.0, 500.0)], [], [('step', 0.0, "
        "1000.0)], 0.0, 1000.0, 1)\n"
        "    return harness.Outcome({'setup_s': 1.0, 'toy_ms': 2.0}, "
        "{'x': (0.5, 1.0)}, 3, 0, 0, None, tr)\n")
    (b / "metrics" / "toy.busy.py").write_text(
        "def read(o):\n"
        "    return 100 * o.trace.device_busy_s() / o.trace.window_s\n")
    code = ("import sys, json\n"
            f"sys.path.insert(0, {str(b)!r})\n"
            "import run\n"
            "for trace in (False, True):\n"
            "    o, m, b = run.run_cell('toy.cell', 1, 0.1, trace, 'cpu')\n"
            "    print(json.dumps([o.correct, m, b]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    plain, traced = [json.loads(x) for x in proc.stdout.splitlines()[-2:]]
    assert plain[0] is True
    assert plain[1] == {"toy_ms": {"value": 2.0, "unit": "ms"},
                        "setup_s": {"value": 1.0, "unit": "s"}}
    assert traced[1] == {"toy.busy": {"value": 50.0, "unit": "%"}}
    assert traced[2]["device_ops"] == [["k", 0.0005]]


def test_training_readers_on_a_known_trace():
    """Two chunks of 8 steps, 40 ms each, the device busy 36 ms of each:
    the step pair takes 10 ms."""
    config = harness.load_json("configs", "fern_epi")
    kernels = [("sgemm", c * 40_000.0 + 2_000, 36_000.0) for c in range(2)]
    tr = harness.Trace(kernels, [], [("chunk", 0.0, 80_000.0)], 0.0,
                       80_000.0, 16)
    spans = harness.Spans()
    spans.seconds["executor"] = [0.004, 0.002]
    outcome = types.SimpleNamespace(trace=tr, run=types.SimpleNamespace(
        config=config, spans=spans, K=8))

    def read(name):
        return harness.load_module("metrics", name).read(outcome)

    assert read("train_host_ms") == pytest.approx(3.0 / 8)
    assert read("device_idle.train") == pytest.approx(10.0)
    assert read("train_mfu") == pytest.approx(
        100 * work.stage1_pair_flops(4096) / 0.01 / 67e12)
