"""The port's release rehearsal and cold-start tools
(``pronerf_tpu_torch/tools/rehearse_release.py``, ``bench_coldstart.py``)
against the JAX package's ``scripts/rehearse_release.py`` and
``scripts/bench_coldstart.py``, on the CPU.

- the rehearsal runs the JAX script's stages with the same commands (apart
  from the module name and ``--device``), logs, sidecar-resumable runner,
  output parsing and results keys: both mains are driven with their stage
  runner swapped for a recorder that answers each stage with the lines the
  command line prints; its flags and defaults are JAX's; its raw capture
  equals JAX's, and loads at factor 4 with PIL unimportable;
- the cold-start tool's phases map one to one onto the JAX script's, the
  phase with no counterpart is listed as absent with its reason, and a run
  on the CPU prints every phase it can measure;
- ``PRONERF_KERNEL_CACHE`` moves the kernels' build directory.
"""

import importlib.util
import io
import json
import pathlib
import re
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from pronerf_tpu_torch.kernels import build
from pronerf_tpu_torch.tools import bench_coldstart as cs
from pronerf_tpu_torch.tools import rehearse_release as rr
from pronerf_tpu_torch.utils.png import read_png

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# what each stage's command line prints, as far as the rehearsal reads it
STAGE_OUT = {
    "eval_timed": "Mean Test PSNR 25.5\nMean Test PSNR 24.25\n"
                  "Median per-dispatch ms/frame (x): 12.5\n"
                  "Median render ms/frame: 9.125 (20.88 Mrays/s, "
                  "steady-state)\n",
    "export": "Exported AOT renderer to /x/full/export/render_frame.pt2\n",
    "infer_export": "Pipelined render ms/frame (x5 async minus 0.050 ms "
                    "null dispatch): 40.5\n",
    "export_datares": "Exported AOT renderer to /x/data/export/"
                      "render_frame.pt2\n",
    "infer_export_datares": "Mean Test PSNR 26.75\n",
}


def recorder(calls):
    def run(cmd, log_path):
        stage = pathlib.Path(log_path).stem
        calls.append((list(cmd), pathlib.Path(log_path).name))
        return STAGE_OUT.get(stage, ""), 1.5 + len(calls)
    return run


def drive_both(tmp_path, monkeypatch, extra=()):
    root, base = tmp_path / "capture", tmp_path / "logs"
    ckpt_dir = base / rr.S2_EXPNAME
    ckpt_dir.mkdir(parents=True)
    (ckpt_dir / "000004.ckpt").write_bytes(b"")
    jmod = _load("rehearse_release")
    jcalls, tcalls = [], []
    monkeypatch.setattr(jmod, "REPO", tmp_path)
    monkeypatch.setattr(jmod, "run", recorder(jcalls))
    monkeypatch.setattr(jmod, "build_dataset", lambda *a: None)
    (tmp_path / "results").mkdir()
    argv = ["--root", str(root), "--basedir", str(base), *extra]
    monkeypatch.setattr(sys, "argv", ["rehearse_release.py", *argv])
    with redirect_stdout(io.StringIO()):
        jmod.main()
    jres = json.loads((tmp_path / "results/rehearsal_fern.json").read_text())
    monkeypatch.setattr(rr, "run", recorder(tcalls))
    monkeypatch.setattr(rr, "build_dataset", lambda *a: None)
    with redirect_stdout(io.StringIO()):
        tres = rr.main([*argv, "--device", "cpu"])
    return jcalls, tcalls, jres, tres, base


def as_jax(cmd):
    """A port command with the module renamed and ``--device`` dropped."""
    out = [("pronerf_tpu.cli" if a == "pronerf_tpu_torch.cli" else a)
           for a in cmd]
    i = out.index("--device")
    return out[:i] + out[i + 2:]


@pytest.mark.parametrize("extra", [(), ("--s1", "8", "--s2", "4", "--scan",
                                        "4")])
def test_rehearsal_stages_are_jax_commands(tmp_path, monkeypatch, extra):
    jcalls, tcalls, _, _, _ = drive_both(tmp_path, monkeypatch, extra)
    assert len(tcalls) == len(jcalls) == len(rr.STAGES) == 8
    for (tcmd, tlog), (jcmd, jlog), stage in zip(tcalls, jcalls, rr.STAGES):
        assert tlog == jlog == f"{stage}.log"
        assert as_jax(tcmd) == jcmd, stage
        assert tcmd[tcmd.index("--device") + 1] == "cpu"
        assert tcmd[1:3] == ["-m", "pronerf_tpu_torch.cli"]


def test_rehearsal_results_have_jax_keys_and_readings(tmp_path, monkeypatch):
    _, _, jres, tres, base = drive_both(tmp_path, monkeypatch)
    assert list(tres) == list(jres)
    assert json.loads((base / "rehearsal_fern.json").read_text()) == tres
    for k, v in jres.items():
        if k == "spec":
            assert tres[k] == dict(v, device="cpu")
        else:
            assert tres[k] == v, k
    assert (tres["eval_psnr_rgb1"], tres["eval_psnr_rgb0"]) == (25.5, 24.25)
    assert tres["eval_ms_frame"] == 9.125
    assert tres["export_fullres_ms_frame"] == 40.5
    assert tres["export_psnr_rgb1"] == 26.75


def test_stage_command_is_what_main_runs(tmp_path, monkeypatch):
    _, tcalls, _, _, base = drive_both(tmp_path, monkeypatch)
    args = rr.build_parser().parse_args(
        ["--root", str(tmp_path / "capture"), "--basedir", str(base),
         "--device", "cpu"])
    ckpt = base / rr.S2_EXPNAME / "000004.ckpt"
    exports = {"infer_export": "/x/full/export/render_frame.pt2",
               "infer_export_datares": "/x/data/export/render_frame.pt2"}
    for (cmd, _), stage in zip(tcalls, rr.STAGES):
        assert cmd == rr.stage_command(stage, args, tmp_path / "capture",
                                       base, ckpt=ckpt,
                                       export_dir=exports.get(stage)), stage
    with pytest.raises(ValueError):
        rr.stage_command("deploy", args, tmp_path, base)


def test_runner_resumes_from_its_sidecar(tmp_path):
    log = tmp_path / "s1.log"
    out, dt = rr.run([sys.executable, "-c", "print('stage one')"], log)
    assert "stage one" in out and (tmp_path / "s1.log.ok").exists()
    # a finished stage replays its log instead of running again
    out2, dt2 = rr.run([sys.executable, "-c", "raise SystemExit(3)"], log)
    assert out2 == out and dt2 == float(f"{dt:.1f}")
    with pytest.raises(SystemExit, match="rc=3"):
        rr.run([sys.executable, "-c", "raise SystemExit(3)"],
               tmp_path / "s2.log")
    assert not (tmp_path / "s2.log.ok").exists()


def test_rehearsal_flags_and_defaults_are_jax(monkeypatch):
    jmod = _load("rehearse_release")
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["rehearse_release.py", "--help"])
    with redirect_stdout(buf), pytest.raises(SystemExit):
        jmod.main()
    jflags = set(re.findall(r"(--[a-z0-9][a-z0-9-]*)", buf.getvalue()))
    port = rr.build_parser()
    tflags = {s for a in port._actions for s in a.option_strings}
    assert tflags - {"-h", "--help"} == (jflags - {"--help"}) | {"--device"}
    d = vars(port.parse_args([]))
    assert (d["s1"], d["s2"], d["scan"], d["views"], d["raw_h"],
            d["raw_w"]) == (3000, 1500, 50, 17, 1512, 2016)
    assert d["device"] == "cuda"
    # the port's own capture and logs: a JAX rehearsal's sidecars are never
    # taken for the port's
    assert d["root"] != "data/rehearsal_fern"
    assert d["basedir"] != "logs_rehearsal"


def test_raw_capture_equals_jax_and_loads_without_pil(tmp_path, monkeypatch):
    from pronerf_tpu_torch.data.llff import load_llff_data

    jmod = _load("rehearse_release")
    with redirect_stdout(io.StringIO()):
        jmod.build_dataset(tmp_path / "jax", 9, 64, 80)
        rr.build_dataset(tmp_path / "port", 9, 64, 80)
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    names = sorted(p.name for p in (troot / "images").iterdir())
    assert names == sorted(p.name for p in (jroot / "images").iterdir())
    assert len(names) == 9 and not (troot / "images_4").exists()
    for n in names:
        np.testing.assert_array_equal(read_png(troot / "images" / n),
                                      read_png(jroot / "images" / n))
    assert (troot / "poses_bounds.npy").read_bytes() == \
        (jroot / "poses_bounds.npy").read_bytes()
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    images, poses, *_ = load_llff_data(troot, factor=4)
    assert images.shape == (9, 16, 20, 3)
    assert len(list((troot / "images_4").glob("*.png"))) == 9


# ------------------------------------------------------------ cold start --

def test_coldstart_phases_map_onto_jax_phases():
    text = (REPO / "scripts/bench_coldstart.py").read_text()
    jax_phases = re.findall(r'mark\("(\w+)"\)', text)
    assert list(cs.JAX_PHASES) == jax_phases
    mapped = [v for v in cs.JAX_PHASES.values() if v is not None]
    assert list(dict.fromkeys(mapped)) == list(cs.PHASES)
    absent = [k for k, v in cs.JAX_PHASES.items() if v is None]
    assert absent == list(cs.PHASES_ABSENT) == ["reload_compile"]
    assert all(cs.PHASES_ABSENT.values())


def test_coldstart_on_the_cpu_prints_every_phase_it_measures(capsys):
    res = cs.main(["--device", "cpu", "--res", "30x40"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res
    assert res["res"] == "40x30"
    assert list(res["phases_s"]) == [p for p in cs.PHASES
                                     if p not in cs.CPU_ABSENT]
    assert set(res["phases_absent"]) == {"reload_compile", "cuda_init",
                                         "kernel_load"}
    assert all(v >= 0 for v in res["phases_s"].values())
    assert res["total_s"] >= res["phases_s"]["imports"]
    assert (res["cache"], res["cache_mb"], res["cold"]) == (None, None, False)
    assert res["device_kind"] == "cpu"
    assert 0 <= cs._process_age_s() < 1e6


def test_kernel_cache_directory_comes_from_the_environment(tmp_path,
                                                           monkeypatch):
    monkeypatch.delenv(build.CACHE_ENV, raising=False)
    assert build.build_dir() == build.BUILD_DIR
    assert build.lib_path("fused_nerf").parent == build.BUILD_DIR
    monkeypatch.setenv(build.CACHE_ENV, str(tmp_path / "cold"))
    assert build.build_dir() == tmp_path / "cold"
    assert build.lib_path("fused_nerf").parent == tmp_path / "cold"
    assert build.log_path("fused_nerf").parent == tmp_path / "cold"
