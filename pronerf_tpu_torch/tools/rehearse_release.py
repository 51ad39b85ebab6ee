"""Fern-scale release dress rehearsal on the port: the COMPLETE command-line
protocol from a full on-disk LLFF capture directory.

The twin of the JAX package's ``scripts/rehearse_release.py``, with its
stages, flags, resumable ``.ok`` sidecars and results keys. It writes the
consistent synthetic scene as a REAL LLFF capture at the fern raw resolution
(2016x1512, 17 views: raw ``images/`` PNGs only, so that ``factor 4``
training makes ``images_4`` for real, by the port's own Lanczos,
``data/llff.py:_minify``), then drives the port's command line end to end
as a user would on fern:

  train-stage1 -> train-stage2 -> eval --use-trt -> export
  -> infer --from-export (1008x756, timed) -> export at the data resolution
  -> infer --from-export (PSNR) -> render-path

Each stage is a SUBPROCESS of ``python -m pronerf_tpu_torch.cli`` (with
``--device``, default ``cuda``), exercising the LLFF loader, the COLMAP
greedy cover and the holdout split (llffhold = 8) at real shapes. A stage
whose ``<log>.ok`` sidecar exists replays its recorded output, so a failed
rehearsal resumes at the failed stage. :func:`stage_command` builds each
stage's command.

Usage:
  python -m pronerf_tpu_torch.tools.rehearse_release [--s1 3000] [--s2 1500]
      [--scan 50] [--root data/rehearsal_fern_torch]
      [--basedir logs_rehearsal_torch] [--device cuda]
Writes a JSON summary to ``<basedir>/rehearsal_fern.json``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[2]
CLI = ("-m", "pronerf_tpu_torch.cli")
S1_EXPNAME = "fern_sampler_e2e_donerf_8samples_cc"  # fern_epi.txt's
S2_EXPNAME = "fern_refine_8samples_v2"              # fern_refine.txt's
TRT = "configs/llff/fern/fern_trt.txt"
STAGES = ("s1", "s2", "eval_timed", "export", "infer_export",
          "export_datares", "infer_export_datares", "render_path")


def build_dataset(root: pathlib.Path, n_views: int, H: int, W: int):
    """The consistent synthetic scene written as a raw LLFF capture
    (``images/`` at ``W x H``, ``poses_bounds.npy``, COLMAP ``sparse/0``),
    once."""
    if (root / "poses_bounds.npy").exists():
        print(f"[REHEARSAL] dataset exists at {root}")
        return
    from pronerf_tpu_torch.utils.fixtures import write_llff_scene
    from pronerf_tpu_torch.utils.synthetic import make_consistent_scene

    t0 = time.time()
    print(f"[REHEARSAL] generating consistent scene {W}x{H}x{n_views} ...",
          flush=True)
    scene = make_consistent_scene(
        n_views=n_views, H=H, W=W, focal=0.875 * W, seed=0
    )
    write_llff_scene(root, scene)
    print(f"[REHEARSAL] wrote {root} in {time.time() - t0:.0f}s", flush=True)


def run(cmd, log_path):
    """Run one CLI stage; idempotent: a stage whose <log>.ok sidecar exists
    replays its recorded output."""
    log_path = pathlib.Path(log_path)
    ok_path = log_path.with_suffix(log_path.suffix + ".ok")
    if ok_path.exists() and log_path.exists():
        print(f"[REHEARSAL] skip (done): {' '.join(cmd)}", flush=True)
        return log_path.read_text(), float(ok_path.read_text() or 0)
    print(f"[REHEARSAL] $ {' '.join(cmd)}", flush=True)
    t0 = time.time()
    proc = subprocess.run(
        cmd, cwd=REPO, capture_output=True, text=True
    )
    out = proc.stdout + proc.stderr
    log_path.write_text(out)
    dt = time.time() - t0
    if proc.returncode != 0:
        print(out[-4000:])
        raise SystemExit(f"stage failed rc={proc.returncode} ({dt:.0f}s)")
    ok_path.write_text(f"{dt:.1f}")
    print(f"[REHEARSAL] ok in {dt:.0f}s", flush=True)
    return out, dt


def last_psnrs(text):
    """All 'Mean Test PSNR <x>' values, in print order (rgb1 then rgb0)."""
    return [float(m) for m in re.findall(r"Mean Test PSNR ([0-9.]+)", text)]


def stage_command(stage, args, root, base, ckpt=None, export_dir=None,
                  python=sys.executable):
    """The command line of one stage (a name of ``STAGES``): the JAX
    script's, with this package's module and ``--device``. ``ckpt`` is the
    stage-2 checkpoint (eval, exports, render-path), ``export_dir`` what an
    export printed (the infers from it)."""
    def cli(verb, *rest):
        return [python, *CLI, verb, "--device", args.device, *rest]

    common = ["--datadir", str(root), "--basedir", str(base),
              "--scan_steps", str(args.scan)]
    data = ["--datadir", str(root), "--basedir", str(base)]
    if stage == "s1":
        return cli("train-stage1", "--config",
                   "configs/llff/fern/fern_epi.txt",
                   "--max-steps", str(args.s1), "--no-reload", "--",
                   *common, "--i_weights", str(args.s1), "--i_testset", "0",
                   "--i_video", "0")
    if stage == "s2":
        return cli("train-stage2", "--config",
                   "configs/llff/fern/fern_refine.txt",
                   "--max-steps", str(args.s2), "--no-reload",
                   "--pretrain-path", str(base / S1_EXPNAME), "--",
                   *common, "--i_weights", str(args.s2), "--i_testset", "0",
                   "--i_video", "0")
    if stage == "eval_timed":
        return cli("eval", "--config", TRT, "--checkpoint", str(ckpt),
                   "--use-trt", "--timing-reps", "10", "--", *data)
    if stage == "export":
        # the ENGINE operating point (1008x756, the reference's TRT batch)
        return cli("export", "--config", TRT, "--checkpoint", str(ckpt),
                   "--use-trt", "--", *data)
    if stage == "infer_export":
        return cli("infer", "--config", TRT, "--from-export",
                   str(export_dir), "--max-images", "1", "--timing-reps",
                   "5", "--", *data)
    if stage == "export_datares":
        # at the data resolution, so that served frames compare against GT
        return cli("export", "--config", TRT, "--checkpoint", str(ckpt),
                   "--use-trt", "--height", str(args.raw_h // 4), "--width",
                   str(args.raw_w // 4), "--", *data)
    if stage == "infer_export_datares":
        return cli("infer", "--config", TRT, "--from-export",
                   str(export_dir), "--max-images", "2", "--", *data)
    if stage == "render_path":
        return cli("render-path", "--config", TRT, "--checkpoint",
                   str(ckpt), "--use-trt", "--n-frames", "4", "--", *data)
    raise ValueError(f"unknown stage {stage!r}")


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m pronerf_tpu_torch.tools.rehearse_release",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--s1", type=int, default=3000)
    ap.add_argument("--s2", type=int, default=1500)
    ap.add_argument("--scan", type=int, default=50)
    ap.add_argument("--views", type=int, default=17)
    ap.add_argument("--raw-h", type=int, default=1512)
    ap.add_argument("--raw-w", type=int, default=2016)
    ap.add_argument("--root", default="data/rehearsal_fern_torch")
    ap.add_argument("--basedir", default="logs_rehearsal_torch")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the stages run (default: the CUDA card)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    root = REPO / args.root
    base = REPO / args.basedir
    base.mkdir(parents=True, exist_ok=True)
    results = {"spec": vars(args)}

    build_dataset(root, args.views, args.raw_h, args.raw_w)

    def stage(name, **kw):
        return run(stage_command(name, args, root, base, **kw),
                   base / f"{name}.log")

    out, results["s1_seconds"] = stage("s1")
    out, results["s2_seconds"] = stage("s2")

    ckpt = sorted((base / S2_EXPNAME).glob("*.ckpt"))[-1]
    out, results["eval_seconds"] = stage("eval_timed", ckpt=ckpt)
    ps = last_psnrs(out)
    results["eval_psnr_rgb1"] = ps[0] if ps else None
    results["eval_psnr_rgb0"] = ps[1] if len(ps) > 1 else None
    m = re.search(r"Median render ms/frame: ([0-9.]+)", out)
    results["eval_ms_frame"] = float(m.group(1)) if m else None

    out, results["export_seconds"] = stage("export", ckpt=ckpt)
    export_dir = re.search(r"Exported AOT renderer to (\S+)", out).group(1)
    out, results["infer_export_seconds"] = stage("infer_export",
                                                 export_dir=export_dir)
    m = re.search(r"Pipelined render ms/frame[^:]*: ([0-9.]+)", out)
    results["export_fullres_ms_frame"] = float(m.group(1)) if m else None

    out, results["export_datares_seconds"] = stage("export_datares",
                                                   ckpt=ckpt)
    export_dir = re.search(r"Exported AOT renderer to (\S+)", out).group(1)
    out, results["infer_export_datares_seconds"] = stage(
        "infer_export_datares", export_dir=export_dir)
    ps = last_psnrs(out)
    results["export_psnr_rgb1"] = ps[0] if ps else None

    out, results["render_path_seconds"] = stage("render_path", ckpt=ckpt)

    outp = base / "rehearsal_fern.json"
    outp.write_text(json.dumps(results, indent=2))
    print(json.dumps(results, indent=2))
    print(f"[REHEARSAL] summary -> {outp}", flush=True)
    return results


if __name__ == "__main__":
    main()
