"""Command line of the port: ``python -m pronerf_tpu_torch.cli
{train-stage1, train-stage2, train-multi, infer, eval, render-path, export,
export-trt}``.

Counterpart of ``pronerf_tpu/cli.py``, with its verbs, flags and defaults:
kebab-case flags mapped onto the config's snake_case fields, defaults
pointing at the fern release configs, and ``--`` passthrough of raw config
overrides (e.g. ``-- --i_weights 2``). ``--use-trt`` selects the serving
path: bf16 and, unless the passthrough sets them, the whole frame in one
tile (``tile_rays = 0``) through the fused CUDA kernels (``use_pallas``).

``render-path`` renders the spiral camera path to a video (mp4 where
imageio has a backend for it, else a GIF).

``export`` / ``export-trt`` trace and save the whole-frame renderer
(``render/export.py``; ``--height``/``--width``, default 1008x756) and
``infer --from-export DIR`` serves the test views from it.

``train-multi`` trains several scenes in one run (``train/multi_loop.py``;
``--scenes`` comma-separated datadirs, else ``--n-synthetic`` synthetic
ones; ``--stage 2`` from ``--pretrain-path``, a stage-1 multi expdir) over
``--nproc`` ranks of this machine (default: every visible card; one process
with ``--device cpu``), which ``--ray-shards`` and the scenes are laid out
on as the JAX loop lays them on its devices.

``--device`` (default ``cuda``) is the port's own: every verb runs on the
card and raises without one, unless ``--device cpu`` is given. The JAX
package's compilation cache and platform switches have no counterpart.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from pronerf_tpu_torch.config import Config, _coerce

REPO_ROOT = Path(__file__).resolve().parents[1]
DEFAULT_STAGE1_CONFIG = REPO_ROOT / "configs/llff/fern/fern_epi.txt"
DEFAULT_STAGE2_CONFIG = REPO_ROOT / "configs/llff/fern/fern_refine.txt"
DEFAULT_TRT_CONFIG = REPO_ROOT / "configs/llff/fern/fern_trt.txt"

def _parse_extra(extra: list[str]) -> dict:
    """``-- --key value`` / ``-- --flag`` passthrough onto Config fields."""
    if extra and extra[0] == "--":
        extra = extra[1:]
    out: dict = {}
    i = 0
    names = Config.field_names()
    bool_fields = {n for n in names if isinstance(getattr(Config(), n), bool)}
    while i < len(extra):
        tok = extra[i]
        if not tok.startswith("--"):
            raise SystemExit(f"Unexpected passthrough token: {tok!r}")
        key = tok[2:].replace("-", "_")
        if key not in names:
            raise SystemExit(f"Unknown config flag --{key}")
        if key in bool_fields and (
            i + 1 >= len(extra) or extra[i + 1].startswith("--")
        ):
            out[key] = True
            i += 1
        else:
            out[key] = _coerce(Config, key, extra[i + 1])
            i += 2
    return out


def _build_cfg(args, default_config, serving: bool = False) -> Config:
    overrides = _parse_extra(getattr(args, "extra", []))
    for name in ("max_steps", "no_reload", "pretrain_path", "render_test",
                 "use_trt", "max_images"):
        val = getattr(args, name, None)
        if val not in (None, False):
            overrides[name] = val
    if getattr(args, "synthetic", False):
        overrides["datadir"] = "synthetic"
    if getattr(args, "checkpoint", None):
        overrides["ft_path"] = args.checkpoint
    cfg = Config.from_file(args.config or default_config, **overrides)
    if serving and cfg.use_trt:
        # `--use-trt` means the serving graph: the whole frame in one tile
        # through the fused kernels; explicit passthrough overrides win
        applied = []
        if "tile_rays" not in overrides:
            cfg = cfg.replace(tile_rays=0)
            applied.append("tile_rays=0")
        if "use_pallas" not in overrides:
            cfg = cfg.replace(use_pallas=True)
            applied.append("use_pallas=True")
        if applied:
            print(f"[SERVING] --use-trt defaults: {' '.join(applied)} "
                  "(override via `-- --tile_rays N --use_pallas False`)")
    return cfg


def cmd_train_stage1(args):
    from pronerf_tpu_torch.train.loop import run_training

    return run_training(_build_cfg(args, DEFAULT_STAGE1_CONFIG), stage=1,
                        device=args.device)


def cmd_train_stage2(args):
    from pronerf_tpu_torch.train.loop import run_training

    return run_training(_build_cfg(args, DEFAULT_STAGE2_CONFIG), stage=2,
                        device=args.device)


def cmd_train_multi(args):
    from pronerf_tpu_torch.train.multi_loop import launch_multi_training

    default = (DEFAULT_STAGE2_CONFIG if args.stage == 2
               else DEFAULT_STAGE1_CONFIG)
    cfg = _build_cfg(args, default)
    datadirs = args.scenes.split(",") if args.scenes else [
        f"synthetic{i}" for i in range(args.n_synthetic)]
    return launch_multi_training(cfg, datadirs, n_ray_shards=args.ray_shards,
                                 stage=args.stage, device=args.device,
                                 nproc=args.nproc)


def cmd_infer(args):
    if getattr(args, "from_export", None):
        from pronerf_tpu_torch.render.infer import run_inference_from_export

        return run_inference_from_export(
            _build_cfg(args, DEFAULT_TRT_CONFIG), args.from_export,
            timing_reps=args.timing_reps, device=args.device)
    from pronerf_tpu_torch.render.infer import run_inference

    return run_inference(_build_cfg(args, DEFAULT_TRT_CONFIG, serving=True),
                         timing_reps=args.timing_reps, device=args.device)


def cmd_eval(args):
    args.render_test = True
    return cmd_infer(args)


def cmd_render_path(args):
    from pronerf_tpu_torch.render.infer import run_render_path

    return run_render_path(
        _build_cfg(args, DEFAULT_TRT_CONFIG, serving=True),
        n_frames=args.n_frames, fps=args.fps, device=args.device)


def cmd_export(args):
    from pronerf_tpu_torch.render.infer import run_export

    if args.onnx_only:
        print("--onnx-only: note - this framework exports one torch.export "
              "program; there is no intermediate ONNX stage.")
    return run_export(_build_cfg(args, DEFAULT_TRT_CONFIG, serving=True),
                      height=args.height, width=args.width,
                      device=args.device)


def _add_common(p):
    p.add_argument("--config", default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to run (default: the CUDA card; raises "
                        "without one)")
    p.add_argument("--synthetic", action="store_true",
                   help="use the built-in synthetic scene (no dataset needed)")
    p.add_argument(
        "extra", nargs=argparse.REMAINDER,
        help="raw config overrides forwarded after --, e.g. -- --i_weights 2",
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m pronerf_tpu_torch.cli",
        description="ProNeRF on PyTorch/CUDA: train / infer on LLFF scenes.",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train-stage1",
                       help="alternating sampler/NeRF training")
    p.add_argument("--no-reload", action="store_true", dest="no_reload")
    p.add_argument("--max-steps", type=int, default=None, dest="max_steps")
    _add_common(p)
    p.set_defaults(func=cmd_train_stage1)

    p = sub.add_parser("train-stage2",
                       help="joint refinement from a stage-1 ckpt")
    p.add_argument("--pretrain-path", default=None, dest="pretrain_path")
    p.add_argument("--no-reload", action="store_true", dest="no_reload")
    p.add_argument("--max-steps", type=int, default=None, dest="max_steps")
    _add_common(p)
    p.set_defaults(func=cmd_train_stage2)

    p = sub.add_parser("train-multi",
                       help="training of several scenes in one run")
    p.add_argument("--stage", type=int, default=1, choices=(1, 2),
                   help="1 = alternating stage-1, 2 = joint stage-2")
    p.add_argument("--pretrain-path", default=None, dest="pretrain_path",
                   help="stage-2: stage-1 multi expdir holding per-scene "
                        "scene_{name} checkpoints")
    p.add_argument("--scenes", default=None,
                   help="comma-separated datadirs (same resolution)")
    p.add_argument("--n-synthetic", type=int, default=2, dest="n_synthetic",
                   help="number of synthetic scenes when --scenes is unset")
    p.add_argument("--ray-shards", type=int, default=1, dest="ray_shards",
                   help="ray shards a scene over the process group's ranks")
    p.add_argument("--nproc", type=int, default=None,
                   help="ranks on this machine (default: every visible card "
                        "under --device cuda, NCCL; 1 under --device cpu, "
                        "gloo); more than one are spawned")
    p.add_argument("--no-reload", action="store_true", dest="no_reload")
    p.add_argument("--max-steps", type=int, default=None, dest="max_steps")
    _add_common(p)
    p.set_defaults(func=cmd_train_multi)

    for name, func, help_ in (
            ("infer", cmd_infer, "render held-out/test views"),
            ("eval", cmd_eval, "render the test split through inference")):
        p = sub.add_parser(name, help=help_)
        p.add_argument("--checkpoint", default=None)
        if name == "infer":
            p.add_argument("--render-test", action="store_true",
                           dest="render_test")
        p.add_argument("--use-trt", action="store_true", dest="use_trt",
                       help="the bf16 serving path through the fused kernels")
        p.add_argument("--max-images", type=int, default=None,
                       dest="max_images")
        p.add_argument("--timing-reps", type=int, default=0,
                       dest="timing_reps",
                       help="timed re-renders per pose (reference uses 20)")
        if name == "infer":
            p.add_argument("--from-export", default=None, dest="from_export",
                           metavar="DIR", help="serve from an export directory (or any "
                                "file in it) instead of a checkpoint")
        _add_common(p)
        p.set_defaults(func=func)

    p = sub.add_parser("render-path",
                       help="render the spiral camera path to video")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--use-trt", action="store_true", dest="use_trt",
                   help="the bf16 serving path through the fused kernels")
    p.add_argument("--n-frames", type=int, default=None, dest="n_frames")
    p.add_argument("--fps", type=int, default=30)
    _add_common(p)
    p.set_defaults(func=cmd_render_path)

    for name in ("export", "export-trt"):
        p = sub.add_parser(
            name, help="trace and save the whole-frame renderer")
        p.add_argument("--checkpoint", default=None)
        p.add_argument("--onnx-only", action="store_true", dest="onnx_only")
        p.add_argument("--use-trt", action="store_true", dest="use_trt",
                       help="export the bf16 serving graph (fused kernels)")
        p.add_argument("--height", type=int, default=756)
        p.add_argument("--width", type=int, default=1008)
        _add_common(p)
        p.set_defaults(func=cmd_export)
    return parser


def main(argv=None):
    """Run one verb; returns what its entry point returned."""
    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    return args.func(args)


if __name__ == "__main__":
    main()
