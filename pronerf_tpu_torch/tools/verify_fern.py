"""Fern-parity protocol on the port: ONE command that runs stage 1 ->
stage 2 -> eval on an LLFF capture and prints PSNR / SSIM / LPIPS next to
the reference's operating point (its print contract,
``run_S_eS_eN_alter_base.py:360-371``; paper table in IEEE Access 2024, DOI
10.1109/ACCESS.2024.3390753; the reference publishes no numbers itself).

The twin of the JAX package's ``scripts/verify_fern.py``, with its flags,
defaults, summary table and ``{"verify_fern": ...}`` line, driving the
port's command line (``cli.main``) and ``render/infer.py:run_inference``;
``--device`` (default ``cuda``) is the port's own. LPIPS is ``None`` where
the ``lpips`` package is absent.

Usage:
  python -m pronerf_tpu_torch.tools.verify_fern --datadir data/nerf_llff_data/fern
  python -m pronerf_tpu_torch.tools.verify_fern --quick     # 20k+8k
  python -m pronerf_tpu_torch.tools.verify_fern --fixture   # the on-disk
                                                            # test fixture
  (add --device cpu to run the plain versions on the CPU)

The real-data schedule defaults to the reference's (stage-1 alternating then
stage-2 joint refinement, 4096-ray batches); ``--s1-steps/--s2-steps``
override. Exits non-zero if eval PSNR falls below ``--min-psnr`` (when set).
"""

from __future__ import annotations

import argparse
import json
import pathlib


def build_fixture(root: pathlib.Path, H: int = 32, W: int = 40):
    """The tiny on-disk LLFF capture of ``--fixture`` (8 views, a COLMAP
    model), written once."""
    from pronerf_tpu_torch.utils.fixtures import (
        write_colmap_model,
        write_llff_dataset,
    )

    root.mkdir(parents=True, exist_ok=True)
    if not (root / "poses_bounds.npy").exists():
        write_llff_dataset(root, n=8, H=H, W=W, focal=36.0)
        write_colmap_model(root, n_images=8, n_points=50)
    return root


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m pronerf_tpu_torch.tools.verify_fern",
        description=__doc__.split("\n")[0])
    ap.add_argument("--datadir", default="data/nerf_llff_data/fern")
    ap.add_argument("--basedir", default="logs/verify_fern_torch")
    ap.add_argument("--factor", type=int, default=4,
                    help="LLFF downsample factor (reference: 4 -> 504x378)")
    ap.add_argument("--s1-steps", type=int, default=None)
    ap.add_argument("--s2-steps", type=int, default=None)
    ap.add_argument("--quick", action="store_true",
                    help="the 20k+8k reduced operating point")
    ap.add_argument("--fixture", action="store_true",
                    help="run the full protocol on a tiny generated on-disk "
                         "LLFF fixture (CI-style; PSNR is not meaningful on "
                         "the random-texture fixture)")
    ap.add_argument("--use-trt", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="bfloat16 serving path for eval (default on; "
                         "--no-use-trt selects the f32 parity eval)")
    ap.add_argument("--min-psnr", type=float, default=None,
                    help="fail (exit 1) if eval PSNR is below this")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default: the CUDA card; raises "
                         "without one)")
    args = ap.parse_args(argv)

    from pronerf_tpu_torch.cli import main as cli

    base = pathlib.Path(args.basedir)
    if args.fixture:
        datadir = build_fixture(base / "fixture_data")
        s1_steps, s2_steps = args.s1_steps or 4, args.s2_steps or 4
        factor = 1
        extra = ["--N_rand", "128", "--i_print", "2", "--i_weights", "2",
                 "--i_testset", "0", "--tile_rays", "512"]
    else:
        datadir = pathlib.Path(args.datadir)
        if not (datadir / "poses_bounds.npy").exists():
            raise SystemExit(
                f"No LLFF capture at {datadir} (missing poses_bounds.npy). "
                "Mount the fern scene or run with --fixture for a "
                "data-free protocol check."
            )
        if args.quick:
            s1_steps, s2_steps = args.s1_steps or 20000, args.s2_steps or 8000
        else:
            s1_steps, s2_steps = args.s1_steps or 200000, args.s2_steps or 100000
        factor = args.factor
        extra = ["--i_testset", "0"]

    common = ["--datadir", str(datadir), "--factor", str(factor),
              "--basedir", str(base)] + extra
    device = ["--device", args.device]

    print(f"[verify_fern] stage 1: {s1_steps} alternating steps")
    cli(["train-stage1", "--max-steps", str(s1_steps), *device,
         "--", "--expname", "verify_s1"] + common)

    s1_ckpts = sorted((base / "verify_s1").glob("*.ckpt"))
    if not s1_ckpts:
        raise SystemExit("stage 1 produced no checkpoint")
    print(f"[verify_fern] stage 2: {s2_steps} joint steps "
          f"from {s1_ckpts[-1].name}")
    cli(["train-stage2", "--max-steps", str(s2_steps),
         "--pretrain-path", str(s1_ckpts[-1]), *device,
         "--", "--expname", "verify_s2"] + common)

    s2_ckpts = sorted((base / "verify_s2").glob("*.ckpt"))
    if not s2_ckpts:
        raise SystemExit("stage 2 produced no checkpoint")

    print("[verify_fern] eval: held-out test split")
    from pronerf_tpu_torch.cli import DEFAULT_TRT_CONFIG
    from pronerf_tpu_torch.config import Config
    from pronerf_tpu_torch.render.infer import run_inference

    cfg = Config.from_file(
        DEFAULT_TRT_CONFIG,
        datadir=str(datadir), factor=factor, basedir=str(base),
        expname="verify_eval", ft_path=str(s2_ckpts[-1]),
        use_trt=args.use_trt, render_test=True,
        **({"tile_rays": 512} if args.fixture else {}),
    )
    result = run_inference(cfg, device=args.device)

    import numpy as np

    psnr = float(np.mean(result["psnrs"])) if result["psnrs"] else float("nan")
    ssim = float(np.mean(result["ssims"])) if result["ssims"] else float("nan")
    lpips = (float(np.mean(result["lpips"]))
             if result["lpips"] else None)

    # -- summary next to the reference's operating point ------------------
    print()
    print("=" * 68)
    print("verify_fern summary")
    print("-" * 68)
    print(f"{'quantity':<26}{'this run':>14}{'reference':>26}")
    print(f"{'scene':<26}{datadir.name:>14}{'LLFF fern':>26}")
    print(f"{'schedule (s1+s2 steps)':<26}"
          f"{f'{s1_steps}+{s2_steps}':>14}{'500k total':>26}")
    print(f"{'samples/ray':<26}{8:>14}{'8':>26}")
    print(f"{'held-out PSNR (dB)':<26}{psnr:>14.3f}"
          f"{'paper table (DOI above)':>26}")
    print(f"{'held-out SSIM':<26}{ssim:>14.4f}"
          f"{'paper table (DOI above)':>26}")
    if lpips is not None:
        print(f"{'held-out LPIPS':<26}{lpips:>14.4f}"
              f"{'paper table (DOI above)':>26}")
    print("=" * 68)
    print(json.dumps({
        "verify_fern": {
            "datadir": str(datadir), "fixture": args.fixture,
            "s1_steps": s1_steps, "s2_steps": s2_steps,
            "psnr": psnr, "ssim": ssim, "lpips": lpips,
        }
    }), flush=True)
    if args.min_psnr is not None and not psnr >= args.min_psnr:
        raise SystemExit(
            f"PSNR {psnr:.3f} below required {args.min_psnr:.3f}"
        )


if __name__ == "__main__":
    main()
