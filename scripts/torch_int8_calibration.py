#!/usr/bin/env python3
"""The int8 NeRF kernel's activation calibration on trained weights.

``quant = int8`` calibrates the per-channel activation ranges on a uniform
sweep of the NDC volume (``kernels/fused_nerf_q.py:calibrate_nerf_ranges``;
the JAX package does the same). On a trained checkpoint that serves about
40 dB in bf16, the int8 form serves about 20. This script serves the
held-out views of a scene three ways and prints the PSNR of each:

- ``bf16``: the bf16 kernels (``eval --use-trt``'s path);
- ``int8_sweep``: int8 with the default calibration;
- ``int8_frame``: int8 with the ranges calibrated on ``--points`` query
  points (and their rays' view directions) drawn from one held-out frame
  (``--calib-view``, an index into the held-out views), through the same
  ``pts`` / ``dirs`` arguments of ``calibrate_nerf_ranges``.

    python3 scripts/torch_int8_calibration.py [--device cuda|cpu]
        [--checkpoint results/soak/s2/370000.ckpt]
        [--datadir synthetic:504x378x17] [--calib-view 0]
        [--points 65536] [--tile-rays 16384] [--seed 0]

Prints one JSON line with the PSNRs (rgb1 per held-out view and their
mean) and the device it ran on.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from pronerf_tpu_torch.config import Config  # noqa: E402
from pronerf_tpu_torch.kernels import fused_nerf  # noqa: E402
from pronerf_tpu_torch.kernels.fused_nerf_q import (  # noqa: E402
    calibrate_nerf_ranges,
    pack_nerf_params_int8,
)
from pronerf_tpu_torch.models.pronerf import render_rays  # noqa: E402
from pronerf_tpu_torch.render import infer  # noqa: E402
from pronerf_tpu_torch.render.raygen import rays_for_pose  # noqa: E402
from pronerf_tpu_torch.render.renderer import (  # noqa: E402
    render_path,
    resolve_gather_statics,
)


@torch.no_grad()
def frame_points(params, scene, statics, H, W, K, c2w, tile, device):
    """The NeRF kernel's query points [N * S, 3] of one frame and the view
    direction of each point's ray, in the same order."""
    rays = rays_for_pose(H, W, K, c2w, device=device)
    controls = {"target_t": torch.as_tensor(
        np.asarray(c2w)[:3, 3], dtype=torch.float32, device=device)}
    statics = resolve_gather_statics(statics, H, W, tile)
    seen, kernel = [], fused_nerf.fused_nerf_raw_t

    def record(packed, pts24_t, vcon_t, n_samples=8):
        seen.append((pts24_t.T.reshape(-1, 3).cpu(), n_samples))
        return kernel(packed, pts24_t, vcon_t, n_samples=n_samples)

    pts, dirs = [], []
    fused_nerf.fused_nerf_raw_t = record
    try:
        n = H * W
        for i in range(0, n, tile):
            part = {k: v[i:i + tile] if v.shape[0] == n else v
                    for k, v in rays.items()}
            seen.clear()
            render_rays(params, part, scene, controls, statics)
            (p, S), = seen
            pts.append(p)
            dirs.append(part["viewdirs"].cpu().repeat_interleave(S, dim=0))
    finally:
        fused_nerf.fused_nerf_raw_t = kernel
    return torch.cat(pts), torch.cat(dirs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint",
                    default=str(ROOT / "results/soak/s2/370000.ckpt"))
    ap.add_argument("--datadir", default="synthetic:504x378x17")
    ap.add_argument("--calib-view", type=int, default=0)
    ap.add_argument("--points", type=int, default=65536)
    ap.add_argument("--tile-rays", type=int, default=16384)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = Config.from_file(ROOT / "configs/llff/fern/fern_trt.txt",
                           datadir=args.datadir, use_trt=True,
                           use_pallas=True, tile_rays=args.tile_rays)
    data = infer.load_inference_data(cfg)
    params = infer.load_params_for_inference(args.checkpoint, cfg, device)
    scene = infer._serving_scene(cfg, data, device)
    statics = infer._infer_statics(cfg, use_bf16=True)
    H, W, K = data["H"], data["W"], data["K"]
    i_test = data["i_test"]

    def serve(p, st):
        out = render_path(data["poses"][i_test], p, scene, st, H, W, K,
                          gt_imgs=data["images"][i_test],
                          tile_rays=args.tile_rays, device=device)
        return {"psnrs_rgb1": out["psnrs"],
                "mean_rgb1": float(np.mean(out["psnrs"]))}

    quant = dataclasses.replace(statics, quant="int8")
    report = {"bf16": serve(params, statics),
              "int8_sweep": serve(params, quant)}

    pts, dirs = frame_points(params, scene, statics, H, W, K,
                             data["poses"][i_test[args.calib_view]],
                             args.tile_rays, device)
    pick = np.random.default_rng(args.seed).choice(
        pts.shape[0], size=min(args.points, pts.shape[0]), replace=False)
    ranges = calibrate_nerf_ranges(params["nerf"], pts=pts[pick],
                                   dirs=dirs[pick])
    params_q = dict(params, nerf_packed_q=pack_nerf_params_int8(
        params["nerf"], ranges=ranges))
    report["int8_frame"] = serve(params_q, quant) | {
        "calibrated_on": f"{len(pick)} query points of held-out view "
                         f"{int(i_test[args.calib_view])}"}
    report["device"] = (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu")
    report["checkpoint"] = args.checkpoint
    report["held_out_views"] = [int(i) for i in i_test]
    print(json.dumps({"int8_calibration": report}), flush=True)


if __name__ == "__main__":
    main()
