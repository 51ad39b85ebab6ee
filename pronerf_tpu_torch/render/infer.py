"""Inference / eval entry points on the eager PyTorch renderer.

- reference views come from greedy COLMAP visibility selection
  (``data.llff.load_llff_data_infer``) and the per-pose neighbors are the
  nearest num_neighbor of those, deterministically;
- bounds are near=0, far=1 in NDC; density corrections always applied;
- ``use_trt`` (kept for surface parity with the reference's script) selects
  the bf16 fast path;
- metrics: PSNR (always), SSIM, and LPIPS when the optional package exists.

Counterpart of ``pronerf_tpu/render/infer.py``. Data: an LLFF capture
(``datadir`` holding ``poses_bounds.npy``, ``images_{factor}`` and
``sparse/0``), or the synthetic stand-in (``datadir = synthetic[:WxHxV]``).
Weights come from a checkpoint of the port or of the JAX package
(``train/checkpoint.py``: ``ft_path``, else the newest ``*.ckpt`` of the
expdir). ``run_render_path`` renders the spiral camera path to a video
(``render-path``). ``run_export`` traces and saves the frame renderer
(``render/export.py``) and ``run_inference_from_export`` serves the test
views from the saved program (``export`` / ``infer --from-export``).
"""

from __future__ import annotations

import dataclasses
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from pronerf_tpu_torch.config import Config, enforce_flag_contract
from pronerf_tpu_torch.models.pronerf import RenderStatics, init_pronerf_params
from pronerf_tpu_torch.render.raygen import prepare_scene
from pronerf_tpu_torch.render.renderer import render_path, save_video
from pronerf_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
)
from pronerf_tpu_torch.utils.tensors import resolve_device


def setup_expdir(cfg: Config) -> Path:
    """Create ``basedir/expname`` and record the arguments there."""
    expdir = Path(cfg.basedir) / cfg.expname
    expdir.mkdir(parents=True, exist_ok=True)
    with open(expdir / "args.txt", "w") as fh:
        for f in sorted(dataclasses.fields(cfg), key=lambda f: f.name):
            fh.write(f"{f.name} = {getattr(cfg, f.name)}\n")
    if cfg.config and Path(cfg.config).exists():
        shutil.copy(cfg.config, expdir / "config.txt")
    return expdir


def load_inference_data(cfg: Config):
    """LLFF infer data (COLMAP reference views) or the synthetic stand-in.

    Also enforces the flag contract (every inference entry point loads data
    first, so rejected/vestigial flags are reported before any work)."""
    enforce_flag_contract(cfg)
    if cfg.datadir.startswith("synthetic"):
        from pronerf_tpu_torch.utils.synthetic import (
            make_consistent_scene,
            parse_synthetic_spec,
        )

        sc = make_consistent_scene(seed=cfg.seed,
                                   **parse_synthetic_spec(cfg.datadir))
        images = sc["images"]
        H, W, focal = sc["hwf"]
        poses = sc["poses"]
        i_test = np.arange(len(images))[:: cfg.llffhold]
        i_train = np.array([i for i in range(len(images))
                            if i not in i_test])
        i_ref = i_train[: cfg.num_neighbor]
        return {
            "images": images, "poses": poses, "i_test": i_test,
            "i_ref": i_ref, "H": H, "W": W, "focal": focal, "K": sc["K"],
            "render_poses": poses[i_train][:6],
        }
    from pronerf_tpu_torch.data.llff import load_llff_data_infer

    images, poses, _, render_poses, i_test, i_ref = load_llff_data_infer(
        cfg.datadir, factor=cfg.factor, recenter=True, bd_factor=0.75,
        spherify=cfg.spherify, num_neighbor=cfg.num_neighbor,
        llffhold=cfg.llffhold,
    )
    hwf = poses[0, :3, -1]
    H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    K = np.array(
        [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32
    )
    return {
        "images": images, "poses": poses[:, :3, :4], "i_test": i_test,
        "i_ref": i_ref, "H": H, "W": W, "focal": focal, "K": K,
        "render_poses": np.asarray(render_poses)[:, :3, :4],
    }


def _infer_statics(cfg: Config, use_bf16: bool) -> RenderStatics:
    compute_dtype = "bfloat16" if use_bf16 else cfg.compute_dtype
    # the DoNeRF kernel is bf16: an f32 DoNeRF frame runs without kernels
    use_kernels = cfg.use_pallas and (cfg.netarch == "nerf"
                                      or compute_dtype == "bfloat16")
    return RenderStatics.infer(
        compute_dtype=compute_dtype,
        use_kernels=use_kernels,
        quant=cfg.quant if use_kernels else "none",
        gather_tiles=cfg.gather_tiles,
        gather_bf16=cfg.gather_bf16,
        gather_split=cfg.gather_split,
        gather_transposed=cfg.gather_transposed,
        transposed=cfg.transposed,
        netarch=cfg.netarch,
        N_samples=cfg.N_samples,
        N_point_ray_enc=cfg.N_point_ray_enc,
        num_neighbor=cfg.num_neighbor,
        multires=cfg.multires,
        multires_views=cfg.multires_views,
        white_bkgd=cfg.white_bkgd,
    )


def _init_params(cfg: Config, generator: torch.Generator, device):
    return init_pronerf_params(
        generator,
        netarch=cfg.netarch,
        netdepth=cfg.netdepth,
        netwidth=cfg.netwidth,
        mmnetdepth=cfg.mmnetdepth,
        mmnetwidth=cfg.mmnetwidth,
        N_samples=cfg.N_samples,
        N_point_ray_enc=cfg.N_point_ray_enc,
        num_neighbor=cfg.num_neighbor,
        multires=cfg.multires,
        multires_views=cfg.multires_views,
        device=device,
    )


def load_params_for_inference(ckpt_file, cfg: Config, device):
    """The three nets of a checkpoint of either stage, of the port or of the
    JAX package: the NeRF from ``network_fine`` (stage 2) if present, else
    ``network_fn`` (stage 1)."""
    ck = load_checkpoint(ckpt_file)
    params = _init_params(cfg, torch.Generator().manual_seed(cfg.seed),
                          device)
    with torch.no_grad():
        params["nerf"].load_state_dict(
            ck["network_fine"] if "network_fine" in ck else ck["network_fn"])
        params["sampler"].load_state_dict(ck["mmr_network_fn"])
        params["refine"].load_state_dict(ck["refine_net"])
    return params


def _arch(cfg: Config) -> dict:
    """The nets' widths and depths, which an export bundles to rebuild
    them."""
    return dict(netdepth=cfg.netdepth, netwidth=cfg.netwidth,
                mmnetdepth=cfg.mmnetdepth, mmnetwidth=cfg.mmnetwidth)


def _load_params(cfg: Config, expdir, device):
    ckpt = cfg.ft_path or latest_checkpoint(expdir)
    if ckpt:
        print(f"Loading weights from {ckpt}")
        return load_params_for_inference(ckpt, cfg, device)
    print("WARNING: no checkpoint found; rendering with random weights")
    return _init_params(cfg, torch.Generator().manual_seed(cfg.seed), device)


def _serving_scene(cfg: Config, data, device):
    """The reference views, u8-packed: the corner pack, or the whole-pixel
    pack with ``warp_interp = 'nearest'``."""
    return prepare_scene(
        data["images"][data["i_ref"]], data["poses"][data["i_ref"]], data["K"],
        pack_corners="u8-nearest" if cfg.warp_interp == "nearest" else "u8",
        device=device,
    )


def run_inference(cfg: Config, timing_reps: int = 0, device="cuda"):
    """``infer`` / ``eval``: render the held-out test poses, report metrics.

    Runs on the card by default and raises without one; ``device='cpu'``
    runs the plain versions."""
    device = resolve_device(device)
    data = load_inference_data(cfg)
    expdir = setup_expdir(cfg)
    params = _load_params(cfg, expdir, device)

    scene = _serving_scene(cfg, data, device)
    statics = _infer_statics(cfg, use_bf16=cfg.use_trt)

    i_test = data["i_test"]
    if cfg.max_images is not None:
        i_test = i_test[: cfg.max_images]
    savedir = expdir / "renderonly_test"
    result = render_path(
        data["poses"][i_test], params, scene, statics,
        data["H"], data["W"], data["K"],
        gt_imgs=data["images"][i_test] if cfg.render_factor == 0 else None,
        savedir=savedir,
        tile_rays=cfg.tile_rays, timing_reps=timing_reps,
        render_factor=cfg.render_factor, device=device,
    )

    # SSIM / LPIPS on top of render_path's PSNR report
    from pronerf_tpu_torch.ops.metrics import img2ssim, rgb_lpips

    ssims, lpipss = [], []
    for k, idx in enumerate(i_test if cfg.render_factor == 0 else []):
        gt = np.asarray(data["images"][idx])
        pred = result["rgbs1"][k]
        ssims.append(img2ssim(pred, gt))
        lp = rgb_lpips(gt, pred)
        if lp is not None:
            lpipss.append(lp)
    if ssims:
        print(f"Mean Test SSIM {float(np.mean(ssims))}")
    if lpipss:
        print(f"Mean Test LPIPS {float(np.mean(lpipss))}")
    result["ssims"] = ssims
    result["lpips"] = lpipss

    # Analytic MACs report (surface parity with the reference's print:
    # per-net sampler+refine MACs and ``Total flops:`` = 2x their sum).
    from pronerf_tpu_torch.utils.profiling import pipeline_macs

    rf = max(1, cfg.render_factor)
    macs = pipeline_macs(
        data["H"] // rf, data["W"] // rf,
        N_samples=cfg.N_samples, N_point_ray_enc=cfg.N_point_ray_enc,
        num_neighbor=cfg.num_neighbor, netwidth=cfg.netwidth,
        mmnetwidth=cfg.mmnetwidth, mmnetdepth=cfg.mmnetdepth,
    )
    print("min_max_ray_net", macs["sampler"])
    print("refine_net", macs["refine"])
    print("Total flops:", 2 * (macs["sampler"] + macs["refine"]))
    print(f"(full pipeline incl. NeRF: "
          f"{2 * sum(macs.values()) / 1e9:.2f} GFLOPs/frame)")
    result["macs"] = macs

    # The JAX package's two summary lines, in its order: the timed reps,
    # then the steady-state frame (render_path's CUDA graph of frames,
    # replayed, less the null dispatch)
    if result["times_ms"]:
        ms = float(np.median(result["times_ms"]))
        how = (f"CUDA events around one served frame on "
               f"{torch.cuda.get_device_name(device)}"
               if device.type == "cuda"
               else "host clock around one eager frame on cpu")
        print(f"Median per-dispatch ms/frame ({how}): {ms:.3f}")
    if result.get("amortized_ms"):
        ams = result["amortized_ms"]
        print(f"Median render ms/frame: {ams:.3f} "
              f"({data['H'] * data['W'] / rf / rf / ams * 1e3 / 1e6:.2f} "
              f"Mrays/s, steady-state)")
    return result


def run_render_path(cfg: Config, n_frames: int | None = None, fps: int = 30,
                    device="cuda"):
    """``render-path``: render the spiral camera path (``render_poses``; the
    first ``n_frames`` of it) and save it as a video under the expdir
    (``save_video``: mp4, or a GIF). Returns the path written. Runs on the
    card by default; ``device='cpu'`` runs the plain versions."""
    device = resolve_device(device)
    data = load_inference_data(cfg)
    expdir = setup_expdir(cfg)
    params = _load_params(cfg, expdir, device)
    scene = _serving_scene(cfg, data, device)
    statics = _infer_statics(cfg, use_bf16=cfg.use_trt)
    poses = data["render_poses"]
    if n_frames is not None:
        poses = poses[:n_frames]
    result = render_path(
        poses, params, scene, statics, data["H"], data["W"], data["K"],
        savedir=None, tile_rays=cfg.tile_rays,
        render_factor=cfg.render_factor, device=device,
    )
    out = save_video(result["rgbs1"], expdir / "render_path.mp4", fps=fps)
    print(f"Saved render path video: {out} ({len(poses)} frames)")
    return out


def run_export(cfg: Config, height: int = 756, width: int = 1008,
               device="cuda"):
    """``export``: trace and save the whole-frame renderer at the target
    resolution (default 1008x756, the reference engine's frame) with the
    params of ``cfg``'s checkpoint and its reference views, the
    intrinsics scaled from the data resolution. The program runs on the
    device type it is traced on: the card by default. Returns the artifact
    paths."""
    from pronerf_tpu_torch.render.export import export_renderer

    device = resolve_device(device)
    data = load_inference_data(cfg)
    expdir = setup_expdir(cfg)
    params = _load_params(cfg, expdir, device)
    scene = _serving_scene(cfg, data, device)
    sx, sy = width / data["W"], height / data["H"]
    K = np.array([[data["K"][0][0] * sx, 0, 0.5 * width],
                  [0, data["K"][1][1] * sy, 0.5 * height],
                  [0, 0, 1]], np.float32)
    statics = _infer_statics(cfg, use_bf16=cfg.use_trt)
    if statics.netarch == "donerf":
        # the DoNeRF kernel's ops are not exported: a DoNeRF program is the
        # kernel-free frame
        statics = dataclasses.replace(statics, use_kernels=False)
    paths = export_renderer(
        params, scene, expdir / "export", height, width, K,
        tile_rays=cfg.tile_rays,
        statics=statics,
        arch=_arch(cfg), device=device,
    )
    print(f"Exported AOT renderer to {paths['executable']}")
    return paths


def run_inference_from_export(cfg: Config, export_dir, timing_reps: int = 0,
                              device="cuda"):
    """``infer --from-export``: serve the test views from a saved program
    (no renderer is built here: the program is loaded and called with the
    bundled params and reference views), write ``export_test/{k:03d}.png``
    and report PSNR where the export's resolution is the data's.

    ``timing_reps > 0`` times each pose that many times (``Render path
    time:``, CUDA events on the card) and, on the first pose, ``timing_reps``
    calls queued back to back and synchronised once, less one null dispatch
    (``Pipelined render ms/frame``). Runs on the card by default."""
    from pronerf_tpu_torch.ops.metrics import to8b
    from pronerf_tpu_torch.render.export import load_exported_renderer
    from pronerf_tpu_torch.utils.png import write_png
    from pronerf_tpu_torch.utils.profiling import (
        null_dispatch_ms,
        readback,
        timed_ms,
    )

    device = resolve_device(device)
    call, params, scene, manifest = load_exported_renderer(export_dir, device)
    H, W = manifest["H"], manifest["W"]
    print(f"Serving {H}x{W} frames from {export_dir} "
          f"({manifest['compute_dtype']}, tile_rays={manifest['tile_rays']})")
    data = load_inference_data(cfg)
    expdir = setup_expdir(cfg)
    i_test = data["i_test"]
    if cfg.max_images is not None:
        i_test = i_test[: cfg.max_images]
    savedir = expdir / "export_test"
    savedir.mkdir(parents=True, exist_ok=True)

    same_res = (H == data["H"] and W == data["W"])
    psnrs, times_ms, pipelined = [], [], None
    null_ms = null_dispatch_ms(device) if timing_reps > 0 else None
    for k, idx in enumerate(np.asarray(i_test)):
        c2w = data["poses"][idx][:3, :4]
        out = call(params, scene, c2w)
        readback(out["rgb1"])
        for _ in range(timing_reps):
            ms = timed_ms(lambda: call(params, scene, c2w), device)
            times_ms.append(ms)
            print(f"Render path time: {ms:.3f}")
        if timing_reps > 0 and k == 0:
            # steady state: calls queued back to back, one sync
            reps = max(2, timing_reps)
            t0 = time.perf_counter()
            for _ in range(reps):
                last = call(params, scene, c2w)
            readback(last["rgb1"])
            pipelined = ((time.perf_counter() - t0) * 1e3 - null_ms) / reps
            print(f"Pipelined render ms/frame (x{reps} async minus "
                  f"{null_ms:.3f} ms null dispatch): {pipelined:.3f}")
        rgb1 = out["rgb1"].cpu().numpy()
        write_png(savedir / f"{k:03d}.png", to8b(rgb1))
        if same_res:
            gt = np.asarray(data["images"][idx])
            psnrs.append(float(-10.0 * np.log10(np.mean((rgb1 - gt) ** 2))))
    if psnrs:
        print(psnrs)
        print(f"Mean Test PSNR {float(np.mean(psnrs))}")
    elif not same_res:
        print(f"(export res {W}x{H} != data res {data['W']}x{data['H']}; "
              "PSNR skipped)")
    return {"psnrs": psnrs, "times_ms": times_ms,
            "pipelined_ms": pipelined, "savedir": str(savedir)}
