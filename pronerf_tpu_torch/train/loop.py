"""Training entry point for stage 1 (alternating) and stage 2 (joint).

Counterpart of ``pronerf_tpu/train/loop.py``:
- batches of N_rand rays sliced from a pre-shuffled pool that reshuffles on
  exhaustion; 500k iterations (+1) unless ``max_steps``;
- stage 1 alternates: odd i -> NeRF step, even i -> sampler step; one LR
  schedule (with the /2) for both optimizers;
- expdir contract: ``basedir/expname/args.txt``, ``config.txt``,
  ``%06d.ckpt`` every i_weights and at the end, test-set renders every
  i_testset under ``testset_%06d``, a spiral video every i_video
  (``spiral_%06d.mp4``, or ``.gif``), ``metrics.jsonl``, ``imgs/``
  (i_img);
- auto-resume from the newest checkpoint unless ``no_reload``; stage 2
  bootstraps from ``pretrain_path`` (a file or a stage-1 expdir);
- a non-finite loss at a print step fails fast.

Host-side randomness (neighbor subset, n_mult, direction coins) comes from
one numpy Generator per run, in the JAX package's order, so the choices
equal its own step for step; the device draws come from a
``torch.Generator`` seeded per step. A resumed run replays the host stream
up to its step, so it continues the uninterrupted run exactly (the JAX loop
restarts the stream at a resume).

Data: an LLFF capture (``data/llff.py``) or the synthetic stand-in. The ray
pool is the host runtime's (``native/``) whenever its library loads, as in
the JAX package, so one seed gives both trainers the same batches.
Checkpoints of the JAX package are read too (``train/checkpoint.py``), for
``pretrain_path`` and for auto-resume.

``scan_steps > 1`` runs the JAX package's scan branch: chunks of that many
steps through ``train/fast_loop.py``'s executor (CUDA graphs of the steps on
the card), the pool reshuffled on the device between chunks, one read a
chunk (the NaN guard on the chunk-mean loss), print / checkpoint / testset /
video events at the chunk that crosses their boundary (checkpoints named by
the actual step), and the per-step loop for the tail. Stage 1 needs an even
resume step there, else it takes the per-step loop with a note.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from pronerf_tpu_torch.config import Config, enforce_flag_contract
from pronerf_tpu_torch.models.pronerf import RenderStatics
from pronerf_tpu_torch.render.infer import _init_params, setup_expdir
from pronerf_tpu_torch.render.raygen import build_ray_pool, prepare_scene
from pronerf_tpu_torch.render.renderer import (
    make_frame_renderer,
    render_path,
    save_video,
)
from pronerf_tpu_torch.train.checkpoint import (
    checkpoint_path,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from pronerf_tpu_torch.train.fast_loop import (
    device_reshuffle,
    make_scan_executor,
)
from pronerf_tpu_torch.train.stage1 import init_stage1_state, make_stage1_steps
from pronerf_tpu_torch.train.stage2 import init_stage2_state, make_stage2_step
from pronerf_tpu_torch.train.state import stage1_lr, stage2_lr
from pronerf_tpu_torch.utils.logging import MetricsLogger, save_image_log
from pronerf_tpu_torch.utils.tensors import resolve_device

N_ITERS_DEFAULT = 500_000


# ---------------------------------------------------------------- data --

def load_training_data(cfg: Config):
    """Load LLFF data (or the synthetic stand-in when ``datadir =
    synthetic[:WxHxV]``) and derive the train/test split + intrinsics."""
    if cfg.dataset_type != "llff":
        raise ValueError("Only dataset_type=llff is supported")
    if cfg.no_ndc:
        raise NotImplementedError(
            "no_ndc is not supported: the ProNeRF sampler operates in NDC")
    if cfg.epi_nerf:
        raise NotImplementedError("--epi_nerf is not supported")
    if cfg.no_batching or cfg.full_image:
        raise NotImplementedError(
            "no_batching/full_image single-image sampling is not part of the "
            "release path (training always uses the shuffled ray pool)")
    if cfg.datadir.startswith("synthetic"):
        from pronerf_tpu_torch.utils.synthetic import (
            make_consistent_scene,
            parse_synthetic_spec,
        )

        sc = make_consistent_scene(seed=cfg.seed,
                                   **parse_synthetic_spec(cfg.datadir))
        images = sc["images"]
        H, W, focal = sc["hwf"]
        poses = sc["poses"][:, :3, :4]
        render_poses = poses[:4].copy()
    else:
        from pronerf_tpu_torch.data.llff import load_llff_data

        images, poses, _, render_poses, _ = load_llff_data(
            cfg.datadir, factor=cfg.factor, recenter=True, bd_factor=0.75,
            spherify=cfg.spherify)
        H, W, focal = poses[0, :3, -1]
        poses = poses[:, :3, :4]
        render_poses = np.asarray(render_poses)[:, :3, :4]
    H, W, focal = int(H), int(W), float(focal)
    if cfg.llffhold > 0:
        i_test = np.arange(images.shape[0])[:: cfg.llffhold]
    else:
        i_test = np.array([0])
    i_train = np.array([i for i in range(images.shape[0]) if i not in i_test])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                 np.float32)
    return {
        "images": images, "poses": poses, "render_poses": render_poses,
        "i_train": i_train, "i_test": i_test,
        "H": H, "W": W, "focal": focal, "K": K,
    }


# --------------------------------------------------- checkpoint layout --

def stage1_ckpt(state) -> dict:
    p = state["params"]
    return {
        "global_step": int(state["global_step"]),
        "network_fn": p["nerf"].state_dict(),
        "mmr_network_fn": p["sampler"].state_dict(),
        "refine_net": p["refine"].state_dict(),
        "optimizer": state["opt_nerf"],
        "s_optimizer": state["opt_s"],
    }


def _load_opt(dst: dict, src: dict):
    dst["count"] = int(src["count"])
    for part in ("mu", "nu"):
        if set(src[part]) != set(dst[part]):
            raise ValueError("optimizer state over other parameters: "
                             f"{sorted(set(src[part]) ^ set(dst[part]))}")
        for k, v in src[part].items():
            dst[part][k].copy_(v)


@torch.no_grad()
def stage1_restore(ckpt_file, state) -> dict:
    """Load a stage-1 checkpoint into ``state`` (in place; returned)."""
    ck = load_checkpoint(ckpt_file)
    p = state["params"]
    p["nerf"].load_state_dict(ck["network_fn"])
    p["sampler"].load_state_dict(ck["mmr_network_fn"])
    p["refine"].load_state_dict(ck["refine_net"])
    _load_opt(state["opt_nerf"], ck["optimizer"])
    _load_opt(state["opt_s"], ck["s_optimizer"])
    state["global_step"] = int(ck["global_step"])
    return state


def stage2_ckpt(state, vestigial_nerf) -> dict:
    p = state["params"]
    return {
        "global_step": int(state["global_step"]),
        "network_fn": vestigial_nerf.state_dict(),  # untrained, layout
        "network_fine": p["nerf"].state_dict(),
        "mmr_network_fn": p["sampler"].state_dict(),
        "refine_net": p["refine"].state_dict(),
        "optimizer_state_dict": state["opt"],
        "optimizer_nerf": state["opt_nerf"],
    }


@torch.no_grad()
def stage2_restore(ckpt_file, state, vestigial_nerf) -> tuple:
    """Load a stage-2 checkpoint into ``state`` and ``vestigial_nerf`` (in
    place; both returned)."""
    ck = load_checkpoint(ckpt_file)
    p = state["params"]
    p["nerf"].load_state_dict(ck["network_fine"])
    p["sampler"].load_state_dict(ck["mmr_network_fn"])
    p["refine"].load_state_dict(ck["refine_net"])
    vestigial_nerf.load_state_dict(ck["network_fn"])
    _load_opt(state["opt"], ck["optimizer_state_dict"])
    _load_opt(state["opt_nerf"], ck["optimizer_nerf"])
    state["global_step"] = int(ck["global_step"])
    return state, vestigial_nerf


# ---------------------------------------------------------------- loops --

def _draw_controls(rng: np.random.Generator, n_train: int, cfg: Config,
                   step: int, device="cpu"):
    """One step's random choices, drawn from the host stream in the JAX
    package's order (subset, n_mult, expand coin, jitter coin), and the
    step's device generator, seeded as the JAX package keys its step."""
    max_mult = max(1, 64 // cfg.N_samples)
    subset = np.sort(
        rng.choice(n_train - 1, size=cfg.num_neighbor, replace=False))
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg.seed * 1_000_003 + step))
    return {
        "rng": gen,
        "n_mult": int(rng.integers(1, max_mult + 1)),
        "dir_expand": bool(rng.random() > 0.5),
        "dir_jitter": bool(rng.random() > 0.5),
        "neighbor_subset": torch.as_tensor(subset, dtype=torch.int64,
                                           device=device),
        "target_t": torch.zeros(3, dtype=torch.float32, device=device),
    }


def _eval_statics(cfg: Config, stage: int) -> RenderStatics:
    """Deterministic render statics for in-training eval (testset / i_img /
    i_video), matching the training stage's behavior matrix."""
    statics = (
        RenderStatics.stage1_sampler(randomize=False)
        if stage == 1 else RenderStatics.stage2(randomize=False)
    )
    return dataclasses.replace(
        statics, netarch=cfg.netarch, N_samples=cfg.N_samples,
        N_point_ray_enc=cfg.N_point_ray_enc,
        num_neighbor=cfg.num_neighbor, multires=cfg.multires,
        multires_views=cfg.multires_views, white_bkgd=cfg.white_bkgd,
    )


def _resolve_pretrain(path) -> str:
    pre = Path(path)
    if pre.is_dir():
        resolved = latest_checkpoint(pre)
        if resolved is None:
            raise FileNotFoundError(f"--pretrain-path {pre} contains no *.ckpt")
        return resolved
    return str(pre)


def _spiral_video(cfg: Config, stage: int, i: int, expdir, data, scene,
                  params, H, W, K, device):
    """``i_video``: the spiral path (``render_poses``) rendered with the
    stage's eval statics and saved as ``spiral_%06d`` video."""
    res = render_path(
        data["render_poses"], params, scene, _eval_statics(cfg, stage),
        H, W, K, savedir=None, tile_rays=cfg.tile_rays, device=device,
    )
    out = save_video(res["rgbs1"], expdir / f"spiral_{i:06d}.mp4")
    print(f"Saved spiral video {out}")


def run_training(cfg: Config, stage: int, device="cuda"):
    """Entry point for train-stage1 (stage=1) and train-stage2 (stage=2).

    Runs on the card by default and raises without one; ``device='cpu'``
    trains on the CPU. Returns (state, expdir)."""
    device = resolve_device(device)
    enforce_flag_contract(cfg)
    data = load_training_data(cfg)
    H, W, focal, K = data["H"], data["W"], data["focal"], data["K"]
    i_train, i_test = data["i_train"], data["i_test"]
    expdir = setup_expdir(cfg)

    scene = prepare_scene(data["images"][i_train], data["poses"][i_train], K,
                          device=device)
    params = _init_params(cfg, torch.Generator().manual_seed(cfg.seed),
                          device)
    vestigial_nerf = None
    if stage == 1:
        state = init_stage1_state(params, cfg.weight_decay)
        nerf_step, sampler_step = make_stage1_steps(cfg, H, W, focal)

        def lr_fn(s):
            return stage1_lr(s, cfg.lrate, cfg.lrate_decay)
    else:
        if cfg.pretrain_path:
            tmp = init_stage1_state(params, cfg.weight_decay)
            params = stage1_restore(_resolve_pretrain(cfg.pretrain_path),
                                    tmp)["params"]
        vestigial_nerf = _init_params(
            cfg, torch.Generator().manual_seed(cfg.seed + 1), device)["nerf"]
        state = init_stage2_state(params, cfg.weight_decay)
        train_step = make_stage2_step(cfg, H, W, focal)

        def lr_fn(s):
            return stage2_lr(s, cfg.lrate, cfg.lrate_decay)

    def save(step):
        path = checkpoint_path(expdir, step)
        if stage == 1:
            save_checkpoint(path, stage1_ckpt(state))
        else:
            save_checkpoint(path, stage2_ckpt(state, vestigial_nerf))
        print(f"Saved checkpoints at {path}")

    def testset(step):
        render_path(
            data["poses"][i_test], state["params"], scene,
            _eval_statics(cfg, stage), H, W, K,
            gt_imgs=data["images"][i_test],
            savedir=expdir / f"testset_{step:06d}",
            tile_rays=cfg.tile_rays, device=device,
        )
        print("Saved test set")

    # auto-resume
    start = 0
    ckpt_file = cfg.ft_path or latest_checkpoint(expdir)
    if ckpt_file and not cfg.no_reload:
        print(f"Reloading from {ckpt_file}")
        if stage == 1:
            state = stage1_restore(ckpt_file, state)
        else:
            state, vestigial_nerf = stage2_restore(ckpt_file, state,
                                                   vestigial_nerf)
        start = int(state["global_step"])

    n_iters = N_ITERS_DEFAULT + 1
    if cfg.max_steps is not None:
        n_iters = start + cfg.max_steps + 1

    rng = np.random.default_rng(cfg.seed)
    pool, pool_ids = build_ray_pool(
        data["images"], data["poses"], K, list(i_train), cfg.num_neighbor, rng)
    i_batch = 0

    # Several steps a dispatch (train/fast_loop.py): chunks of scan_steps,
    # then the per-step loop for the tail.
    chunk = cfg.scan_steps
    pool_batches = pool.shape[0] // cfg.N_rand
    if chunk > pool_batches > 0:
        # the executor wraps the in-chunk batch index modulo the pool's
        # batch capacity: each chunk cycles the reshuffled pool
        print(f"[TRAIN] note: ray pool holds only {pool_batches} batches "
              f"of {cfg.N_rand}; each {chunk}-step scan chunk cycles the "
              f"reshuffled pool ~{chunk / pool_batches:.1f}x (in-chunk "
              f"epoch wrap)")
    if stage == 1:
        chunk -= chunk % 2  # the stage-1 executor runs step pairs
    use_scan = cfg.scan_steps > 1 and chunk >= 2
    if use_scan and stage == 1 and start % 2 != 0:
        print("[TRAIN] note: stage-1 scan executor requires an even resume "
              "step (pair-scan alternation); using the per-step loop")
        use_scan = False
    stride = chunk * cfg.N_rand

    def reshuffle_pool(pool_d, ids_d):
        # on the device, keyed from the host stream
        return device_reshuffle(pool_d, ids_d,
                                int(rng.integers(0, 2**63 - 1)))

    if use_scan:
        pool_d = torch.from_numpy(pool).to(device)
        ids_d = torch.from_numpy(pool_ids).to(device)
        # a resumed run replays the chunks' reshuffles up to its step (the
        # draws of a step depend on the seed and the step alone)
        for _ in range(start // chunk):
            if i_batch + stride > pool.shape[0]:
                reshuffle_pool(pool_d, ids_d)
                i_batch = 0
            i_batch += stride
    else:
        # a resumed run replays the host stream (reshuffles and controls)
        # up to its step, so that it sees the batches the uninterrupted run
        # saw
        for i in range(1, start + 1):
            if i_batch + cfg.N_rand > pool.shape[0]:
                perm = rng.permutation(pool.shape[0])
                pool, pool_ids = pool[perm], pool_ids[perm]
                i_batch = 0
            i_batch += cfg.N_rand
            _draw_controls(rng, len(i_train), cfg, i)
        pool_d = torch.from_numpy(pool).to(device)
        ids_d = torch.from_numpy(pool_ids).to(device)

    logger = MetricsLogger(expdir)
    print(f"Begin stage {stage}: iters [{start + 1}, {n_iters}) "
          f"res {W}x{H} train views {len(i_train)} test views {len(i_test)} "
          f"on {device}")
    t_start = time.time()
    i = start
    if use_scan:
        executor = make_scan_executor(cfg, H, W, focal, len(i_train), stage,
                                      chunk)
        seed = cfg.seed + 987654321

        def crossed(period, a, b):
            return period and period > 0 and (a // period) != (b // period)

        while n_iters - 1 - i >= chunk:
            if i_batch + stride > pool.shape[0]:
                reshuffle_pool(pool_d, ids_d)
                i_batch = 0
            state, metrics = executor(state, scene, pool_d, ids_d, i_batch,
                                      seed)
            i_prev, i = i, i + chunk
            i_batch += stride

            # one read a chunk: a divergence inside a chunk stops at its end
            loss_val = float(metrics["mean_loss"])
            if not np.isfinite(loss_val):
                raise FloatingPointError(
                    f"Non-finite chunk-mean loss {loss_val} at iter {i}")
            if crossed(cfg.i_print, i_prev, i):
                psnr_val = float(metrics["mean_psnr"])
                rate = (i - start) / max(time.time() - t_start, 1e-9)
                print(f"[TRAIN] Iter: {i} Loss: {loss_val:.6f} "
                      f"PSNR: {psnr_val:.3f} (chunk means) "
                      f"lr: {lr_fn(i - 1):.3e} it/s: {rate:.2f}")
                logger.log(i, loss=loss_val, psnr=psnr_val, it_per_s=rate,
                           mode="scan")
            # events fire chunk-aligned (at most chunk-1 steps late;
            # checkpoints are named by the actual step)
            if crossed(cfg.i_weights, i_prev, i):
                save(i)
            if cfg.i_testset > 0 and crossed(cfg.i_testset, i_prev, i) \
                    and i > start + chunk:
                testset(i)
            if cfg.i_video > 0 and crossed(cfg.i_video, i_prev, i) \
                    and i > start + chunk:
                _spiral_video(cfg, stage, i, expdir, data, scene,
                              state["params"], H, W, K, device)

    for i in range(i + 1, n_iters):
        if i_batch + cfg.N_rand > pool.shape[0]:
            perm = rng.permutation(pool.shape[0])
            pool, pool_ids = pool[perm], pool_ids[perm]
            pool_d = torch.from_numpy(pool).to(device)
            ids_d = torch.from_numpy(pool_ids).to(device)
            i_batch = 0
        batch = pool_d[i_batch:i_batch + cfg.N_rand]
        bids = ids_d[i_batch:i_batch + cfg.N_rand]
        i_batch += cfg.N_rand

        controls = _draw_controls(rng, len(i_train), cfg, i, device)
        lr = lr_fn(i - 1)  # decays on the pre-increment global_step

        if stage == 1:
            step_fn = nerf_step if i % 2 != 0 else sampler_step
        else:
            step_fn = train_step
        state, metrics = step_fn(state, scene, batch, bids, controls, lr)

        if i % cfg.i_print == 0 or i == n_iters - 1:
            loss_val = float(metrics["loss"])
            psnr_val = float(metrics["psnr"])
            if not np.isfinite(loss_val):
                raise FloatingPointError(
                    f"Non-finite loss {loss_val} at iter {i}")
            rate = (i - start) / max(time.time() - t_start, 1e-9)
            print(f"[TRAIN] Iter: {i} Loss: {loss_val:.6f} "
                  f"PSNR: {psnr_val:.3f} lr: {lr:.3e} it/s: {rate:.2f}")
            logger.log(i, loss=loss_val, psnr=psnr_val, lr=lr, it_per_s=rate,
                       branch="nerf" if (stage == 1 and i % 2 != 0) else
                       ("sampler" if stage == 1 else "joint"))

        if i % cfg.i_weights == 0:
            save(i)

        if cfg.i_img > 0 and i % cfg.i_img == 0 and len(i_test) > 0:
            # one held-out render logged as PNG
            r = make_frame_renderer(_eval_statics(cfg, stage), H, W, K,
                                    cfg.tile_rays, device=device)
            out = r(state["params"], scene, data["poses"][i_test[0]])
            save_image_log(expdir, i, "test0", out["rgb1"].cpu().numpy())

        if cfg.i_testset > 0 and i % cfg.i_testset == 0 and i > start + 1:
            testset(i)

        if cfg.i_video > 0 and i % cfg.i_video == 0 and i > start + 1:
            _spiral_video(cfg, stage, i, expdir, data, scene,
                          state["params"], H, W, K, device)

    logger.close()
    # a final checkpoint, so that a short run always leaves one behind
    save(int(state["global_step"]))
    return state, expdir
