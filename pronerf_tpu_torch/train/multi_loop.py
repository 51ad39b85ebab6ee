"""Multi-scene training loop: the counterpart of
``pronerf_tpu/train/multi_loop.py`` (``python -m pronerf_tpu_torch.cli
train-multi [--stage 2]``).

Stage-1 alternation or stage-2 joint training of several scenes in one run
(``parallel/multi_scene.py`` lays them out). All scenes share resolution
and train-view count. Each scene keeps its own params, Adam state and ray
pool; the controls of a step are drawn once on the host and shared, except
the noise, whose generator folds in the scene's index.

- one host ``rng`` (``seed``), shared in scene order: the ray pools (the
  host runtime's, where its library loads), then each step's controls and
  each reshuffle's seed, drawn at the moments the JAX loop draws them, so
  that one seed gives both trainers the same pools, draws and batches (the
  pools' reshuffles are the port's own permutations, drawn on the device);
- params of scene ``idx`` from ``seed + idx`` (stage 2's vestigial NeRF
  from ``seed + idx + 1``); a ``synthetic...`` datadir is seeded ``seed +
  idx``;
- checkpoints a scene under ``basedir/expname/scene_{name}/`` (the
  reference's key layout), every ``i_weights`` and at the end; the loop
  AUTO-RESUMES from them, all or nothing, unless ``no_reload``, and
  replays the host stream up to the resumed step (the JAX loop restarts
  it), so that a resumed run continues the uninterrupted one exactly;
- stage 2 bootstraps each scene from ``pretrain_path/scene_{name}`` (the
  port's or the JAX package's checkpoints);
- a non-finite loss at an ``i_print`` step raises ``FloatingPointError``
  with the per-scene losses; held-out renders a scene every ``i_testset``.

Over several ranks (``parallel/launch.py``) each rank trains its block of
scenes, and the ranks of a scene row split its batches; the host stream
runs the same on every rank. The first ray shard of each row writes its
scenes' checkpoints and renders; rank 0 prints. Without a process group it
is a world of one. ``launch_multi_training`` (the ``train-multi`` verb)
forms the group as the JAX loop takes every local device: ``nproc`` ranks,
by default one a visible card (one process on the CPU); a world of one in
this process, or ``nproc`` spawned ranks (NCCL on ``cuda:<rank>``, gloo on
the CPU).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from pronerf_tpu_torch.config import Config, enforce_flag_contract
from pronerf_tpu_torch.parallel.launch import (
    backend_for,
    close_group,
    init_group,
    local_ranks,
    spawn_local,
    world,
)
from pronerf_tpu_torch.parallel.multi_scene import (
    make_multi_scene_pooled_step,
    make_scene_mesh,
    place_scene_pools,
    reshuffle_scene_pools,
    stack_scenes,
)
from pronerf_tpu_torch.render.infer import _init_params, setup_expdir
from pronerf_tpu_torch.render.raygen import build_ray_pool, prepare_scene
from pronerf_tpu_torch.render.renderer import render_path
from pronerf_tpu_torch.train.checkpoint import (
    checkpoint_path,
    latest_checkpoint,
    save_checkpoint,
)
from pronerf_tpu_torch.train.loop import (
    N_ITERS_DEFAULT,
    _draw_controls,
    _eval_statics,
    load_training_data,
    stage1_ckpt,
    stage1_restore,
    stage2_ckpt,
    stage2_restore,
)
from pronerf_tpu_torch.train.stage1 import init_stage1_state
from pronerf_tpu_torch.train.stage2 import init_stage2_state
from pronerf_tpu_torch.train.state import stage1_lr, stage2_lr
from pronerf_tpu_torch.utils.tensors import resolve_device


def _scene_name(datadir: str, idx: int) -> str:
    if datadir.startswith("synthetic"):
        return f"synthetic{idx}"
    return Path(datadir).name


def mesh_layout(n_scene: int, n_ray_shards: int, n_dev: int):
    """The JAX loop's ``(scene rows, ray shards)`` for ``n_scene`` scenes x
    ``n_ray_shards`` over ``n_dev`` ranks, and its note (``None`` where the
    request fits): scene rows that divide the scenes, with a note where the
    request exceeds the ranks, and a ``ValueError`` for more ray shards
    than ranks."""
    if n_scene * n_ray_shards > n_dev:
        if n_ray_shards > n_dev:
            raise ValueError(
                f"ray_shards={n_ray_shards} exceeds the {n_dev} available "
                f"devices; reduce --ray-shards"
            )
        scene_rows = min(max(1, n_dev // n_ray_shards), n_scene)
        while n_scene % scene_rows:  # every row holds as many scenes
            scene_rows -= 1
        return (scene_rows, n_ray_shards), (
            f"[TRAIN-MULTI] note: {n_scene} scenes x {n_ray_shards} ray "
            f"shards > {n_dev} devices; using a ({scene_rows}, "
            f"{n_ray_shards}) mesh with scenes sharded over {scene_rows} "
            f"rows")
    return (min(n_scene, max(1, n_dev // max(1, n_ray_shards))),
            n_ray_shards), None


def _all_scenes(mesh, values, n_scene, device):
    """Every scene's value (a float a scene) on every rank, from each row's
    first ray shard's block; host floats."""
    block = mesh.block(n_scene)
    full = torch.zeros(n_scene, dtype=torch.float64, device=device)
    if mesh.rays is not None and mesh.rays.rank == 0 and len(block):
        full[block.start:block.stop] = torch.as_tensor(
            values, dtype=torch.float64, device=device)
    if dist.is_initialized():
        dist.all_reduce(full)
    return full.tolist()


def _eval_scenes(cfg, stage, i, expdir, datas, scenes, states, names, mesh,
                 device):
    """Held-out renders of this rank's scenes (capped by ``max_images``);
    prints every scene's mean test PSNR."""
    statics = _eval_statics(cfg, stage)
    block = mesh.block(len(names))
    psnrs = []
    for s, state in zip(block, states):
        data = datas[s]
        if len(data["i_test"]) == 0 or mesh.rays.rank != 0:
            psnrs.append(float("nan"))
            continue
        cap = cfg.max_images if cfg.max_images else len(data["i_test"])
        idx = np.asarray(data["i_test"][:cap])
        res = render_path(
            data["poses"][idx], state["params"], scenes[s - block.start],
            statics, data["H"], data["W"], data["K"],
            gt_imgs=data["images"][idx],
            savedir=expdir / f"scene_{names[s]}" / f"testset_{i:06d}",
            tile_rays=cfg.tile_rays, device=device,
        )
        psnrs.append(float(np.mean(res["psnrs"])) if res["psnrs"]
                     else float("nan"))
    every = _all_scenes(mesh, psnrs, len(names), device)
    line = " ".join(f"{n}:{v:.2f}" for n, v in zip(names, every)
                    if np.isfinite(v))
    if world()[0] == 0:
        print(f"[TRAIN-MULTI] Iter {i} per-scene test PSNR: {line}")
    return dict(zip(names, every))


def run_multi_training(cfg: Config, datadirs, n_ray_shards: int = 1,
                       stage: int = 1, device="cuda"):
    """Train one model a scene, every scene each step. Runs on the card by
    default and raises without one; ``device='cpu'`` trains on the CPU.
    Returns ``(states, names, expdir)``: this rank's scenes' states (a
    list), every scene's name, the experiment directory."""
    device = resolve_device(device)
    enforce_flag_contract(cfg)
    rank, n_dev = world()
    n_scene = len(datadirs)
    shape, note = mesh_layout(n_scene, n_ray_shards, n_dev)
    if note and rank == 0:
        print(note)
    mesh = make_scene_mesh(*shape)
    block = mesh.block(n_scene)
    writer = mesh.rays is not None and mesh.rays.rank == 0
    expdir = setup_expdir(cfg) if rank == 0 else \
        Path(cfg.basedir) / cfg.expname

    datas, scenes, states, vestigials, pools, pool_ids, names = (
        [], [], [], [], [], [], [])
    H = W = focal = None
    n_train = None
    rng = np.random.default_rng(cfg.seed)
    for idx, datadir in enumerate(datadirs):
        sub = cfg.replace(
            datadir=datadir if ":" in datadir else "synthetic",
            seed=cfg.seed + idx,
        ) if datadir.startswith("synthetic") else cfg.replace(datadir=datadir)
        data = load_training_data(sub)
        if H is None:
            H, W, focal = data["H"], data["W"], data["focal"]
            n_train = len(data["i_train"])
        elif (H, W) != (data["H"], data["W"]):
            raise ValueError("all scenes must share resolution")
        elif len(data["i_train"]) != n_train:
            raise ValueError("all scenes must share the train view count")
        name = _scene_name(datadir, idx)
        datas.append(data)
        names.append(name)
        if idx in block:
            i_train = data["i_train"]
            scenes.append(prepare_scene(data["images"][i_train],
                                        data["poses"][i_train], data["K"],
                                        device=device))
            params = _init_params(
                sub, torch.Generator().manual_seed(cfg.seed + idx), device)
            if stage == 1:
                states.append(init_stage1_state(params, cfg.weight_decay))
            else:
                if cfg.pretrain_path:
                    pre = latest_checkpoint(
                        Path(cfg.pretrain_path) / f"scene_{name}")
                    if pre is None:
                        raise FileNotFoundError(
                            f"no stage-1 checkpoint for scene {name} under "
                            f"{cfg.pretrain_path}/scene_{name}")
                    tmp = init_stage1_state(params, cfg.weight_decay)
                    params = stage1_restore(pre, tmp)["params"]
                    print(f"[TRAIN-MULTI] {name}: stage-2 bootstrap from "
                          f"{pre}")
                vestigials.append(_init_params(
                    sub, torch.Generator().manual_seed(cfg.seed + idx + 1),
                    device)["nerf"])
                states.append(init_stage2_state(params, cfg.weight_decay))
        # every rank builds every pool: one host stream, in scene order
        p, ids = build_ray_pool(data["images"], data["poses"], data["K"],
                                list(data["i_train"]), cfg.num_neighbor, rng)
        pools.append(p)
        pool_ids.append(ids)

    # ---- auto-resume: all or nothing, from the per-scene checkpoints ----
    start = 0
    own = [latest_checkpoint(expdir / f"scene_{n}") for n in names]
    if not cfg.no_reload and all(c is not None for c in own):
        for s, ck in zip(range(len(states)), own[block.start:block.stop]):
            if stage == 1:
                states[s] = stage1_restore(ck, states[s])
            else:
                states[s], vestigials[s] = stage2_restore(ck, states[s],
                                                          vestigials[s])
        steps = [int(Path(c).stem) for c in own]  # named by their step
        start = min(steps)
        if rank == 0:
            print(f"[TRAIN-MULTI] resumed {n_scene} scenes at step {start} "
                  f"(per-scene steps {steps})")
    elif not cfg.no_reload and any(c is not None for c in own) \
            and rank == 0:
        print("[TRAIN-MULTI] WARNING: partial per-scene checkpoints found; "
              "starting fresh (delete or complete the set to resume)")

    if rank == 0:
        print(f"Multi-scene stage-{stage}: {n_scene} scenes on mesh "
              f"{mesh.shape} res {W}x{H} on {device}")
    pool_len = pools[0].shape[0]
    # the pools live on the device for the whole run; each step slices its
    # batch there, and a reshuffle permutes each scene's pool in place
    pools_d, ids_d = place_scene_pools(mesh, stack_scenes(pools),
                                       stack_scenes(pool_ids), device)
    del pools, pool_ids

    def reshuffle():
        reshuffle_scene_pools(pools_d, ids_d, int(rng.integers(0, 2**63 - 1)),
                              block.start)

    if stage == 1:
        nerf_step = make_multi_scene_pooled_step(cfg, H, W, focal, mesh, 1,
                                                 "nerf")
        sampler_step = make_multi_scene_pooled_step(cfg, H, W, focal, mesh,
                                                    1, "sampler")

        def lr_fn(s):
            return stage1_lr(s, cfg.lrate, cfg.lrate_decay)
    else:
        joint_step = make_multi_scene_pooled_step(cfg, H, W, focal, mesh, 2)

        def lr_fn(s):
            return stage2_lr(s, cfg.lrate, cfg.lrate_decay)

    def save_all(i):
        for s, state in zip(block, states):
            if not writer:
                break
            path = checkpoint_path(expdir / f"scene_{names[s]}", i)
            if stage == 1:
                save_checkpoint(path, stage1_ckpt(state))
            else:
                save_checkpoint(path, stage2_ckpt(
                    state, vestigials[s - block.start]))
        if dist.is_initialized():
            dist.barrier()
        if rank == 0:
            print(f"Saved {n_scene} per-scene checkpoints at iter {i}")

    n_iters = N_ITERS_DEFAULT + 1
    if cfg.max_steps is not None:
        n_iters = start + cfg.max_steps + 1
    i_batch = 0
    # a resumed run replays the host stream (reshuffles and controls) up to
    # its step, so that it sees the batches the uninterrupted run saw
    for i in range(1, start + 1):
        if i_batch + cfg.N_rand > pool_len:
            reshuffle()
            i_batch = 0
        _draw_controls(rng, n_train, cfg, i)
        i_batch += cfg.N_rand
    t0 = time.time()
    for i in range(start + 1, n_iters):
        if i_batch + cfg.N_rand > pool_len:
            reshuffle()
            i_batch = 0
        controls = _draw_controls(rng, n_train, cfg, i, device)
        lr = lr_fn(i - 1)
        if stage == 1:
            step = nerf_step if i % 2 != 0 else sampler_step
        else:
            step = joint_step
        states, metrics = step(states, scenes, pools_d, ids_d, i_batch,
                               controls, lr)
        i_batch += cfg.N_rand

        if i % cfg.i_print == 0:
            losses = np.asarray(_all_scenes(mesh, metrics["loss"].tolist(),
                                            n_scene, device))
            if not np.all(np.isfinite(losses)):
                raise FloatingPointError(
                    f"Non-finite loss at iter {i}: {losses}")
            rate = (i - start) / max(time.time() - t0, 1e-9)
            per_scene = " ".join(f"{n}:{v:.4f}"
                                 for n, v in zip(names, losses))
            if rank == 0:
                print(f"[TRAIN-MULTI] Iter: {i} it/s: {rate:.2f} loss "
                      f"{per_scene}")

        if i % cfg.i_weights == 0:
            save_all(i)
        if cfg.i_testset > 0 and i % cfg.i_testset == 0 and i > start + 1:
            _eval_scenes(cfg, stage, i, expdir, datas, scenes, states,
                         names, mesh, device)

    # a final checkpoint, so that a short run always leaves one behind
    final = int(states[0]["global_step"]) if states else n_iters - 1
    save_all(final)
    return states, names, expdir


def _train_rank(rank, world_size, init_method, cfg, datadirs, n_ray_shards,
                stage, device_type, threads):
    """One spawned rank of ``launch_multi_training``: joins the group on its
    device, trains, and leaves the group."""
    torch.set_num_threads(threads)
    device = torch.device("cuda", rank) if device_type == "cuda" \
        else torch.device("cpu")
    init_group(device, world_size, rank, init_method)
    try:
        run_multi_training(cfg, datadirs, n_ray_shards, stage, device)
    finally:
        close_group()


def launch_multi_training(cfg: Config, datadirs, n_ray_shards: int = 1,
                          stage: int = 1, device="cuda",
                          nproc: int | None = None):
    """``run_multi_training`` over ``nproc`` ranks of this machine (default
    ``launch.local_ranks``: every visible card, one process on the CPU).

    The layout is checked before any rank starts (``mesh_layout``'s
    ``ValueError``), and so is ``nproc`` against the visible cards. One
    rank trains in this process, in a world of one formed and closed here
    (NCCL on the card, gloo on the CPU), and returns what
    ``run_multi_training`` returns. More are spawned with a ``file://``
    rendezvous; each rank shares the host's CPU threads, and a failed rank
    raises here. Their states stay in the ranks: this returns ``(None,
    names, expdir)``, and the checkpoints under ``expdir`` are the
    result."""
    device = resolve_device(device)
    if nproc is None:
        nproc = local_ranks(device)
    if nproc < 1:
        raise ValueError(f"nproc={nproc}: a run needs at least one rank")
    if device.type == "cuda" and nproc > torch.cuda.device_count():
        raise ValueError(f"nproc={nproc} exceeds the "
                         f"{torch.cuda.device_count()} visible CUDA devices")
    mesh_layout(len(datadirs), n_ray_shards, nproc)
    print(f"[TRAIN-MULTI] {nproc} rank{'s' if nproc > 1 else ''} over "
          f"{backend_for(device)}")
    if nproc == 1:
        init_group(device)
        try:
            return run_multi_training(cfg, datadirs, n_ray_shards, stage,
                                      device)
        finally:
            close_group()
    spawn_local(_train_rank, nproc,
                (cfg, list(datadirs), n_ray_shards, stage, device.type,
                 max(1, torch.get_num_threads() // nproc)))
    return (None, [_scene_name(d, i) for i, d in enumerate(datadirs)],
            Path(cfg.basedir) / cfg.expname)
