"""Stage-1 alternating training: two step functions.

The reference alternates per iteration:
- odd i, the NeRF "exploration" step: loss = mse(rgb1, target); only the
  NeRF params step (their own Adam state); sampler/refine run frozen;
  samples are multiplied and jittered;
- even i, the sampler "exploitation" step: loss = mse(rgb1) + mse(rgb0) +
  mse(mm_rgb) (all unweighted: a_mmrgb is NOT applied in stage 1); a second
  Adam over ALL three nets steps.

Counterpart of ``pronerf_tpu/train/stage1.py``. Gradients are torch autograd
over the plain ops (the JAX package trains without its Pallas kernels too).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from pronerf_tpu_torch.models.pronerf import RenderStatics, render_rays
from pronerf_tpu_torch.ops.metrics import img2mse, mse2psnr
from pronerf_tpu_torch.render.raygen import rays_from_pool
from pronerf_tpu_torch.train.state import adam_init, adam_step, named_params


def init_stage1_state(params, weight_decay: float = 0.0) -> Dict[str, Any]:
    """{global_step, params, opt_nerf (over the NeRF), opt_s (over all three
    nets)}; ``weight_decay`` is carried for the steps."""
    return {
        "global_step": 0,
        "params": params,
        "opt_nerf": adam_init(named_params(params, ["nerf"])),
        "opt_s": adam_init(named_params(params)),
        "weight_decay": weight_decay,
    }


def train_compute_dtype(cfg):
    """``train_precision = 'bf16'``: bf16 operands with f32 accumulation in
    the nets (params, grads, optimizer and loss stay f32)."""
    return "bfloat16" if getattr(cfg, "train_precision", "f32") == "bf16" \
        else None


def net_statics(cfg):
    return dict(
        N_samples=cfg.N_samples,
        N_point_ray_enc=cfg.N_point_ray_enc,
        num_neighbor=cfg.num_neighbor,
        multires=cfg.multires,
        multires_views=cfg.multires_views,
        white_bkgd=cfg.white_bkgd,
        netarch=cfg.netarch,
        train_gather=cfg.train_gather,
        compute_dtype=train_compute_dtype(cfg),
    )


def explore_widths(cfg, max_expand: int):
    """The widths a NeRF step may run at: with ``explore_buckets`` the powers
    of two from S up to ``max_expand`` (and ``max_expand``), else only
    ``max_expand``."""
    if not getattr(cfg, "explore_buckets", False):
        return [max_expand]
    widths, w = [], cfg.N_samples
    while w < max_expand:
        widths.append(w)
        w *= 2
    return widths + [max_expand]


def explore_width(widths, n_samples: int, n_mult: int) -> int:
    """The smallest width of ``widths`` covering ``n_samples * n_mult``."""
    return next(w for w in widths
                if w // n_samples >= n_mult or w == widths[-1])


def step_width(controls, widths, n_samples: int) -> int:
    """A NeRF step's width, known on the host: ``controls['width']`` where
    the caller read it (the scan executor reads a chunk's n_mult once),
    the one width without ``explore_buckets``, else the one covering the
    host integer ``controls['n_mult']``. A device n_mult is never read here
    (that would be a host sync a step)."""
    if controls.get("width") is not None:
        return controls["width"]
    if len(widths) == 1:
        return widths[0]
    n_mult = controls["n_mult"]
    if torch.is_tensor(n_mult):
        raise ValueError("explore_buckets with a device n_mult: pass the "
                         "step's width as controls['width']")
    return explore_width(widths, n_samples, n_mult)


def make_stage1_steps(cfg, H: int, W: int, focal: float, reduce=None):
    """The two stage-1 steps, each

      (state, scene, batch_rays [N, 3, 3], pose_ids [N], controls, lr)
        -> (state, metrics {'loss', 'psnr'} as 0-d tensors)

    updating ``state`` in place (its params, the stepped optimizer, the
    step count). ``controls`` as ``render_rays`` takes them, host values
    (the per-step loop) or 0-d device tensors (the scan executor, which also
    gives ``width`` and the Adam step count ``adam_count``); ``lr`` a float
    or a 0-d device tensor. With tensors a step makes no host sync, so a
    CUDA graph can capture it.

    ``reduce`` (``parallel/data_parallel.py:mean_all_reduce``) combines a
    shard's losses and gradients with the other shards' before the update,
    where the batch is split over ranks: ``(losses, grads) -> (losses,
    grads)``."""
    statics_nerf = RenderStatics.stage1_nerf(noise_std=cfg.raw_noise_std,
                                              **net_statics(cfg))
    statics_sampler = RenderStatics.stage1_sampler(**net_statics(cfg))
    me = statics_nerf.max_expand
    widths = explore_widths(cfg, me)

    def nerf_step(state, scene, batch_rays, pose_ids, controls, lr):
        rays = rays_from_pool(batch_rays[:, :2], pose_ids, H, W, focal)
        target = batch_rays[:, 2]
        params = state["params"]
        n = target.shape[0]
        # The noise is drawn at the full width and sliced to the step's, so
        # every width sees the same per-slot stream (unless given).
        ctl = dict(controls)
        for key in ("raw_noise", "jitter_noise"):
            if ctl.get(key) is None:
                ctl[key] = torch.randn(n, me, generator=ctl.get("rng"),
                                       device=target.device)
        width = step_width(controls, widths, cfg.N_samples)
        statics = dataclasses.replace(statics_nerf, max_expand=width)
        named = named_params(params, ["nerf"])
        out = render_rays(params, rays, scene, ctl, statics)
        loss = img2mse(out["rgb1"], target)
        grads = torch.autograd.grad(loss, list(named.values()))
        loss = loss.detach()
        if reduce is not None:
            (loss,), grads = reduce([loss], grads)
        adam_step(state["opt_nerf"], named, grads, lr,
                  state["weight_decay"], controls.get("adam_count"))
        state["global_step"] += 1
        return state, {"loss": loss, "psnr": mse2psnr(loss)}

    def sampler_step(state, scene, batch_rays, pose_ids, controls, lr):
        rays = rays_from_pool(batch_rays[:, :2], pose_ids, H, W, focal)
        target = batch_rays[:, 2]
        params = state["params"]
        named = named_params(params)
        out = render_rays(params, rays, scene, controls, statics_sampler)
        img_loss = img2mse(out["rgb1"], target)
        total = img_loss + img2mse(out["rgb0"], target) \
            + img2mse(out["mm_rgb"], target)
        grads = torch.autograd.grad(total, list(named.values()))
        total, img_loss = total.detach(), img_loss.detach()
        if reduce is not None:
            (total, img_loss), grads = reduce([total, img_loss], grads)
        adam_step(state["opt_s"], named, grads, lr, state["weight_decay"],
                  controls.get("adam_count"))
        state["global_step"] += 1
        return state, {"loss": total, "psnr": mse2psnr(img_loss)}

    return nerf_step, sampler_step
