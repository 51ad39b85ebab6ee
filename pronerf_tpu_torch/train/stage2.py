"""Stage-2 joint refinement training: ONE optimizer over all three nets.

- bootstraps the NeRF / sampler / refine nets from a stage-1 checkpoint
  (``pretrain_path``), separate from expdir auto-resume;
- loss = mse(rgb1) + a_mmrgb * (mse(rgb0) + mse(mm_rgb)); the release config
  sets a_mmrgb = 0 so only the NeRF output is supervised;
- a second Adam (optimizer_nerf) exists but is never stepped: its state is
  kept in the checkpoint for layout parity;
- LR decays on global_step WITHOUT the stage-1 halving.

Counterpart of ``pronerf_tpu/train/stage2.py``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from pronerf_tpu_torch.models.pronerf import RenderStatics, render_rays
from pronerf_tpu_torch.ops.metrics import img2mse, mse2psnr
from pronerf_tpu_torch.render.raygen import rays_from_pool
from pronerf_tpu_torch.train.stage1 import net_statics
from pronerf_tpu_torch.train.state import adam_init, adam_step, named_params


def init_stage2_state(params, weight_decay: float = 0.0) -> Dict[str, Any]:
    return {
        "global_step": 0,
        "params": params,
        "opt": adam_init(named_params(params)),
        "opt_nerf": adam_init(named_params(params, ["nerf"])),  # never stepped
        "weight_decay": weight_decay,
    }


def make_stage2_step(cfg, H: int, W: int, focal: float, reduce=None):
    """The stage-2 step, with the signature (and the ``reduce``) of the
    stage-1 steps."""
    statics = RenderStatics.stage2(noise_std=cfg.raw_noise_std,
                                   **net_statics(cfg))
    a_mmrgb = float(cfg.a_mmrgb)

    def train_step(state, scene, batch_rays, pose_ids, controls, lr):
        rays = rays_from_pool(batch_rays[:, :2], pose_ids, H, W, focal)
        target = batch_rays[:, 2]
        named = named_params(state["params"])
        out = render_rays(state["params"], rays, scene, controls, statics)
        img_loss = img2mse(out["rgb1"], target)
        aux = img2mse(out["rgb0"], target) + img2mse(out["mm_rgb"], target)
        loss = img_loss + a_mmrgb * aux
        grads = torch.autograd.grad(loss, list(named.values()))
        loss, img_loss = loss.detach(), img_loss.detach()
        if reduce is not None:
            (loss, img_loss), grads = reduce([loss, img_loss], grads)
        adam_step(state["opt"], named, grads, lr, state["weight_decay"],
                  controls.get("adam_count"))
        state["global_step"] += 1
        return state, {"loss": loss, "psnr": mse2psnr(img_loss)}

    return train_step
