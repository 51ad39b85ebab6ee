"""Stage-1 training in plain float32 PyTorch: the benchmark's reference for
a chunk of the published schedule (``configs/llff/fern/fern_epi.txt``).

Steps alternate: an odd step trains the NeRF alone (exploration to 64
samples, jitter, sigma noise; the sampler and refine nets frozen; loss the
MSE of rgb1) with its own Adam, an even step trains all three nets (loss
the MSE of rgb1 + rgb0 + the sampler's rgb) with a second Adam over all.
Adam is optax's ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the
square root, bias corrections by each optimizer's step count), then
``p - lr u``; the learning rate decays as lrate 0.1^((step - 1) / 2 /
(lrate_decay 1000)).

A step's random choices come from a generator on the device seeded by
(seed, step) alone, drawn in a fixed order (``draws``): n_mult ~
U{1..max_mult}, the exploration and jitter coins ~ Bernoulli(1/2), the
neighbour positions (a sorted draw of V of the T - 1 other views without
replacement), then N(0, 1) sigma noise and jitter noise [N_rand, 64].
"""

from __future__ import annotations

import numpy as np
import torch

from . import pronerf as ref
from .scene import ndc_rays

B1, B2, EPS = 0.9, 0.999, 1e-8


def draws(seed: int, step: int, n_train: int, num_neighbor: int,
          max_mult: int, n_rand: int, width: int, device):
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(step)) % (2**63 - 1))
    n_mult = torch.randint(1, max_mult + 1, (), generator=gen, device=device)
    coins = torch.rand(2, generator=gen, device=device) < 0.5
    keys = torch.rand(n_train - 1, generator=gen, device=device)
    subset = torch.sort(torch.argsort(keys, stable=True)[:num_neighbor]).values
    return {"n_mult": n_mult, "dir_expand": coins[0], "dir_jitter": coins[1],
            "subset": subset,
            "raw_noise": torch.randn(n_rand, width, generator=gen,
                                     device=device),
            "jitter_noise": torch.randn(n_rand, width, generator=gen,
                                        device=device)}


def moments_from_tree(tree, device="cpu"):
    """An optimizer's moment pytree (all three nets, or the NeRF alone) as
    the reference's named tensors."""
    out = {}
    if set(tree) == {"nerf", "sampler", "refine"}:
        return ref.weights_from_tree(tree["nerf"], tree["sampler"],
                                     tree["refine"], device)
    for i, p in enumerate(tree["pts"]):
        ref._layer(out, f"nerf.pts.{i}", p, device)
    for name in ("alpha", "feature", "views", "rgb"):
        ref._layer(out, f"nerf.{name}", tree[name], device)
    return out


def neighbours(poses_t, pose_id, subset):
    """[N, V] per-ray views: each ray's other training views sorted by
    camera distance (its own view last), at the positions ``subset``."""
    dist = torch.linalg.norm(poses_t[pose_id][:, None] - poses_t[None], dim=-1)
    own = torch.arange(poses_t.shape[0], device=dist.device)[None] \
        == pose_id[:, None]
    dist = torch.where(own, torch.full_like(dist, float("inf")), dist)
    return torch.argsort(dist, dim=-1, stable=True)[:, :-1][:, subset]


def adam(opt, P, names, grads, lr):
    """One Adam update of the leaves ``names`` of ``P`` (in place)."""
    opt["count"] += 1
    bc1 = 1.0 - torch.tensor(B1) ** float(opt["count"])
    bc2 = 1.0 - torch.tensor(B2) ** float(opt["count"])
    with torch.no_grad():
        for n, g in zip(names, grads):
            mu = opt["mu"][n] = (1 - B1) * g + B1 * opt["mu"][n]
            nu = opt["nu"][n] = (1 - B2) * g * g + B2 * opt["nu"][n]
            P[n] = P[n] - lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + EPS))


def stage1_lr(step: int, lrate: float, lrate_decay: int) -> float:
    return float(np.float32(lrate * 0.1 ** ((step - 1) / 2.0
                                            / (lrate_decay * 1000.0))))


def stage1_steps(P, opts, scene, pool, ids, rows, seed: int, step0: int,
                 cfg: dict, H: int, W: int, focal: float, batch_share=1.0,
                 update=True):
    """Steps ``step0 + 1 ...``, one a row block of ``rows`` (index tensors
    into the ray pool ``pool`` [M, 3, 3] (origin, direction, colour) and its
    view ids ``ids``), updating ``P`` and ``opts`` ({'nerf', 's'}) in place.
    Returns each step's loss. Faults the check has to see: ``batch_share``
    < 1 keeps that share of each batch; ``update=False`` leaves the state
    unchanged."""
    device = pool.device
    V, S = cfg["num_neighbor"], cfg["N_samples"]
    width, max_mult = 64, max(1, 64 // S)
    poses_t = scene["poses"][:, :3, 3]
    losses = []
    for k, idx in enumerate(rows):
        step = step0 + k + 1
        nerf_step = step % 2 == 1
        c = draws(seed, step, poses_t.shape[0], V, max_mult, cfg["N_rand"],
                  width, device)
        keep = int(len(idx) * batch_share)
        batch, pid = pool[idx][:keep], ids[idx][:keep].long()
        o, d = batch[:, 0], batch[:, 1]
        n_o, n_d = ndc_rays(H, W, focal, o, d)
        rays = {"ndc_o": n_o, "ndc_d": n_d, "or_o": o, "or_d": d,
                "viewdirs": d / torch.linalg.norm(d, dim=-1, keepdim=True)}
        names = [n for n in P if n.startswith("nerf.")] if nerf_step \
            else list(P)
        leaves = {n: P[n].detach().requires_grad_(n in names) for n in P}
        ctl = {"n_mult": int(c["n_mult"]), "dir_expand": bool(c["dir_expand"]),
               "dir_jitter": bool(c["dir_jitter"]), "width": width,
               "raw_noise": c["raw_noise"][:keep],
               "jitter_noise": c["jitter_noise"][:keep]}
        out = ref.render_rays(
            leaves, rays, scene, neighbours(poses_t, pid, c["subset"]),
            ref.STAGE1_NERF if nerf_step else ref.STAGE1_SAMPLER, S,
            cfg["N_point_ray_enc"], ctl=ctl)
        target = batch[:, 2]
        loss = (out["rgb1"] - target).square().mean()
        if not nerf_step:
            loss = loss + (out["rgb0"] - target).square().mean() \
                + (out["mm_rgb"] - target).square().mean()
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        if update:
            adam(opts["nerf" if nerf_step else "s"], P, names, grads,
                 stage1_lr(step, cfg["lrate"], cfg["lrate_decay"]))
        losses.append(float(loss.detach()))
    return losses
