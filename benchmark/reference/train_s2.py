"""Stage-2 joint refinement in plain float32 PyTorch: the benchmark's
reference for a chunk of the published schedule's second stage
(``configs/llff/fern/fern_refine.txt``, 370k steps after stage 1).

Every step trains all three nets at once (SURVEY §2.3): the sampler's and
the refine net's gradients flow through the sorted depths, the per-sample
bins, the jitter and the 3-D point offsets into the NeRF samples (never
through the epipolar gather). The render differs from stage 1's sampler
step in ``near`` 0, the NDC epsilon 1e-5, the refine net's colours in
[view, sample, channel] order, a one-sided gap jitter of the refined depths
(no sample multiplication), sigma noise, and no +-10 clamp; offsets and the
sampler's density terms are always on. The loss is ``mse(rgb1) + a_mmrgb
(mse(rgb0) + mse(mm_rgb))``; one Adam covers every parameter, at ``lrate
0.1^((step - 1) / (lrate_decay 1000))`` (no halving).

Departures from the original training script (SURVEY §2.3), the JAX design
the port follows:
- a step's random choices come from a generator on the device seeded by
  (seed, step) alone, in the stage-1 reference's order (``train.draws``, at
  a width of ``N_samples``): the jitter coin, the neighbour positions, then
  N(0, 1) sigma noise and jitter noise [N_rand, N_samples];
- each ray's neighbours are its other training views in distance order at
  positions drawn once a step for the whole batch (``train.neighbours``);
- the jitter's magnitude min(|noise| / 5, 1 - 2e-6) of the gap to the next
  (coin up) or previous sample, for the whole batch one side;
- Adam is optax's ``scale_by_adam`` (eps outside the square root), and the
  learning rate is rounded to float32;
- batches are rows of a device-shuffled pool of every training ray, not a
  host permutation; the second Adam (``optimizer_nerf``) is never stepped
  and is left out.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import pronerf as ref
from .scene import ndc_rays
from .train import adam, draws, neighbours

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# The stage-2 render: jitter without exploration, offsets and density terms
# on, no clamp; ``frozen`` runs the sampler and refine nets without their
# gradients (a stage-1 NeRF step's treatment; only a planted fault sets it).
STAGE2 = dict(near=0.0, far=1.0, eps=1e-5, layout="vsc", frozen=False,
              jitter=True, offsets=True, use_mm=True, clamp=False)
JITTER_MAX = 1.0 - 2e-6


def stage2_lr(step: int, lrate: float, lrate_decay: int) -> float:
    return float(np.float32(lrate * 0.1 ** ((step - 1)
                                            / (lrate_decay * 1000.0))))


def jitter(z, up: bool, noise, near: float, far: float):
    """Each sample moved by min(|noise| / 5, JITTER_MAX) of its gap to the
    next sample (``far`` after the last; ``up``) or the previous one
    (``near`` before the first)."""
    mag = (noise[:, :z.shape[1]].abs() / 5.0).clamp(max=JITTER_MAX)
    if up:
        nxt = torch.cat([z[:, 1:], torch.full_like(z[:, :1], far)], -1)
        return z + mag * (z - nxt).abs()
    prv = torch.cat([torch.full_like(z[:, :1], near), z[:, :-1]], -1)
    return z - mag * (z - prv).abs()


def render_rays(P, rays, scene, views, ctl, st=STAGE2, N_samples=8,
                n_enc=48, noise_std=1.0):
    """One training batch under the stage-2 statics ``st``: ``rays`` as
    ``pronerf.render_rays`` takes them, ``views`` [N, V] per-ray
    neighbours, ``ctl``: dir_jitter (host bool), raw_noise and
    jitter_noise [N, >= N_samples]."""
    S, near, far = N_samples, st["near"], st["far"]
    o, d = rays["ndc_o"], rays["ndc_d"]
    N = o.shape[0]
    frozen = torch.no_grad() if st["frozen"] else contextlib.nullcontext()

    t = torch.linspace(0.0, 1.0, n_enc, device=o.device)
    sig = ref.plucker(o[:, None] + d[:, None] * t[None, :, None], d[:, None])
    with frozen:
        mm = ref.minmax(P, "sampler", sig.reshape(N, -1))
    depth = torch.sigmoid(mm[:, :S]) * (far - near) + near
    depth, order = torch.sort(depth, dim=-1, stable=True)
    mm_add = mm[:, S:2 * S].gather(1, order)
    mm_mul = mm[:, 2 * S:3 * S].gather(1, order)
    z3d = (1.0 / (1.0 - depth - st["eps"])).detach()

    with torch.no_grad():
        col = ref.epipolar_colors(scene, views, rays["or_o"], rays["or_d"],
                                  z3d)
    if st["layout"] == "svc":
        col = col.transpose(1, 2)
    plk = ref.plucker(o[:, None] + d[:, None] * depth[..., None], d[:, None])
    with frozen:
        r = ref.minmax(P, "refine",
                       torch.cat([plk.reshape(N, -1), col.reshape(N, -1)], -1))
    mids = 0.5 * (depth[:, 1:] + depth[:, :-1])
    upper = torch.cat([mids, 0.5 * (far + depth[:, -1:])], -1)
    lower = torch.cat([0.5 * (near + depth[:, :1]), mids], -1)
    z = lower + (upper - lower) * torch.sigmoid(r[:, :S])
    if st["jitter"]:
        z = jitter(z, bool(ctl["dir_jitter"]), ctl["jitter_noise"], near, far)

    pts = o[:, None] + d[:, None] * z[..., None]
    if st["offsets"]:
        pts = pts + 1e-2 * torch.tanh(r[:, S:4 * S]).reshape(N, S, 3)
    d_pe = ref.posenc(rays["viewdirs"], 4)[:, None].expand(N, S, 27)
    raw = ref.nerf(P, ref.posenc(pts, 10), d_pe)
    use = st["use_mm"]
    noise = noise_std * ctl["raw_noise"][:, :S] if noise_std > 0 else None
    comp = ref.composite(raw, z, d, mm_add if use else None,
                         mm_mul if use else None, noise, st["clamp"])
    return {"rgb1": comp["rgb"], "rgb0": torch.sigmoid(r[:, 4 * S:]),
            "mm_rgb": torch.sigmoid(mm[:, 3 * S:])}


def stage2_steps(P, opt, scene, pool, ids, rows, seed: int, step0: int,
                 cfg: dict, H: int, W: int, focal: float, batch_share=1.0,
                 update=True, st=STAGE2):
    """Steps ``step0 + 1 ...``, one a row block of ``rows`` (index tensors
    into the ray pool ``pool`` [M, 3, 3] (origin, direction, colour) and its
    view ids ``ids``), updating ``P`` and ``opt`` ({count, mu, nu}) in
    place. Returns each step's loss. Faults the check has to see:
    ``batch_share`` < 1 keeps that share of each batch; ``update=False``
    leaves the state unchanged; ``st`` other statics (offsets, jitter or
    the density terms off; ``frozen``: the NeRF alone trained)."""
    device = pool.device
    V, S = cfg["num_neighbor"], cfg["N_samples"]
    max_mult = max(1, 64 // S)
    poses_t = scene["poses"][:, :3, 3]
    losses = []
    for k, idx in enumerate(rows):
        step = step0 + k + 1
        c = draws(seed, step, poses_t.shape[0], V, max_mult, cfg["N_rand"],
                  S, device)
        keep = int(len(idx) * batch_share)
        batch, pid = pool[idx][:keep], ids[idx][:keep].long()
        o, d = batch[:, 0], batch[:, 1]
        n_o, n_d = ndc_rays(H, W, focal, o, d)
        rays = {"ndc_o": n_o, "ndc_d": n_d, "or_o": o, "or_d": d,
                "viewdirs": d / torch.linalg.norm(d, dim=-1, keepdim=True)}
        names = [n for n in P if n.startswith("nerf.")] if st["frozen"] \
            else list(P)
        leaves = {n: P[n].detach().requires_grad_(n in names) for n in P}
        ctl = {"dir_jitter": bool(c["dir_jitter"]),
               "raw_noise": c["raw_noise"][:keep],
               "jitter_noise": c["jitter_noise"][:keep]}
        out = render_rays(leaves, rays, scene,
                          neighbours(poses_t, pid, c["subset"]), ctl, st, S,
                          cfg["N_point_ray_enc"], cfg["raw_noise_std"])
        target = batch[:, 2]
        loss = (out["rgb1"] - target).square().mean() + cfg["a_mmrgb"] * (
            (out["rgb0"] - target).square().mean()
            + (out["mm_rgb"] - target).square().mean())
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        if update:
            adam(opt, P, names, grads,
                 stage2_lr(step, cfg["lrate"], cfg["lrate_decay"]))
        losses.append(float(loss.detach()))
    return losses
