"""Depth-sample manipulation: sorting with payloads, NDC<->3D depth,
per-sample bin constraints, and the stage-1 "exploration" machinery.

Stage-1 exploration multiplies the S refined samples by a per-step random
integer n_mult in [1, max_total // S]. It is laid out at a fixed width
``max_total``: slot j maps to (sample s = j // n_mult, multiplier m = j %
n_mult), and slots with j >= S * n_mult are parked at ``far`` and masked out
of compositing. n_mult is a host integer in the per-step loop (so the trainer
may pick the width per step, ``explore_buckets``) or a 0-d device tensor in
a captured step (``train/fast_loop.py``); the two forms agree bit for bit.

``sample_pdf`` is the classic hierarchical (inverse-CDF) sampler, kept for
API parity: the release configs run ``N_importance = 0``.
"""

from __future__ import annotations

import torch


def sort_with_payloads(keys, *payloads):
    """Ascending STABLE sort of ``keys`` along the last axis, carrying each
    payload through the same permutation. Stability matters on the bf16
    path, where two of a ray's depths can be equal: equal keys keep their
    order, and so do their payloads."""
    keys, order = torch.sort(keys, dim=-1, stable=True)
    return (keys,) + tuple(torch.gather(p, -1, order) for p in payloads)


def ndc_to_3d_depth(z_ndc, eps: float):
    """NDC depth in [0, 1) -> 3D camera-space depth 1 / (1 - z - eps).

    eps is stage-dependent (1e-6 stage 1; 1e-5 stage 2 / inference) and
    matters numerically near the far plane, so it is an explicit argument.
    """
    return 1.0 / (1.0 - z_ndc - eps)


def sort_sampler_depths(mm_out, n_samples: int, near: float, far: float,
                        ndc_eps: float):
    """The sampler's candidate depths, sorted, from its raw output.

    ``mm_out`` [N, >= 3 S] holds S depth logits, then S density offsets
    (``mm_add``) and S density scales (``mm_mul``). The depths are
    ``sigmoid(logit) * (far - near) + near``, sorted ascending and stably;
    the corrections move with them.

    Returns ``(depth_values, mm_add, mm_mul, z3d)``, each [N, S], ``z3d``
    the 3D depth of each sorted depth (:func:`ndc_to_3d_depth`). This chain
    is the plain version of ``kernels/depth_sort.py``'s kernel.
    """
    S = n_samples
    depth_values = torch.sigmoid(mm_out[:, :S]) * (far - near) + near
    depth_values, mm_add, mm_mul = sort_with_payloads(
        depth_values, mm_out[:, S: 2 * S], mm_out[:, 2 * S: 3 * S])
    return depth_values, mm_add, mm_mul, ndc_to_3d_depth(depth_values,
                                                         ndc_eps)


def bin_constrain(depths_sorted, refine_sig, near, far):
    """Constrain refined depths to per-sample bins around the sorted sampler
    depths: bin s spans [midpoint(s-1, s), midpoint(s, s+1)] with the first /
    last bins half-open toward near / far.

    Args:
      depths_sorted: [N, S] sorted sampler depths.
      refine_sig: [N, S] refine-net sigmoids in (0, 1).
      near, far: scalars (or [N, 1]).

    Returns: [N, S] refined depths, one inside each bin.
    """
    mids = 0.5 * (depths_sorted[..., 1:] + depths_sorted[..., :-1])
    upper = torch.cat([mids, 0.5 * (far + depths_sorted[..., -1:])], dim=-1)
    lower = torch.cat([0.5 * (near + depths_sorted[..., :1]), mids], dim=-1)
    return lower + (upper - lower) * refine_sig


def _neighbors(z_vals, near, far):
    """The next sample (``far`` after the last) and the previous one
    (``near`` before the first) of every sample."""
    next_z = torch.cat([z_vals[..., 1:], torch.full_like(z_vals[..., :1], far)],
                       dim=-1)
    prev_z = torch.cat([torch.full_like(z_vals[..., :1], near),
                        z_vals[..., :-1]], dim=-1)
    return next_z, prev_z


def _per_slot(x, n_mult: int, max_total: int):
    """``x[:, min(j // n_mult, S - 1)]`` for slot j < max_total, written as
    an expand and a reshape so that its gradient is a sum over each sample's
    copies (an index with repeats would accumulate with atomics on the card,
    in no fixed order)."""
    N, S = x.shape
    rep = x[:, :, None].expand(N, S, n_mult).reshape(N, S * n_mult)
    if S * n_mult >= max_total:
        return rep[:, :max_total]
    return torch.cat(
        [rep, x[:, -1:].expand(N, max_total - S * n_mult)], dim=-1)


def _per_slot_index(x, n_mult, max_total: int):
    """``x[:, min(j // n_mult, S - 1)]`` for slot j < max_total with
    ``n_mult`` a 0-d device tensor (as the JAX package indexes), with no
    host sync. No gradient flows here on the training path (the stage-1 NeRF
    step runs the sampler and refine nets frozen); where one did, the
    index's backward would sum each sample's copies with atomics on the
    card."""
    S = x.shape[1]
    j = torch.arange(max_total, device=x.device)
    s = torch.clamp(torch.div(j, n_mult, rounding_mode="floor"), max=S - 1)
    return x.index_select(1, s)


def explore_expand(z_vals, n_mult, direction_up, near, far,
                   max_total: int = 64):
    """Fixed-width sample multiplication for the stage-1 NeRF exploration.

    For each base sample s, n_mult shifted copies are laid out sample-major
    (slot j = s * n_mult + m) with the m-th copy offset by (m / n_mult) of the
    one-sided gap toward the next (direction_up) or previous sample. Slots
    beyond S * n_mult are parked at ``far``. The result is sorted ascending
    (stably, as ``jnp.sort``), so the valid samples occupy the first
    ``num_valid`` slots; gradients flow through the permutation.

    Args:
      z_vals: [N, S] refined depths (sorted).
      n_mult: a host integer in [1, max_total // S], or a 0-d integer tensor
        on z's device (the form a captured step takes; no host sync, and
        equal to the host form bit for bit).
      direction_up: a host bool, or a 0-d bool tensor on z's device (both
        directions are computed and one is chosen with ``torch.where``).
      near, far: scalars.

    Returns:
      z_expanded: [N, max_total] sorted, invalid slots == far.
      num_valid: S * n_mult (a 0-d tensor for a tensor n_mult).
    """
    N, S = z_vals.shape
    j = torch.arange(max_total, device=z_vals.device)
    next_z, prev_z = _neighbors(z_vals, near, far)
    if torch.is_tensor(n_mult):
        # linspace(0, 1 - 1/n, n) == m / n, divided in the dtype of z
        frac = (j % n_mult).to(z_vals.dtype) / n_mult.to(z_vals.dtype)
        per_slot = _per_slot_index
    else:
        n_mult = int(n_mult)
        frac = (j % n_mult).to(z_vals.dtype) / float(n_mult)
        per_slot = _per_slot
    base = per_slot(z_vals, n_mult, max_total)

    def up():
        return frac[None, :] * per_slot(torch.abs(z_vals - next_z), n_mult,
                                        max_total)

    def down():
        return -frac[None, :] * per_slot(torch.abs(z_vals - prev_z), n_mult,
                                         max_total)

    if torch.is_tensor(direction_up):  # a device coin: both, then choose
        offset = torch.where(direction_up, up(), down())
    else:
        offset = up() if direction_up else down()
    valid = (j < S * n_mult)[None, :]
    z_exp = torch.where(valid, base + offset, torch.full_like(base, far))
    z_exp, _ = torch.sort(z_exp, dim=-1, stable=True)
    return z_exp, S * n_mult


def gap_jitter(z_vals, near, far, direction_up: bool, max_noise: float,
               noise=None, generator=None):
    """One-sided gap-scaled Gaussian jitter shared by stage-1 exploration
    (max_noise=0.99) and stage-2 training (max_noise=1-2e-6).

    noise = min(|N(0,1)| / 5, max_noise); moved toward the next sample
    (direction_up) or the previous one, scaled by that gap, so ordering is
    preserved. Invalid (parked-at-far) slots see zero up-gap and are restored
    by the caller. ``direction_up`` is a host bool or a 0-d bool tensor.

    ``noise`` supplies the N(0,1) draw ([N, >= S]; its first S columns are
    used); without it the draw comes from ``generator`` (a
    ``torch.Generator`` on z's device).
    """
    next_z, prev_z = _neighbors(z_vals, near, far)
    if noise is None:
        noise = torch.randn(z_vals.shape, generator=generator,
                            dtype=z_vals.dtype, device=z_vals.device)
    else:
        noise = noise[..., : z_vals.shape[-1]].to(z_vals.dtype)
    mag = torch.clamp(torch.abs(noise) / 5.0, max=max_noise)
    if torch.is_tensor(direction_up):  # a device coin: both, then choose
        return torch.where(direction_up,
                           z_vals + mag * torch.abs(z_vals - next_z),
                           z_vals - mag * torch.abs(z_vals - prev_z))
    if direction_up:
        return z_vals + mag * torch.abs(z_vals - next_z)
    return z_vals - mag * torch.abs(z_vals - prev_z)


def sample_pdf(bins, weights, n_samples: int, det: bool = False,
               generator=None):
    """Hierarchical inverse-CDF sampling (the classic NeRF importance
    sampler).

    Args:
      bins: [N, B] bin edges (sorted).
      weights: [N, B-1] unnormalized weights.
      n_samples: samples to draw per ray.
      det: deterministic (evenly spaced quantiles) instead of uniform
        draws from ``generator`` (a ``torch.Generator`` on the bins'
        device).

    Returns: [N, n_samples] samples.
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)

    shape = (*cdf.shape[:-1], n_samples)
    if det:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype,
                           device=cdf.device).expand(shape).contiguous()
    else:
        u = torch.rand(shape, generator=generator, dtype=cdf.dtype,
                       device=cdf.device)

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)

    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bin_b = torch.gather(bins, -1, below)
    bin_a = torch.gather(bins, -1, above)

    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bin_b + t * (bin_a - bin_b)
