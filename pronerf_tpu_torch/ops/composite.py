"""Volume rendering: transform raw MLP outputs into ray colors.

One function covers the three ``raw2outputs`` variants through flags:

- stage 1 clamps raw to +-10 before everything; stage 2 / inference do not;
- the sampler's density corrections (mm_add added to sigma, relu(mm_mul)
  multiplying alpha) apply on stage-1 sampler steps, always in stage 2
  training and at inference;
- ``num_valid`` masks the static 64-slot exploration expansion: slots past
  num_valid contribute zero alpha and the last VALID slot gets the 1e10
  "infinite" final interval.
"""

from __future__ import annotations

import torch

_INF_DIST = 1e10


class _CumprodNonzero(torch.autograd.Function):
    """``torch.cumprod`` along the last axis of an input with no zero
    element. Its backward is the formula PyTorch's own takes for such an
    input, ``reversed_cumsum(output * grad) / input``, without the device
    read (``(input == 0).any().item()``) by which PyTorch's decides: that
    read is a host sync, which a CUDA graph of a training step cannot hold.
    The transmittance factors ``1 - alpha + 1e-10`` are never 0 in f32."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return (out * grad).flip(-1).cumsum(-1).flip(-1) / x


def _cumprod_nonzero(x):
    if torch.is_grad_enabled() and x.requires_grad:
        return _CumprodNonzero.apply(x)
    return torch.cumprod(x, dim=-1)


def composite(
    raw,
    z_vals,
    rays_d,
    *,
    noise=None,
    mm_add=None,
    mm_mul=None,
    clamp_raw: bool = False,
    num_valid=None,
    white_bkgd: bool = False,
):
    """Alpha-composite raw radiance-field outputs along each ray.

    Args:
      raw: [N, S, 4] (rgb logits, sigma).
      z_vals: [N, S] sample depths (ascending).
      rays_d: [N, 3] ray directions (NDC), whose norm scales the intervals.
      noise: optional [N, S] additive sigma noise (training regularizer).
      mm_add, mm_mul: optional [N, S] sampler density corrections.
      clamp_raw: clamp raw to +-10 first (stage-1 behavior).
      num_valid: optional int or 0-d tensor; samples at index >= num_valid
        are masked out (exploration padding).
      white_bkgd: composite onto white.

    Returns: dict(rgb, depth, disp, acc, weights).
    """
    if clamp_raw:
        raw = torch.clamp(raw, -10.0, 10.0)
    rgb = torch.sigmoid(raw[..., :3])
    sigma = raw[..., 3]

    S = z_vals.shape[-1]
    dists = torch.cat(
        [
            z_vals[..., 1:] - z_vals[..., :-1],
            torch.full_like(z_vals[..., :1], _INF_DIST),
        ],
        dim=-1,
    )
    idx = torch.arange(S, dtype=torch.int32, device=z_vals.device)
    if num_valid is not None:
        dists = torch.where(
            idx == num_valid - 1, torch.full_like(dists, _INF_DIST), dists
        )
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    a = sigma
    if noise is not None:
        a = a + noise
    if mm_add is not None:
        a = a + mm_add
    alpha = 1.0 - torch.exp(-torch.relu(a) * dists)
    if mm_mul is not None:
        alpha = alpha * torch.relu(mm_mul)
    if num_valid is not None:
        alpha = torch.where(idx < num_valid, alpha, torch.zeros_like(alpha))

    # Exclusive cumulative transmittance T_i = prod_{j<i} (1 - alpha_j + 1e-10).
    trans = _cumprod_nonzero(1.0 - alpha + 1e-10)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.maximum(
        torch.full_like(depth_map, 1e-10), depth_map / acc_map
    )
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return {
        "rgb": rgb_map,
        "depth": depth_map,
        "disp": disp_map,
        "acc": acc_map,
        "weights": weights,
    }
