"""Input encodings: NeRF positional encoding and Pluecker ray encoding.

- positional encoding layout is ``[x, sin(2^0 x), cos(2^0 x), ...,
  sin(2^{L-1} x), cos(2^{L-1} x)]`` concatenated on the channel axis;
  L=10 for xyz (63ch), L=4 for view dirs (27ch);
- the Pluecker encoding normalizes the direction and takes the moment
  ``m = p x d_hat`` of each query point treated as an origin, giving 6
  channels per point.
"""

from __future__ import annotations

import torch


def posenc_dim(input_dim: int, num_freqs: int) -> int:
    return input_dim * (1 + 2 * num_freqs)


def positional_encoding(x, num_freqs: int):
    """NeRF sin/cos positional encoding with the input included.

    Args:
      x: [..., D].
      num_freqs: L frequency octaves 2^0 .. 2^{L-1}.

    Returns: [..., D * (1 + 2L)] ordered [x, sin(f0 x), cos(f0 x), ...].
    """
    if num_freqs == 0:
        return x
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]  # [..., L, D]
    # Interleave per-frequency sin/cos blocks: [..., L, 2, D] -> [..., 2LD].
    sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)
    sc = sc.reshape(*x.shape[:-1], 2 * num_freqs * x.shape[-1])
    return torch.cat([x, sc], dim=-1)


def plucker(points, dirs):
    """Pluecker encoding of rays through ``points`` with direction ``dirs``.

    Each query point acts as a ray origin; with the unit direction d the
    moment is m = p x d. Output concatenates [d, m] on the last axis.

    Args:
      points: [..., 3].
      dirs: [..., 3] (broadcastable to points).

    Returns: [..., 6].
    """
    d = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(1e-12)
    d = d.expand(points.shape)
    m = torch.linalg.cross(points, d, dim=-1)
    return torch.cat([d, m], dim=-1)
