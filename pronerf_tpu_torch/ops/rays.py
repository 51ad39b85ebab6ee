"""Ray generation and NDC projection for LLFF forward-facing scenes.

Conventions:
- camera looks along -z, x right, y up (OpenGL style);
- pixel (i, j) maps to camera-space direction
  ``[(i - cx) / fx, -(j - cy) / fy, -1]``;
- NDC projection shifts origins to the ``near`` plane then projects.
"""

from __future__ import annotations

import numpy as np
import torch

from pronerf_tpu_torch.utils.tensors import as_f32


def get_rays(H: int, W: int, K, c2w, device=None):
    """Per-pixel ray origins/directions in world space.

    Args:
      H, W: image size.
      K: [3, 3] intrinsics.
      c2w: [3, 4] camera-to-world matrix.

    Returns:
      (rays_o, rays_d), each [H, W, 3] float32 on ``device``.
    """
    if torch.is_tensor(K):
        K = as_f32(K, device)
        device = K.device
    else:
        # a host K: its entries become device scalars by fill kernels, not
        # by a copy from host memory, which a CUDA graph cannot capture
        k = np.asarray(K, np.float32)
        device = torch.device(device) if device is not None else (
            c2w.device if torch.is_tensor(c2w) else torch.device("cpu"))
        K = [[torch.full((), float(k[r, c]), device=device)
              for c in range(3)] for r in range(2)]
    c2w = as_f32(c2w, device)
    i = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    j = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    dirs = torch.stack(
        [(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1],
         -torch.ones_like(i)],
        dim=-1,
    )
    # Rotate camera-frame dirs into the world frame: d_w = R @ d_c, written
    # as multiplies and a sum so that it is full f32 on any device.
    rays_d = (dirs[..., None, :] * c2w[:3, :3]).sum(-1)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_np(H: int, W: int, K, c2w):
    """NumPy twin of :func:`get_rays` for host-side precompute."""
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32),
        indexing="xy",
    )
    dirs = np.stack(
        [(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1], -np.ones_like(i)],
        -1,
    )
    rays_d = np.einsum("hwc,rc->hwr", dirs, c2w[:3, :3])
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal: float, near: float, rays_o, rays_d):
    """Map world-space rays of a forward-facing scene to NDC.

    Matches the standard NeRF NDC derivation: shift each origin along its ray
    to the ``near`` plane, then apply the perspective NDC warp so that depth
    t in [0, 1] covers [near, infinity).
    """
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2]
    )
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2]
    )
    d2 = -2.0 * near / rays_o[..., 2]

    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def ray_points(rays_o, rays_d, z_vals):
    """Points along rays: o + d * z.

    Args:
      rays_o, rays_d: [..., 3].
      z_vals: [..., S].

    Returns: [..., S, 3].
    """
    return rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]


def linspace_depths(near: float, far: float, n: int, dtype=torch.float32,
                    device=None):
    """The fixed ray-signature depths used by the sampler net (48 linspace
    points in NDC [0, 1])."""
    return torch.linspace(near, far, n, dtype=dtype, device=device)
