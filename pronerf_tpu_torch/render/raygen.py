"""Scene/ray-batch preparation shared by training, eval and inference.

The pipeline consumes TWO parallel ray parameterizations per pixel:
- NDC rays (near plane at 1.0) for the sampler/NeRF math, and
- the ORIGINAL world-space rays for lifting candidate depths to 3D points
  for the epipolar warp (their camera-z magnitude is 1, so the 3D depth
  1/(1-z_ndc-eps) is metric camera depth along them).
"""

from __future__ import annotations

import numpy as np
import torch

from pronerf_tpu_torch.ops.rays import get_rays, get_rays_np, ndc_rays
from pronerf_tpu_torch.ops.warp import (
    build_corner_stack,
    build_corner_stack_u8,
    build_rgb_word_u8,
    fuse_projection,
)
from pronerf_tpu_torch.utils.tensors import as_f32, resolve_device


def prepare_scene(images, poses, K, pack_corners: str | bool = "u8",
                  device="cuda"):
    """Device-side scene bundle for ``models.render_rays``.

    Args:
      images: [T, H, W, 3] float32 training images.
      poses: [T, 3, 4] c2w training poses.
      K: [3, 3] shared intrinsics.
      pack_corners: epipolar-gather layout: 'u8' (default; 2x2 corners
        quantized to 8-bit and packed 4-per-int32 word, exact for 8-bit
        source images), 'u8-nearest' (whole-pixel pack, one word a point,
        nearest-neighbor sampling: the ``warp_interp = 'nearest'`` speed
        knob, not reference parity), 'f32' / True (12-channel float corner
        stack, lossless for float scenes), or False (plain images, four
        fetches per sample).
      device: where the bundle lives; the default is the card.
    """
    device = resolve_device(device)
    poses = as_f32(poses, device)
    images = as_f32(images, device)
    if pack_corners == "u8":
        images = build_corner_stack_u8(images)
    elif pack_corners == "u8-nearest":
        images = build_rgb_word_u8(images)
    elif pack_corners:
        images = build_corner_stack(images)
    return {
        "images": images,
        "fused_mats": fuse_projection(poses),
        "K": as_f32(K, device),
        "poses_t": poses[:, :3, 3],
    }


def rays_for_pose(H: int, W: int, K, c2w, device="cuda"):
    """Full-image ray bundle for one camera pose. Returns dict of [H*W, ...]."""
    device = resolve_device(device)
    # the focal length read on the host from a host K (no device read, so
    # the frame traces under torch.export)
    focal = float(K[0, 0]) if torch.is_tensor(K) \
        else float(np.asarray(K, np.float32)[0, 0])
    # a host K stays on the host: get_rays makes its entries on the device
    # by fill kernels, which a CUDA graph can capture
    rays_o, rays_d = get_rays(H, W, K, c2w, device)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    ndc_o, ndc_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)

    def flat(x):
        return x.reshape(-1, 3).to(torch.float32).contiguous()

    return {
        "ndc_o": flat(ndc_o),
        "ndc_d": flat(ndc_d),
        "viewdirs": flat(viewdirs),
        "or_o": flat(rays_o),
        "or_d": flat(rays_d),
        "pose_id": torch.zeros(H * W, dtype=torch.int32, device=device),
    }


def rays_from_pool(batch_rays, pose_ids, H: int, W: int, focal: float):
    """Ray bundle from a [N, 2, 3] (o, d) slice of the training ray pool plus
    each ray's train-view id; on the device of ``batch_rays``."""
    rays_o = batch_rays[:, 0].to(torch.float32)
    rays_d = batch_rays[:, 1].to(torch.float32)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    ndc_o, ndc_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
    return {
        "ndc_o": ndc_o,
        "ndc_d": ndc_d,
        "viewdirs": viewdirs,
        "or_o": rays_o,
        "or_d": rays_d,
        "pose_id": pose_ids.to(torch.int64),
    }


def build_ray_pool(images, poses, K, i_train, num_neighbor: int,
                   rng: np.random.Generator, native: bool = True):
    """Host-side precompute of the shuffled training ray pool: all rays of
    all training views with their target colors, shuffled once.

    Returns:
      rays: [M, 3, 3] float32 (origin, direction, rgb),
      view_ids: [M] int32 index INTO THE TRAIN SUBSET (0..len(i_train)-1),
      perm-shuffled consistently.

    The JAX package's ``build_ray_pool``, with its rule: the C++ builder of
    the host runtime (``native/``: rays by the views' threads, an mt19937_64
    Fisher-Yates shuffle seeded by the first draw from ``rng``) whenever its
    library loads, the NumPy form (``rng.permutation`` after that draw)
    otherwise. So one Generator state gives both packages the same pool, bit
    for bit, on one machine. ``native=False`` takes the NumPy form.
    """
    del num_neighbor  # the neighbors are chosen per batch, in render_rays
    seed = int(rng.integers(0, 2**63 - 1))
    if native:
        from pronerf_tpu_torch.native import build_ray_pool_native

        idx = list(i_train)
        pool = build_ray_pool_native(
            np.asarray(images)[idx], np.asarray(poses)[idx][:, :3, :4], K,
            seed=seed)
        if pool is not None:
            return pool
    H, W = images.shape[1:3]
    all_rays, all_ids = [], []
    for local_id, idx in enumerate(i_train):
        ro, rd = get_rays_np(H, W, K, poses[idx][:3, :4])
        rays = np.stack([ro, rd, images[idx]], axis=2).reshape(-1, 3, 3)
        all_rays.append(rays.astype(np.float32))
        all_ids.append(np.full((H * W,), local_id, np.int32))
    rays = np.concatenate(all_rays, 0)
    ids = np.concatenate(all_ids, 0)
    perm = rng.permutation(rays.shape[0])
    return rays[perm], ids[perm]
