"""Scene/ray-batch preparation for eval and inference.

The pipeline consumes TWO parallel ray parameterizations per pixel:
- NDC rays (near plane at 1.0) for the sampler/NeRF math, and
- the ORIGINAL world-space rays for lifting candidate depths to 3D points
  for the epipolar warp (their camera-z magnitude is 1, so the 3D depth
  1/(1-z_ndc-eps) is metric camera depth along them).
"""

from __future__ import annotations

import torch

from pronerf_tpu_torch.ops.rays import get_rays, ndc_rays
from pronerf_tpu_torch.ops.warp import (
    build_corner_stack,
    build_corner_stack_u8,
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
        source images), 'f32' / True (12-channel float corner stack,
        lossless for float scenes), or False (plain images, four fetches
        per sample). 'u8-nearest' is not ported yet.
      device: where the bundle lives; the default is the card.
    """
    device = resolve_device(device)
    poses = as_f32(poses, device)
    images = as_f32(images, device)
    if pack_corners == "u8":
        images = build_corner_stack_u8(images)
    elif pack_corners == "u8-nearest":
        raise NotImplementedError(
            "pack_corners='u8-nearest' is not ported to pronerf_tpu_torch yet"
        )
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
    K = as_f32(K, device)
    rays_o, rays_d = get_rays(H, W, K, c2w, device)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    ndc_o, ndc_d = ndc_rays(H, W, float(K[0, 0]), 1.0, rays_o, rays_d)

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
