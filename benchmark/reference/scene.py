"""The benchmark's scene and camera path, frozen.

- ``synthetic_scene``: the multi-view-consistent synthetic scene that the
  spec ``synthetic:WxHxV`` names (two textured fronto-parallel planes seen
  by a forward-facing rig, 8-bit images), the scene the JAX soak's
  checkpoints were trained on. It makes only the views asked for: the
  draws of every view come first, so a subset holds the same pixels as the
  whole rig;
- ``spiral``: the LLFF loader's 120-pose spiral around the average pose,
  at the focus depth and radii its defaults derive from poses and bounds;
- ``rays_for_pose`` / ``ndc_rays``: per-pixel rays (camera looks down -z)
  and their NDC form, in float32.
"""

from __future__ import annotations

import numpy as np
import torch


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def rays_np(H, W, K, c2w):
    """World rays ``(o, d)`` [H, W, 3] of every pixel, in numpy."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1],
                     -np.ones_like(i)], -1)
    rays_d = np.einsum("hwc,rc->hwr", dirs, c2w[:3, :3])
    return np.broadcast_to(c2w[:3, -1], rays_d.shape), rays_d


def synthetic_scene(n_views: int, H: int, W: int, seed: int = 0,
                    views=None, spread: float = 0.25):
    """``{images [len(views), H, W, 3] f32, poses [n_views, 3, 4] f32,
    K [3, 3] f32, bds [n_views, 2]}``: the spec ``synthetic:WxHxV`` with
    focal 0.875 W; ``images`` of the views in ``views`` (default: all)."""
    focal = 0.875 * W
    rng = np.random.default_rng(seed)
    poses = []
    for t in range(n_views):
        angle = rng.normal(0.0, 0.02, size=3)
        R = _rot_x(angle[0]) @ _rot_y(angle[1]) @ _rot_z(angle[2])
        trans = np.array([spread * np.cos(2 * np.pi * t / n_views),
                          spread * np.sin(2 * np.pi * t / n_views),
                          rng.normal(0.0, 0.02)])
        poses.append(np.concatenate([R, trans[:, None]], axis=1))
    poses = np.stack(poses).astype(np.float32)
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                 np.float32)

    rng = np.random.default_rng(seed)
    fg_freq = rng.uniform(0.6, 1.2, size=(3, 2))
    bg_freq = rng.uniform(0.3, 0.8, size=(3, 2))
    fg_phase = rng.uniform(0, 2 * np.pi, size=3)
    bg_phase = rng.uniform(0, 2 * np.pi, size=3)
    blob_centers = rng.uniform(-1.5, 1.5, size=(6, 2))

    def tex(pts_xy, freq, phase):
        x, y = pts_xy[..., 0], pts_xy[..., 1]
        return np.stack([0.55 + 0.35 * np.sin(
            2 * np.pi * (freq[c, 0] * x + freq[c, 1] * y) + phase[c])
            for c in range(3)], axis=-1)

    views = list(range(n_views)) if views is None else list(views)
    images = np.zeros((len(views), H, W, 3), np.float32)
    for k, t in enumerate(views):
        ro, rd = rays_np(H, W, K, poses[t])

        def hit(depth):
            s = (-depth - ro[..., 2]) / rd[..., 2]
            return ro + s[..., None] * rd

        p_fg, p_bg = hit(2.5), hit(6.0)
        d2 = np.min(np.sum(
            (p_fg[..., None, :2] - blob_centers[None, None]) ** 2, -1), -1)
        fg = (d2 < 0.35).astype(np.float32)[..., None]
        img = fg * tex(p_fg[..., :2], fg_freq, fg_phase) \
            + (1 - fg) * tex(p_bg[..., :2], bg_freq, bg_phase)
        images[k] = np.clip(img, 0.02, 1.0)
    images = (np.round(images * 255.0) / 255.0).astype(np.float32)
    bds = np.tile(np.array([1.0, 10.0], np.float32), (n_views, 1))
    return {"images": images, "poses": poses, "K": K, "bds": bds}


def _normalize(v):
    return v / np.linalg.norm(v)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def spiral(poses, bds, n_poses: int = 120, n_rots: int = 2,
           zrate: float = 0.5):
    """[n_poses, 3, 4] f64: the LLFF loader's render path (``path_zflat``
    off): around the average pose, at the focus depth 1 / (0.25 / close +
    0.75 / far) with close = 0.9 min(bds), far = 5 max(bds), radii the 90th
    percentile of the absolute camera positions."""
    center = poses[:, :3, 3].mean(0)
    up = _normalize(poses[:, :3, 1].sum(0))
    c2w = _viewmatrix(_normalize(poses[:, :3, 2].sum(0)),
                      poses[:, :3, 1].sum(0), center)
    close, inf = bds.min() * 0.9, bds.max() * 5.0
    focal = 1.0 / (0.25 / close + 0.75 / inf)
    rads = np.array(list(np.percentile(np.abs(poses[:, :3, 3]), 90, 0))
                    + [1.0])
    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_poses + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta),
                                     -np.sin(theta * zrate), 1.0]) * rads)
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        out.append(_viewmatrix(z, up, c))
    return np.stack(out)


def rays_for_pose(H: int, W: int, K, c2w):
    """World rays ``(o, d)`` of every pixel, [H*W, 3] each, row-major,
    float32 on ``c2w``'s device: direction ``R [(i - cx) / fx, -(j - cy) /
    fy, -1]``."""
    dev = c2w.device
    i = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    j = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    dirs = torch.stack([(i - float(K[0][2])) / float(K[0][0]),
                        -(j - float(K[1][2])) / float(K[1][1]),
                        -torch.ones_like(i)], dim=-1)
    d = (dirs[..., None, :] * c2w[:3, :3]).sum(-1).reshape(-1, 3)
    o = c2w[:3, 3].expand(d.shape)
    return o, d


def ndc_rays(H: int, W: int, focal: float, o, d, near: float = 1.0):
    """The standard forward-facing NDC warp: origins moved to the near
    plane, then projected, so NDC depth [0, 1) covers [near, infinity)."""
    t = -(near + o[..., 2]) / d[..., 2]
    o = o + t[..., None] * d
    ax, ay = -2.0 * focal / W, -2.0 * focal / H
    o_n = torch.stack([ax * o[..., 0] / o[..., 2], ay * o[..., 1] / o[..., 2],
                       1.0 + 2.0 * near / o[..., 2]], -1)
    d_n = torch.stack([
        ax * (d[..., 0] / d[..., 2] - o[..., 0] / o[..., 2]),
        ay * (d[..., 1] / d[..., 2] - o[..., 1] / o[..., 2]),
        -2.0 * near / o[..., 2]], -1)
    return o_n, d_n
