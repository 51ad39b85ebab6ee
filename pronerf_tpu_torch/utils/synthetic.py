"""Synthetic LLFF-like scenes for tests and benchmarks (no dataset on disk).

Generates a forward-facing camera rig around the origin looking down -z with
smooth random images, in the same conventions the data layer produces after
recentering: c2w poses [T, 3, 4], shared intrinsics, NDC-compatible bounds.
"""

from __future__ import annotations

import numpy as np


def make_scene(
    n_views: int = 8,
    H: int = 60,
    W: int = 80,
    focal: float = 70.0,
    spread: float = 0.25,
    seed: int = 0,
):
    """Returns dict(images [T,H,W,3] f32 in [0,1], poses [T,3,4], K [3,3],
    hwf, bds [T,2])."""
    rng = np.random.default_rng(seed)
    poses = []
    for t in range(n_views):
        # Small translations in the camera plane, slight z offsets; rotation
        # is a small perturbation of identity (forward-facing rig).
        angle = rng.normal(0.0, 0.02, size=3)
        Rx = _rot_x(angle[0]) @ _rot_y(angle[1]) @ _rot_z(angle[2])
        trans = np.array(
            [
                spread * np.cos(2 * np.pi * t / n_views),
                spread * np.sin(2 * np.pi * t / n_views),
                rng.normal(0.0, 0.02),
            ]
        )
        poses.append(np.concatenate([Rx, trans[:, None]], axis=1))
    poses = np.stack(poses).astype(np.float32)

    # Smooth random images: low-frequency Fourier basis avoids the all-zero
    # pixels that the warp's validity rule treats as invalid.
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    images = np.zeros((n_views, H, W, 3), np.float32)
    for t in range(n_views):
        for c in range(3):
            img = 0.55 + 0.25 * np.sin(
                2 * np.pi * (xx / W * rng.uniform(1, 3) + rng.uniform(0, 1))
            ) * np.cos(2 * np.pi * (yy / H * rng.uniform(1, 3)))
            images[t, ..., c] = img
    images = np.clip(images, 0.05, 1.0)

    K = np.array(
        [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32
    )
    bds = np.tile(np.array([1.0, 10.0], np.float32), (n_views, 1))
    return {
        "images": images,
        "poses": poses,
        "K": K,
        "hwf": (H, W, focal),
        "bds": bds,
    }


def parse_synthetic_spec(datadir: str) -> dict:
    """Parse a synthetic datadir spec: ``synthetic`` (default tiny scene)
    or ``synthetic:WxHxV`` (e.g. ``synthetic:504x378x17`` = the fern
    operating point). Focal scales with width like the default scene."""
    if ":" not in datadir:
        return {"n_views": 8, "H": 60, "W": 80, "focal": 70.0}
    spec = datadir.split(":", 1)[1]
    w, h, v = (int(x) for x in spec.split("x"))
    return {"n_views": v, "H": h, "W": w, "focal": 0.875 * w}


def make_consistent_scene(
    n_views: int = 8,
    H: int = 60,
    W: int = 80,
    focal: float = 70.0,
    spread: float = 0.25,
    seed: int = 0,
):
    """A multi-view-CONSISTENT synthetic scene: two textured fronto-parallel
    planes (foreground blobs over a background) rendered with true parallax,
    so held-out-view metrics measure real generalization. (``make_scene``'s
    per-view random textures are fine for shape/mechanics tests but carry no
    cross-view signal.) Same return contract as :func:`make_scene`."""
    rng = np.random.default_rng(seed)
    base = make_scene(n_views, H, W, focal, spread, seed)
    poses = base["poses"]
    K = base["K"]

    # procedural textures (world-space, smooth)
    fg_freq = rng.uniform(0.6, 1.2, size=(3, 2))
    bg_freq = rng.uniform(0.3, 0.8, size=(3, 2))
    fg_phase = rng.uniform(0, 2 * np.pi, size=3)
    bg_phase = rng.uniform(0, 2 * np.pi, size=3)
    blob_centers = rng.uniform(-1.5, 1.5, size=(6, 2))

    def tex(pts_xy, freq, phase):
        x, y = pts_xy[..., 0], pts_xy[..., 1]
        return np.stack(
            [
                0.55
                + 0.35 * np.sin(2 * np.pi * (freq[c, 0] * x + freq[c, 1] * y)
                                + phase[c])
                for c in range(3)
            ],
            axis=-1,
        )

    from pronerf_tpu_torch.ops.rays import get_rays_np

    z_fg, z_bg = 2.5, 6.0
    images = np.zeros((n_views, H, W, 3), np.float32)
    for t in range(n_views):
        ro, rd = get_rays_np(H, W, K, poses[t])
        # plane z = -d in world (cameras look along -z after recentering)
        def hit(depth):
            s = (-depth - ro[..., 2]) / rd[..., 2]
            return ro + s[..., None] * rd

        p_fg = hit(z_fg)
        p_bg = hit(z_bg)
        d2 = np.min(
            np.sum(
                (p_fg[..., None, :2] - blob_centers[None, None]) ** 2, -1
            ),
            axis=-1,
        )
        fg_mask = (d2 < 0.35).astype(np.float32)[..., None]
        img = fg_mask * tex(p_fg[..., :2], fg_freq, fg_phase) + (
            1 - fg_mask
        ) * tex(p_bg[..., :2], bg_freq, bg_phase)
        images[t] = np.clip(img, 0.02, 1.0)
    # quantize to 8-bit like real LLFF sources (keeps the u8 warp exact)
    images = np.round(images * 255.0) / 255.0

    out = dict(base)
    out["images"] = images.astype(np.float32)
    return out


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
