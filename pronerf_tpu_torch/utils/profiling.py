"""Analytic operation counts of the render pipeline."""

from __future__ import annotations


def _dense_macs(dims):
    return sum(a * b for a, b in dims)


def pipeline_macs(H: int, W: int, *, N_samples=8, N_point_ray_enc=48,
                  num_neighbor=4, netwidth=256, mmnetwidth=256,
                  netdepth=8, mmnetdepth=6):
    """Analytic MACs per frame, split per net."""
    rays = H * W
    pts = rays * N_samples
    W_ = netwidth
    nerf_dims = (
        [(63, W_)] + [(W_, W_)] * 4 + [(W_ + 63, W_)] + [(W_, W_)] * 2
        + [(W_, 1), (W_, W_), (W_ + 27, W_ // 2), (W_ // 2, 3)]
    )
    mm_in = 6 * N_point_ray_enc
    mw = mmnetwidth
    sampler_dims = [(mm_in, mw)] + [(mw, mw)] * (mmnetdepth - 1) + [
        (mw, 3 * N_samples + 3)
    ]
    ref_in = 6 * N_samples + 3 * num_neighbor * N_samples
    refine_dims = [(ref_in, mw)] + [(mw, mw)] * (mmnetdepth - 1) + [
        (mw, 4 * N_samples + 3)
    ]
    return {
        "nerf": pts * _dense_macs(nerf_dims),
        "sampler": rays * _dense_macs(sampler_dims),
        "refine": rays * _dense_macs(refine_dims),
    }
