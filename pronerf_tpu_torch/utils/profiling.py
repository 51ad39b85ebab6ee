"""Timing helpers and analytic operation counts of the render pipeline.

The counterpart of ``pronerf_tpu/utils/profiling.py``'s ``readback``,
``null_dispatch_ms`` and ``pipeline_macs``; on the card, times come from
CUDA events after a synchronise, on the CPU from the host clock.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def readback(x):
    """Read one element of ``x`` (a tensor, or the first tensor of a dict
    or list of them) back to the host: a true synchronisation."""
    while not torch.is_tensor(x):
        x = next(iter(x.values())) if isinstance(x, dict) else x[0]
    return x.reshape(-1)[:1].cpu().numpy()


def timed_ms(fn, device) -> float:
    """ms of one ``fn()``: CUDA events around it on the card (after a
    synchronise, and to the end of its work), the host clock on the CPU
    (``fn`` then runs to its end)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def null_dispatch_ms(device, reps: int = 5) -> float:
    """Median ms of one trivial op on ``device`` and its readback: the
    floor under any call timed with a readback."""
    x = torch.zeros((), device=device)
    readback(x + 1.0)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        readback(x + 1.0)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


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
