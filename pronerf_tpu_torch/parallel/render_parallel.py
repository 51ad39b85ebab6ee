"""Serving over several ranks: the full-frame renderer sharded over the ray
axis, the counterpart of ``pronerf_tpu/parallel/render_parallel.py``.

A frame is embarrassingly parallel over rays. Each rank of a ray mesh
(``parallel/data_parallel.py``) renders one slab of the frame's rays
through the graph ``models.pronerf_t.graph_for`` picks, with the kernels,
and one all-gather gives every rank the whole frame. The frame's H*W rays are
padded with zero rays to a multiple of the mesh's size. The windowed
gather's statics are resolved for the slab, as the JAX package resolves
them (``resolve_gather_statics(statics, H, W, H*W // size)``): the windows
depend on where a call's ray tiles begin. Neighbour selection depends only
on the scene and the pose, so every rank picks the same source views.

On one card the mesh is a world of one over NCCL and the all-gather still
runs; the frame then equals ``make_frame_renderer``'s (one tile) bit for
bit, with the same kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from pronerf_tpu_torch.models.pronerf import RenderStatics
from pronerf_tpu_torch.models.pronerf_t import graph_for
from pronerf_tpu_torch.parallel.data_parallel import RayMesh
from pronerf_tpu_torch.render.raygen import rays_for_pose
from pronerf_tpu_torch.render.renderer import (
    _FRAME_KEYS,
    params_packer,
    resolve_gather_statics,
)
from pronerf_tpu_torch.utils.tensors import as_f32, resolve_device

_WIDTHS = {"rgb1": 3, "rgb0": 3, "depth": 1, "mm_rgb": 3, "depth0": 1}


def make_sharded_frame_renderer(statics: RenderStatics, H: int, W: int, K,
                                mesh: RayMesh, device="cuda"):
    """Build a ``(params, scene, c2w) -> frame dict`` renderer whose rays
    are split over ``mesh``: this rank renders ``ceil(H*W / size)`` rays
    and every rank returns the whole frame (rgb1, rgb0, mm_rgb [H, W, 3];
    depth, depth0 [H, W]). Params are packed once per parameter set, as
    ``make_frame_renderer`` packs them. The renderer's ``statics``
    attribute holds the resolved statics. The default device is the card;
    without one the call raises."""
    device = resolve_device(device)
    K = np.asarray(K)
    size, rank = mesh.size, mesh.rank
    statics = resolve_gather_statics(statics, H, W, (H * W) // size)
    n = H * W
    per = -(-n // size)

    def gather(local):
        if mesh.group is None:
            return local
        parts = [torch.empty_like(local) for _ in range(size)]
        dist.all_gather(parts, local, group=mesh.group)
        return torch.cat(parts, dim=0)

    def frame(packed, scene, c2w):
        rays = rays_for_pose(H, W, K, c2w, device)
        if per * size > n:
            rays = {k: torch.cat([v, v.new_zeros((per * size - n,
                                                  *v.shape[1:]))])
                    for k, v in rays.items()}
        slab = {k: v[rank * per:(rank + 1) * per] for k, v in rays.items()}
        fn = graph_for(statics, scene["images"])
        out = fn(packed, slab, scene, {"target_t": c2w[:3, 3]}, statics)
        local = torch.cat([out[k].reshape(per, _WIDTHS[k])
                           for k in _FRAME_KEYS], dim=1)
        full = gather(local)[:n]
        cols = torch.split(full, [_WIDTHS[k] for k in _FRAME_KEYS], dim=1)
        return {
            "rgb1": cols[0].reshape(H, W, 3),
            "rgb0": cols[1].reshape(H, W, 3),
            "depth": cols[2].reshape(H, W),
            "mm_rgb": cols[3].reshape(H, W, 3),
            "depth0": cols[4].reshape(H, W),
        }

    pack = params_packer(statics)

    @torch.no_grad()
    def render_frame(params, scene, c2w):
        return frame(pack(params), scene, as_f32(c2w, device))

    render_frame.statics = statics
    render_frame.frame = frame
    render_frame.pack = pack
    return render_frame
