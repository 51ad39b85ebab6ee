"""Data parallelism over the ray axis: the counterpart of
``pronerf_tpu/parallel/data_parallel.py``.

The JAX package shards the ray batch over a 1-D ``('rays',)`` mesh and lets
XLA insert the gradient psum. Here the mesh is a ``torch.distributed``
process group (``parallel/launch.py``: NCCL on the card, gloo on the CPU):

- each rank takes an even slab of the batch (``shard_batch``; a batch that
  does not divide the world raises, as JAX's ``device_put`` refuses an
  uneven shard);
- each rank's losses and gradients are scaled by its share of the batch
  and summed by one all-reduce (``mean_all_reduce``), so the update is the
  whole batch's mean loss's, and the printed loss is the whole batch's;
- params are broadcast from rank 0 once (``replicate``), and Adam then
  runs the same on every rank;
- the step's noise is drawn over the whole batch from the shared controls'
  generator, and each rank takes its rows (JAX draws it over the sharded
  batch from a replicated key): drawing at a rank's own width would make a
  world of two train otherwise than a world of one.

With no process group every function behaves as a world of one.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from pronerf_tpu_torch.models.pronerf import RenderStatics
from pronerf_tpu_torch.parallel.launch import world
from pronerf_tpu_torch.train.stage1 import make_stage1_steps
from pronerf_tpu_torch.train.stage2 import make_stage2_step


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """A group of ranks that split each batch (or frame) over its rays:
    this process's ``rank`` in it, its ``size``, and the process group
    (``None``: a world of one without ``torch.distributed``)."""

    rank: int
    size: int
    group: object = None


def make_ray_mesh(n_devices: int | None = None) -> RayMesh:
    """The ray mesh over the first ``n_devices`` ranks of the default group
    (all of them by default). Every rank of the default group must call it
    (a subgroup is made collectively); a rank outside the mesh gets
    ``None``."""
    rank, size = world()
    n = size if n_devices is None else n_devices
    if n > size:
        raise ValueError(f"{n} ray shards asked of a world of {size}")
    if size == 1 and not dist.is_initialized():
        return RayMesh(0, 1, None)
    group = dist.group.WORLD if n == size else dist.new_group(list(range(n)))
    return RayMesh(rank, n, group) if rank < n else None


def replicate(mesh: RayMesh, params):
    """Broadcast every parameter of ``params`` (the nets' modules) from the
    mesh's first rank, in place; returns ``params``."""
    if mesh.group is not None:
        src = dist.get_global_rank(mesh.group, 0) \
            if mesh.group is not dist.group.WORLD else 0
        with torch.no_grad():
            for net in params.values():
                for p in net.parameters():
                    dist.broadcast(p.data, src=src, group=mesh.group)
    return params


def shard_rows(mesh: RayMesh, n: int) -> slice:
    """This rank's rows of a batch of ``n``; raises unless ``n`` divides
    evenly over the mesh."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} rays does not split evenly over "
                         f"{mesh.size} ray shards")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: RayMesh, batch_rays, pose_ids):
    """This rank's slab of a batch (``[N, 3, 3]`` rays, ``[N]`` view
    ids)."""
    rows = shard_rows(mesh, batch_rays.shape[0])
    return batch_rays[rows], pose_ids[rows]


def mean_all_reduce(group, size: int):
    """``(losses, grads) -> (losses, grads)``: each tensor scaled by the
    rank's share of the batch (``1 / size``, the shards being even) and
    summed over ``group`` by one all-reduce of their concatenation."""
    def reduce(losses, grads):
        tensors = [*losses, *grads]
        flat = torch.cat([t.reshape(-1) for t in tensors]) / size
        dist.all_reduce(flat, group=group)
        out, lo = [], 0
        for t in tensors:
            out.append(flat[lo:lo + t.numel()].view_as(t))
            lo += t.numel()
        return out[:len(losses)], out[len(losses):]

    return reduce


def noise_draws(kind: str, cfg):
    """The N(0, 1) draws of a step, in the order and widths in which the
    single-process step makes them from its generator: the NeRF step the
    sigma noise then the jitter at ``max_expand`` (64) columns, the stage-2
    step the jitter then the sigma noise at ``N_samples``, the sampler step
    none."""
    if kind == "nerf":
        width = RenderStatics().max_expand
        return (("raw_noise", width), ("jitter_noise", width))
    if kind == "joint":
        return (("jitter_noise", cfg.N_samples), ("raw_noise", cfg.N_samples))
    return ()


def global_noise(kind: str, cfg, controls, n_global: int, device):
    """The step's noise over the whole batch: given in ``controls`` (rows
    of the whole batch), else drawn from ``controls['rng']``."""
    out = {}
    for key, width in noise_draws(kind, cfg):
        draw = controls.get(key)
        if draw is None:
            draw = torch.randn(n_global, width, generator=controls.get("rng"),
                               device=device)
        out[key] = draw
    return out


def _shard_step(step_fn, kind, cfg, mesh: RayMesh):
    def run(state, scene, batch_rays, pose_ids, controls, lr):
        n = batch_rays.shape[0]
        rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
        ctl = dict(controls)
        for key, draw in global_noise(kind, cfg, controls, n * mesh.size,
                                      batch_rays.device).items():
            ctl[key] = draw[rows]
        return step_fn(state, scene, batch_rays, pose_ids, ctl, lr)

    return run


def _reduce(mesh: RayMesh):
    return None if mesh.group is None else mean_all_reduce(mesh.group,
                                                           mesh.size)


def shard_stage1_steps(cfg, H: int, W: int, focal: float, mesh: RayMesh):
    """The stage-1 ``(nerf_step, sampler_step)`` over a ray-sharded batch:
    each rank calls them with its slab (``shard_batch``) and the shared
    controls; the update is the whole batch's."""
    nerf, sampler = make_stage1_steps(cfg, H, W, focal, reduce=_reduce(mesh))
    return (_shard_step(nerf, "nerf", cfg, mesh),
            _shard_step(sampler, "sampler", cfg, mesh))


def shard_stage2_step(cfg, H: int, W: int, focal: float, mesh: RayMesh):
    """The stage-2 step over a ray-sharded batch."""
    step = make_stage2_step(cfg, H, W, focal, reduce=_reduce(mesh))
    return _shard_step(step, "joint", cfg, mesh)
