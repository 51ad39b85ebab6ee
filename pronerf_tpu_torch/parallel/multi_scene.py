"""Several scenes in one training run: the counterpart of
``pronerf_tpu/parallel/multi_scene.py``.

Each scene keeps its own params, Adam state and ray pool; one step trains
every scene. Where the JAX package stacks scenes on a leading axis of a 2-D
``('scene', 'rays')`` device mesh, the port lays them over the ranks of a
``torch.distributed`` process group (``parallel/launch.py``):

- ``make_scene_mesh``: scene rows x ray shards; each row holds a contiguous
  block of the scenes (as ``P('scene')`` places them), and the ranks of a
  row split each of its scenes' batches and all-reduce the gradients over
  the row (``parallel/data_parallel.py``). Without a process group it is a
  world of one: every scene on this process;
- per-scene states and scenes are lists (this rank's block); the ray pools
  sit on the device as ``[S, M, 3, 3]`` / ``[S, M]``
  (``place_scene_pools``), and the pooled step slices each step's batch
  ``[i_batch, i_batch + N_rand)`` there;
- a step runs its block's scenes one after the other: the JAX package's
  ``lax.map`` schedule for an unpartitioned scene axis (its ``vmap`` over 8
  scenes ran out of memory at fern's size);
- the controls are shared across scenes except the step's random draws:
  each scene draws its noise from a generator whose seed folds in the
  scene's index (``fold_seed``), as JAX folds the index into the key. A
  caller may pass each scene's noise instead (``noise``), as the
  single-scene steps take it;
- on the card, with one ray shard a row, each step kind is ONE CUDA graph
  holding the block's steps back to back (``train/fast_loop.py``'s
  capture): the batch, the controls, the learning rate and the Adam counts
  come from device buffers, and the noise is drawn into buffers before the
  replay; one replay a step, as JAX dispatches once a step. One scene's
  activations are freed before the next scene's step inside the capture,
  so the graph's memory is about one scene's step. With several ray shards
  the step runs eagerly, with its all-reduce (a graph holds no
  collective); on the CPU it runs eagerly;
- ``reshuffle_scene_pools``: an independent permutation a scene, drawn on
  the device in place (captured steps read the pools at their address).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from pronerf_tpu_torch.parallel.data_parallel import (
    RayMesh,
    mean_all_reduce,
    noise_draws,
)
from pronerf_tpu_torch.parallel.launch import world
from pronerf_tpu_torch.train.fast_loop import (
    capture_step_graph,
    state_tensors,
)
from pronerf_tpu_torch.train.stage1 import (
    explore_widths,
    make_stage1_steps,
    step_width,
)
from pronerf_tpu_torch.train.stage2 import make_stage2_step

_SEED_MOD = 2**63 - 1


def fold_seed(seed: int, index: int) -> int:
    """A generator seed for draw ``index`` (a scene) under ``seed``: the
    counterpart of ``jax.random.fold_in``."""
    return (int(seed) * 2_654_435_761 + int(index) + 1) % _SEED_MOD


@dataclasses.dataclass(frozen=True)
class SceneMesh:
    """``rows`` scene rows x ``shards`` ray shards over the first ``rows *
    shards`` ranks: this rank's ``row`` (``None`` outside the mesh) and its
    ray mesh within the row (``rays``)."""

    rows: int
    shards: int
    row: int | None
    rays: RayMesh | None

    @property
    def shape(self) -> dict:
        return {"scene": self.rows, "rays": self.shards}

    def block(self, n_scene: int) -> range:
        """This rank's scenes: a contiguous block of ``n_scene / rows``."""
        if n_scene % self.rows:
            raise ValueError(f"{n_scene} scenes do not split evenly over "
                             f"{self.rows} scene rows")
        if self.row is None:
            return range(0)
        per = n_scene // self.rows
        return range(self.row * per, (self.row + 1) * per)


def make_scene_mesh(n_scene: int, n_rays_shards: int = 1) -> SceneMesh:
    """A mesh of ``n_scene`` scene rows x ``n_rays_shards`` ray shards over
    the first ranks of the default group (a world of one without one).
    Every rank must call it: the rows' groups are made collectively."""
    rank, size = world()
    if n_scene * n_rays_shards > size:
        raise ValueError(f"a ({n_scene}, {n_rays_shards}) mesh needs "
                         f"{n_scene * n_rays_shards} ranks; the world has "
                         f"{size}")
    groups = [None] * n_scene
    if n_rays_shards > 1:
        groups = [dist.new_group([r * n_rays_shards + j
                                  for j in range(n_rays_shards)])
                  for r in range(n_scene)]
    if rank >= n_scene * n_rays_shards:
        return SceneMesh(n_scene, n_rays_shards, None, None)
    row = rank // n_rays_shards
    return SceneMesh(n_scene, n_rays_shards, row,
                     RayMesh(rank % n_rays_shards, n_rays_shards,
                             groups[row]))


def stack_scenes(scenes):
    """Per-scene tensors or arrays of one shape (or dicts of them, with the
    same keys) -> one with a leading scene axis."""
    if isinstance(scenes[0], dict):
        return {k: stack_scenes([s[k] for s in scenes]) for k in scenes[0]}
    return torch.stack(scenes) if torch.is_tensor(scenes[0]) \
        else np.stack(scenes)


def place_scene_pools(mesh: SceneMesh, pools, pool_ids, device):
    """Host ray pools of every scene (``[S, M, 3, 3]`` / ``[S, M]``) ->
    this rank's block on the device, whole: each step slices its batch
    there."""
    block = mesh.block(len(pools))
    sl = slice(block.start, block.stop)
    return (torch.as_tensor(np.asarray(pools[sl]), device=device),
            torch.as_tensor(np.asarray(pool_ids[sl]), device=device))


@torch.no_grad()
def reshuffle_scene_pools(pools, pool_ids, seed: int, first_scene: int = 0):
    """An independent uniform permutation of each scene's pool and ids,
    drawn on the device and applied in place: scene ``s`` of the block
    (global index ``first_scene + s``) from a generator seeded with
    ``fold_seed(seed, first_scene + s)``, so that a scene's permutation
    does not depend on the layout. Returns ``(pools, pool_ids)``."""
    for s in range(pools.shape[0]):
        gen = torch.Generator(device=pools.device)
        gen.manual_seed(fold_seed(seed, first_scene + s))
        perm = torch.randperm(pools.shape[1], generator=gen,
                              device=pools.device)
        pools[s].copy_(pools[s].index_select(0, perm))
        pool_ids[s].copy_(pool_ids[s].index_select(0, perm))
    return pools, pool_ids


_OPT = {"nerf": "opt_nerf", "sampler": "opt_s", "joint": "opt"}
_OPTS = {1: ("opt_nerf", "opt_s"), 2: ("opt", "opt_nerf")}


class _MultiSceneStep:
    """One step kind over this rank's block of scenes; see
    :func:`make_multi_scene_pooled_step`."""

    def __init__(self, cfg, H, W, focal, mesh: SceneMesh, stage, branch,
                 pooled):
        rays = mesh.rays or RayMesh(0, 1, None)
        reduce = None if rays.group is None else mean_all_reduce(
            rays.group, rays.size)
        if stage == 1:
            nerf, sampler = make_stage1_steps(cfg, H, W, focal, reduce=reduce)
            self.kind = "nerf" if branch == "nerf" else "sampler"
            self.fn = nerf if self.kind == "nerf" else sampler
            self.widths = explore_widths(cfg, 64)
        else:
            self.kind = "joint"
            self.fn = make_stage2_step(cfg, H, W, focal, reduce=reduce)
            self.widths = [None]
        self.cfg, self.stage, self.mesh, self.rays = cfg, stage, mesh, rays
        self.pooled = pooled
        self.noise = noise_draws(self.kind, cfg)
        self.buf, self.graphs, self.graph_key, self.mempool = None, {}, None, \
            None

    # ------------------------------------------------------------ draws --

    def scene_noise(self, controls, scene_index: int, n_global: int, device):
        """Scene ``scene_index``'s noise over its whole batch, from the
        controls' generator's seed folded with the index."""
        gen = None
        if controls.get("rng") is not None:
            gen = torch.Generator(device=device)
            gen.manual_seed(fold_seed(controls["rng"].initial_seed(),
                                      scene_index))
        return {key: torch.randn(n_global, width, generator=gen,
                                 device=device)
                for key, width in self.noise}

    def _first(self, states):
        return self.mesh.row * len(states) if self.mesh.row is not None \
            else 0

    # ------------------------------------------------------------ eager --

    def _eager(self, states, scenes, pools, pool_ids, i_batch, controls, lr,
               noise):
        n = self.cfg.N_rand if self.pooled else pools.shape[1]
        rows = slice(self.rays.rank * (n // self.rays.size),
                     (self.rays.rank + 1) * (n // self.rays.size))
        first = self._first(states)
        losses, psnrs = [], []
        for s, (state, scene) in enumerate(zip(states, scenes)):
            batch = pools[s, i_batch:i_batch + n][rows]
            ids = pool_ids[s, i_batch:i_batch + n][rows]
            draws = noise[s] if noise is not None else self.scene_noise(
                controls, first + s, n, pools.device)
            ctl = {k: v for k, v in controls.items() if k != "rng"}
            for key, _ in self.noise:
                ctl[key] = torch.as_tensor(draws[key],
                                           device=pools.device)[rows]
            _, m = self.fn(state, scene, batch, ids, ctl, lr)
            losses.append(m["loss"])
            psnrs.append(m["psnr"])
        return losses, psnrs

    # ------------------------------------------------------------ graph --

    def _buffers(self, S, n, V, pools, pool_ids):
        dev = pools.device

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(*shape, dtype=dtype, device=dev)

        buf = {
            "n_mult": zeros((), dtype=torch.int64),
            "dir_expand": zeros((), dtype=torch.bool),
            "dir_jitter": zeros((), dtype=torch.bool),
            "neighbor_subset": zeros(V, dtype=torch.int64),
            "lr": zeros(()), "adam_count": zeros(S),
            "i_batch": zeros((), dtype=torch.int64),
            "losses": zeros(S), "psnrs": zeros(S),
        }
        for key, width in self.noise:
            buf[key] = zeros(S, n, width)
        if not self.pooled:  # the batch step reads a static copy
            buf["pools"] = torch.empty_like(pools)
            buf["pool_ids"] = torch.empty_like(pool_ids)
        return buf

    def _fill(self, states, pools, pool_ids, i_batch, controls, lr, noise):
        buf, dev = self.buf, pools.device
        for key in ("n_mult", "dir_expand", "dir_jitter"):
            v = controls[key]
            if torch.is_tensor(v):
                buf[key].copy_(v)
            else:
                buf[key].fill_(v)
        buf["neighbor_subset"].copy_(torch.as_tensor(
            controls["neighbor_subset"], device=dev))
        buf["lr"].fill_(float(lr))
        buf["i_batch"].fill_(int(i_batch))
        opt = _OPT[self.kind]
        counts = torch.tensor([st[opt]["count"] + 1 for st in states],
                              dtype=torch.float32)
        buf["adam_count"].copy_(counts.pin_memory().to(dev, non_blocking=True)
                                if dev.type == "cuda" else counts)
        first = self._first(states)
        for s in range(len(states)):
            draws = noise[s] if noise is not None else self.scene_noise(
                controls, first + s, self.cfg.N_rand, dev)
            for key, _ in self.noise:
                buf[key][s].copy_(torch.as_tensor(draws[key], device=dev))
        if not self.pooled:
            buf["pools"].copy_(pools)
            buf["pool_ids"].copy_(pool_ids)

    def _graph_body(self, width, states, scenes, pools, pool_ids):
        """The block's steps, reading everything from the buffers: no host
        sync."""
        buf, n = self.buf, self.cfg.N_rand
        idx = buf["i_batch"] + torch.arange(n, device=pools.device)
        for s, (state, scene) in enumerate(zip(states, scenes)):
            batch = pools[s].index_select(0, idx)
            ids = pool_ids[s].index_select(0, idx)
            ctl = {key: buf[key] for key in ("n_mult", "dir_expand",
                                             "dir_jitter", "neighbor_subset")}
            ctl["target_t"] = torch.zeros(3, device=pools.device)
            ctl["adam_count"] = buf["adam_count"][s]
            ctl["width"] = width
            for key, _ in self.noise:
                ctl[key] = buf[key][s]
            _, m = self.fn(state, scene, batch, ids, ctl, buf["lr"])
            buf["losses"][s].copy_(m["loss"])
            buf["psnrs"][s].copy_(m["psnr"])

    def _mutables(self, states):
        return [t for st in states
                for t in state_tensors(st, _OPTS[self.stage])]

    def _graph(self, states, scenes, pools, pool_ids, i_batch, controls, lr,
               noise):
        S, n = len(states), self.cfg.N_rand
        V = len(torch.as_tensor(controls["neighbor_subset"]))
        if self.buf is None or self.buf["losses"].shape[0] != S \
                or self.buf["losses"].device != pools.device \
                or (not self.pooled and self.buf["pools"].shape
                    != pools.shape):
            self.buf = self._buffers(S, n, V, pools, pool_ids)
            self.graphs, self.graph_key = {}, None
        self._fill(states, pools, pool_ids, i_batch, controls, lr, noise)
        src = (pools, pool_ids) if self.pooled else (self.buf["pools"],
                                                     self.buf["pool_ids"])
        key = (tuple(t.data_ptr() for t in self._mutables(states)),
               src[0].data_ptr(), src[1].data_ptr(),
               tuple(v.data_ptr() for sc in scenes for v in sc.values()
                     if torch.is_tensor(v)))
        if key != self.graph_key:  # other tensors: capture anew
            self.graphs, self.graph_key = {}, key
            self.mempool = torch.cuda.graph_pool_handle()
        width = step_width(controls, self.widths, self.cfg.N_samples) \
            if self.kind == "nerf" else None
        if width not in self.graphs:
            host = [(st["global_step"], {o: st[o]["count"]
                                         for o in _OPTS[self.stage]})
                    for st in states]
            self.graphs[width] = capture_step_graph(
                lambda: self._graph_body(width, states, scenes, *src),
                self._mutables(states), self.mempool)
            for st, (g, counts) in zip(states, host):
                st["global_step"] = g
                for o, c in counts.items():
                    st[o]["count"] = c
        self.graphs[width].replay()
        opt = _OPT[self.kind]
        for st in states:  # what each eager step advances on the host
            st["global_step"] += 1
            st[opt]["count"] += 1
        return list(self.buf["losses"].clone()), \
            list(self.buf["psnrs"].clone())

    # ------------------------------------------------------------- call --

    def __call__(self, states, scenes, pools, pool_ids, i_batch, controls,
                 lr, noise=None):
        """``(states, scenes, pools, pool_ids, i_batch, controls, lr,
        noise=None) -> (states, metrics)``."""
        if len(states) == 0:  # a rank outside the mesh
            empty = torch.zeros(0, device=pools.device)
            return states, {"loss": empty, "psnr": empty}
        n = self.cfg.N_rand if self.pooled else pools.shape[1]
        if n % self.rays.size:
            raise ValueError(f"a batch of {n} rays does not split evenly "
                             f"over {self.rays.size} ray shards")
        if pools.device.type == "cuda" and self.rays.size == 1:
            losses, psnrs = self._graph(states, scenes, pools, pool_ids,
                                        i_batch, controls, lr, noise)
        else:
            losses, psnrs = self._eager(states, scenes, pools, pool_ids,
                                        i_batch, controls, lr, noise)
        return states, {"loss": torch.stack(losses),
                        "psnr": torch.stack(psnrs)}


def make_multi_scene_step(cfg, H: int, W: int, focal: float,
                          mesh: SceneMesh, stage: int = 1,
                          branch: str = "nerf"):
    """``(states, scenes, batch [S, N, 3, 3], ids [S, N], controls, lr,
    noise=None) -> (states, metrics)``: one step of this rank's scenes
    (``states`` and ``scenes`` lists of its block, the batches of its
    block's scenes, whole: a rank of a row takes its shard's rows).
    ``controls`` are the single-scene step's, shared across scenes;
    ``noise`` an optional list of each scene's draws (``raw_noise`` /
    ``jitter_noise`` over the whole batch), else drawn from
    ``controls['rng']`` folded with the scene's index. ``metrics['loss']``
    and ``['psnr']`` are ``[S]`` tensors. The states are updated in
    place."""
    step = _MultiSceneStep(cfg, H, W, focal, mesh, stage, branch, False)

    def run(states, scenes, batch, ids, controls, lr, noise=None):
        return step(states, scenes, batch, ids, 0, controls, lr, noise)

    run.scene_noise = step.scene_noise
    return run


def make_multi_scene_pooled_step(cfg, H: int, W: int, focal: float,
                                 mesh: SceneMesh, stage: int = 1,
                                 branch: str = "nerf"):
    """:func:`make_multi_scene_step` with device-resident ray pools:
    ``(states, scenes, pools [S, M, 3, 3], pool_ids [S, M], i_batch,
    controls, lr, noise=None) -> (states, metrics)``; each step slices its
    ``[S, N_rand]`` batch at ``i_batch`` on the device."""
    return _MultiSceneStep(cfg, H, W, focal, mesh, stage, branch, True)
