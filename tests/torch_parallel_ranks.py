"""What each rank computes in ``tests/test_torch_parallel.py``: a helper that
imports torch and the port only (no JAX), because the ranks are spawned
processes that import this module and nothing of the test file.

``cases(inp, outdir)`` runs every case on this process's rank of the
default group, or as a world of one where there is no group (the parent
test's reference run):

- the data-parallel stage-1 steps (NeRF then sampler) and the stage-2 step
  on the rank's slab of one batch, with the noise of the whole batch;
- ``shard_batch`` of a batch that does not split evenly;
- the sharded frame renderer;
- the multi-scene NeRF step of 2 scenes on a mesh of (world, 1) (a scene a
  rank) and of (1, world) (each scene's batch split over the ranks);
- ``run_multi_training`` of 2 scenes for 3 steps (a held-out render at
  step 2), writing its checkpoints under ``outdir``.
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

from pronerf_tpu_torch import convert
from pronerf_tpu_torch.models.pronerf import RenderStatics
from pronerf_tpu_torch.parallel import launch
from pronerf_tpu_torch.parallel.data_parallel import (
    make_ray_mesh,
    replicate,
    shard_batch,
    shard_stage1_steps,
    shard_stage2_step,
)
from pronerf_tpu_torch.parallel.multi_scene import (
    make_multi_scene_step,
    make_scene_mesh,
)
from pronerf_tpu_torch.parallel.render_parallel import (
    make_sharded_frame_renderer,
)
from pronerf_tpu_torch.render.raygen import prepare_scene
from pronerf_tpu_torch.train.multi_loop import run_multi_training
from pronerf_tpu_torch.train.stage1 import init_stage1_state
from pronerf_tpu_torch.train.stage2 import init_stage2_state
from pronerf_tpu_torch.train.state import named_params

LR = 5e-4


def _params(inp):
    return convert.params_from_numpy(inp["params"])


def _named(params):
    return {k: v.detach().clone() for k, v in named_params(params).items()}


def frame_statics():
    """The shipped serving statics (fused kernels, u8 corner gather,
    whole frame) in f32, with the windowed gather forced on: 4 ray tiles of
    8-row windows, which resolve for each rank's slab."""
    return RenderStatics.infer(compute_dtype=None, use_kernels=True,
                               gather_tiles=4, gather_window_rows=8)


def cases(inp, outdir) -> dict:
    rank, size = launch.world()
    cfg, H, W, focal = inp["cfg"], inp["H"], inp["W"], inp["focal"]
    scene = prepare_scene(inp["images"], inp["poses"], inp["K"],
                          device="cpu")
    batch, ids = torch.from_numpy(inp["batch"]), torch.from_numpy(inp["ids"])
    out = {}

    mesh = make_ray_mesh()
    b, bi = shard_batch(mesh, batch, ids)
    state = init_stage1_state(replicate(mesh, _params(inp)))
    nerf, sampler = shard_stage1_steps(cfg, H, W, focal, mesh)
    state, m_nerf = nerf(state, scene, b, bi, inp["controls1"], LR)
    out["stage1_nerf"] = {"loss": float(m_nerf["loss"]),
                          "params": _named(state["params"])}
    state, m_s = sampler(state, scene, b, bi, inp["controls_s"], LR)
    out["stage1_sampler"] = {"loss": float(m_s["loss"]),
                             "psnr": float(m_s["psnr"]),
                             "params": _named(state["params"])}
    state = init_stage2_state(replicate(mesh, _params(inp)))
    joint = shard_stage2_step(cfg, H, W, focal, mesh)
    state, m2 = joint(state, scene, b, bi, inp["controls2"], LR)
    out["stage2"] = {"loss": float(m2["loss"]),
                     "params": _named(state["params"])}
    try:
        shard_batch(mesh, batch[:-1], ids[:-1])
        out["uneven_raised"] = False
    except ValueError:
        out["uneven_raised"] = True

    served = prepare_scene(inp["src_images"], inp["src_poses"], inp["K"],
                           pack_corners="u8", device="cpu")
    render = make_sharded_frame_renderer(frame_statics(), H, W, inp["K"],
                                         mesh, device="cpu")
    frame_params = convert.params_from_numpy(inp["frame_params"])
    out["frame"] = {k: v.clone() for k, v in
                    render(frame_params, served, inp["target"]).items()}
    out["frame_statics"] = render.statics

    for name, rows in (("multi_rows", size), ("multi_shards", 1)):
        smesh = make_scene_mesh(rows, size // rows)
        block = smesh.block(2)
        step = make_multi_scene_step(cfg, H, W, focal, smesh, 1, "nerf")
        states = [init_stage1_state(_params(inp)) for _ in block]
        _, m = step(states, [scene] * len(block),
                    torch.from_numpy(inp["multi_batch"][block.start:
                                                        block.stop]),
                    torch.from_numpy(inp["multi_ids"][block.start:
                                                      block.stop]),
                    inp["controls1"], LR,
                    noise=inp["multi_noise"][block.start:block.stop])
        out[name] = {s: {"loss": float(m["loss"][j]),
                         "params": _named(states[j]["params"])}
                     for j, s in enumerate(block)}

    states, names, expdir = run_multi_training(
        inp["multi_cfg"].replace(basedir=str(outdir)),
        inp["multi_datadirs"], device="cpu")
    out["loop_names"] = names
    return out


# the CPU's BLAS splits its sums by thread: every process of the test runs
# with this many, so that a scene computes the same bits on any rank
THREADS = 2


def run(rank, world_size, init_method, inp_path, outdir):
    """A rank's body: join the gloo group, run the cases, save rank's
    results as ``outdir/rank{rank}.pt``."""
    torch.set_num_threads(THREADS)
    launch.init_group("cpu", world_size, rank, init_method)
    try:
        inp = torch.load(inp_path, weights_only=False)
        out = cases(inp, outdir)
        torch.save(out, Path(outdir) / f"rank{rank}.pt")
    finally:
        launch.close_group()


def fail(rank, world_size, init_method):
    """A rank body whose second rank fails."""
    if rank == 1:
        raise SystemExit(3)


def hang(rank, world_size, init_method):
    """A rank body that never ends (a rendezvous that never completes)."""
    time.sleep(3600)
