"""Full-frame rendering over fixed-size ray tiles.

- a frame is H*W rays cut into tiles of ``tile_rays`` (the last one may be
  short: the kernels mask a ragged edge themselves; with the windowed
  gather on it is padded with zero rays to ``tile_rays``, as the JAX
  renderer pads every frame, because the windows depend on where a call's
  ray tiles begin); a Python loop over the tiles keeps peak memory flat;
- ``gather_tiles = -1`` (auto) is resolved here, by the JAX package's rule
  (``resolve_gather_statics``): the windowed gather whenever a u8-packed
  source view exceeds ``GATHER_CLIFF_BYTES``;
- everything per-pose (ray generation, neighbor selection) happens inside
  the one ``render_frame`` call, under ``torch.no_grad()``;
- on the card a frame is one CUDA graph replay, the port's counterpart of
  the JAX package's one jitted dispatch: ``render_frame`` runs the first
  call of a (parameter set, scene) pair eagerly, captures the frame body
  on the second and replays it from then on, reading the pose from a
  [3, 4] tensor of its own; every call returns fresh tensors;
- ``compute_dtype='bfloat16'`` runs the three MLPs with bf16 operands and
  f32 accumulation;
- the kernel panels are packed once, when the renderer first sees a set of
  parameters, not once a frame;
- with ``utils/profiling.tracing()`` on, a frame is the span ``pn/frame``
  (one frame's spans nest inside it), ray generation ``pn/raygen``, and
  ``render_rays`` adds a span a stage.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from pronerf_tpu_torch.models.pronerf import (
    RenderStatics,
    pack_serving_params,
)
from pronerf_tpu_torch.models.pronerf_t import graph_for
from pronerf_tpu_torch.render.raygen import rays_for_pose
from pronerf_tpu_torch.utils.profiling import (
    COUNTERS,
    counting,
    cuda_graph,
    span,
    timed_ms,
)
from pronerf_tpu_torch.utils.tensors import as_f32, resolve_device

_FRAME_KEYS = ("rgb1", "rgb0", "depth", "mm_rgb", "depth0")

# The JAX package's threshold, measured there on a TPU (its gather emitter
# stages a table of up to ~2.3 MB in fast memory): one 504x378 u8-packed
# view (2.29 MB) is under it, one 1008x756 view (9.1 MB) is not. Copied as
# it is, because it decides which samples a window marks invalid, so it is
# part of what ``gather_tiles = -1`` computes.
GATHER_CLIFF_BYTES = 2.4e6


def resolve_gather_statics(
    statics: RenderStatics, H: int, W: int, rays_per_call: int
) -> RenderStatics:
    """Resolve ``gather_tiles == -1`` (auto): enable the windowed epipolar
    gather when a packed source view exceeds ``GATHER_CLIFF_BYTES``
    (full-res serving), sized so each window sits under it with ~half the
    band left for disparity spread. No-op below the cliff or when set
    explicitly."""
    if statics.gather_tiles != -1:
        return statics
    if H * W * 12 <= GATHER_CLIFF_BYTES:
        return dataclasses.replace(statics, gather_tiles=0)
    window_rows = max(64, int(GATHER_CLIFF_BYTES // (W * 12)))
    rows_per_call = max(1, rays_per_call // W)
    n_tiles = max(1, round(rows_per_call / max(window_rows // 2, 1)))
    return dataclasses.replace(
        statics, gather_tiles=n_tiles, gather_window_rows=window_rows
    )


def params_packer(statics: RenderStatics):
    """``pack(params)``: the packed params of a parameter set for
    ``statics`` (the kernels' panels and blobs), packed once per parameter
    set, outside the frame (and so outside a traced program or a captured
    graph); each pack is counted in ``COUNTERS["param_packs"]``."""
    packed_for = {}

    def pack(params):
        if packed_for.get("source") is not params:
            packed_for["source"] = params
            packed_for["packed"] = pack_serving_params(params, statics)
            COUNTERS["param_packs"] += 1
        return packed_for["packed"]

    return pack


def make_frame_renderer(
    statics: RenderStatics,
    H: int,
    W: int,
    K,
    tile_rays: int = 8192,
    device="cuda",
):
    """Build a ``(params, scene, c2w) -> frame dict`` renderer.

    ``tile_rays=0`` (or >= H*W) selects the SERVING configuration: the whole
    frame as one tile, so each kernel is launched once a frame. The default
    device is the card; without one the call raises (pass ``device='cpu'``
    to run the plain versions).

    The tiles go through the graph ``models.pronerf_t.graph_for`` picks:
    with ``statics.transposed`` the transposed serving graph where it
    implements the statics exactly, else ``render_rays``.
    ``gather_tiles = -1`` is resolved for ``tile_rays`` rays a call
    (``resolve_gather_statics``); the renderer's ``statics`` attribute holds
    the resolved statics.

    Returns tensors on ``device``: rgb1, rgb0, mm_rgb [H, W, 3]; depth,
    depth0 [H, W], fresh on every call (a later call overwrites none of
    them). The renderer's ``frame`` attribute is the frame body
    ``(packed params, scene, c2w tensor) -> frame dict``, which the export
    traces and a CUDA graph captures; the renderer packs the params (once
    per parameter set; its ``pack`` attribute) and runs the body under
    ``torch.no_grad()``.

    On the card the renderer serves a frame by replaying one CUDA graph of
    the body, captured on the second call that sees the same packed params
    and the same scene (by identity: the first call runs eagerly, so a
    one-pose ``infer`` never captures). The graph reads the pose's
    ``[:3, :4]`` from a [3, 4] tensor the renderer owns, and its five
    outputs are cloned after each replay. The renderer keeps only its
    newest graph, with references to the params and scene it read, and
    drops it at the first call with others. The body runs eagerly on the
    CPU and while ``profiling.counting()`` is on (the device counters add
    work to the frame and keep their sums outside any graph).
    ``COUNTERS["frame_replays"]`` counts the frames served by a replay,
    ``COUNTERS["frame_eager"]`` those run eagerly. Calling ``frame``
    directly always runs eagerly: the way to see per-stage spans.
    """
    device = resolve_device(device)
    K = np.asarray(K)
    if not tile_rays or tile_rays >= H * W:
        tile_rays = H * W
    statics = resolve_gather_statics(statics, H, W, tile_rays)
    # the windows depend on where a call's ray tiles begin: a short last
    # call is padded to the nominal size, as the JAX renderer pads it
    pad_last = statics.gather_tiles > 0 and statics.gather_window_rows > 0

    def frame(packed, scene, c2w):
        """The frame itself, from packed params and a [3, 4] f32 pose on the
        device: no host read and no data-dependent shape, so that
        ``torch.export`` traces it (``render/export.py``)."""
        with span("raygen"):
            rays = rays_for_pose(H, W, K, c2w, device)
        controls = {"target_t": c2w[:3, 3]}
        fn = graph_for(statics, scene["images"])
        outs = []
        for lo in range(0, H * W, tile_rays):
            tile = {k: v[lo:lo + tile_rays] for k, v in rays.items()}
            n = tile["ndc_o"].shape[0]
            if pad_last and n < tile_rays:
                tile = {k: torch.cat([v, v.new_zeros(
                    (tile_rays - n, *v.shape[1:]))]) for k, v in tile.items()}
            out = fn(packed, tile, scene, controls, statics)
            outs.append({k: out[k][:n] for k in _FRAME_KEYS})
        flat = {
            k: outs[0][k] if len(outs) == 1
            else torch.cat([o[k] for o in outs], dim=0)
            for k in _FRAME_KEYS
        }
        return {
            "rgb1": flat["rgb1"].reshape(H, W, 3),
            "rgb0": flat["rgb0"].reshape(H, W, 3),
            "depth": flat["depth"].reshape(H, W),
            "mm_rgb": flat["mm_rgb"].reshape(H, W, 3),
            "depth0": flat["depth0"].reshape(H, W),
        }

    pack = params_packer(statics)
    # the newest (packed params, scene) seen on the card ("key"), and once
    # seen twice its graph, the graph's outputs and its pose tensor
    served = {}

    def eager(packed, scene, c2w):
        COUNTERS["frame_eager"] += 1
        return frame(packed, scene, as_f32(c2w, device))

    @torch.no_grad()
    def render_frame(params, scene, c2w):
        with span("frame"):
            packed = pack(params)
            if device.type != "cuda" or counting():
                return eager(packed, scene, c2w)
            key = (packed, *scene.values())
            # by identity: the key held keeps its objects' ids from reuse
            if list(map(id, key)) != list(map(id, served.get("key", ()))):
                served.clear()  # frees the old graph and its pool
                served["key"] = key
                return eager(packed, scene, c2w)
            if "graph" not in served:
                pose = served["pose"] = as_f32(c2w, device)[:3, :4].clone()
                served["graph"], served["out"] = cuda_graph(
                    lambda: frame(packed, scene, pose))
            else:
                served["pose"].copy_(as_f32(c2w)[:3, :4])
            served["graph"].replay()
            COUNTERS["frame_replays"] += 1
            return {k: v.clone() for k, v in served["out"].items()}

    render_frame.statics = statics
    render_frame.frame = frame
    render_frame.pack = pack
    return render_frame


def render_path(
    render_poses,
    params,
    scene,
    statics: RenderStatics,
    H: int,
    W: int,
    K,
    gt_imgs=None,
    savedir: Optional[str] = None,
    tile_rays: int = 8192,
    timing_reps: int = 0,
    render_factor: int = 0,
    device="cuda",
):
    """Render a pose list; save PNGs and report PSNR: per-pose PNG dumps
    with ``{i:03d}.png`` / ``rgb0_`` / ``depth_`` / ``gt_`` prefixes and mean
    test PSNR for both the NeRF output (rgb1) and the refine-net output
    (rgb0).

    ``timing_reps > 0`` re-renders each pose that many times and prints
    ``Render path time:`` per rep, timed by CUDA events around the frame
    after a synchronise (the first render of each pose is the warm-up; on
    the card the renderer's second call captures its graph of the frame,
    and every later one is a replay). It also measures a steady-state
    ms/frame once, as the JAX package does:
    ``amortized_timer`` over ``max(2, min(timing_reps, 6))`` frames a call
    (on the card one CUDA graph of the frame body, replayed), minus the
    null-dispatch floor, printed as ``Steady-state render ms/frame``.
    """
    from pronerf_tpu_torch.ops.metrics import to8b
    from pronerf_tpu_torch.utils.png import write_png
    from pronerf_tpu_torch.utils.profiling import (
        amortized_timer,
        null_dispatch_ms,
    )

    device = resolve_device(device)
    if render_factor != 0:
        H, W = H // render_factor, W // render_factor
        K = np.asarray(K) / render_factor
        K = np.concatenate([K[:2], [[0, 0, 1]]], 0)

    renderer = make_frame_renderer(statics, H, W, K, tile_rays, device)
    rgbs0, rgbs1, depths, psnrs, psnrs0, times_ms = [], [], [], [], [], []
    null_ms = amortized_ms = None

    for i, c2w in enumerate(np.asarray(render_poses)):
        c2w = c2w[:3, :4]
        out = renderer(params, scene, c2w)
        if timing_reps > 0 and null_ms is None:
            null_ms = null_dispatch_ms(device)
        for _ in range(timing_reps):
            ms = timed_ms(lambda: renderer(params, scene, c2w), device)
            times_ms.append(ms)
            print(f"Render path time: {ms:.3f}")
        if timing_reps > 0 and amortized_ms is None:
            # measured once: the frame's work does not depend on the pose
            iters = max(2, min(timing_reps, 6))
            packed = renderer.pack(params)
            c2w_d = as_f32(c2w, device)

            def frame_step(c):
                o = renderer.frame(packed, scene, c2w_d + 1e-7 * c)
                return c + o["rgb1"][0, 0, 0] * 1e-9

            with torch.no_grad():
                amortized_ms = amortized_timer(
                    frame_step, torch.zeros((), device=device), iters=iters,
                    null_ms=null_ms)
            print(f"Steady-state render ms/frame (scan x{iters} minus "
                  f"{null_ms:.1f} ms null dispatch): {amortized_ms:.3f}")
        rgb1 = out["rgb1"].cpu().numpy()
        rgb0 = out["rgb0"].cpu().numpy()
        depth = out["depth"].cpu().numpy()
        rgbs1.append(rgb1)
        rgbs0.append(rgb0)
        depths.append(depth)

        if gt_imgs is not None and render_factor == 0:
            gt = np.asarray(gt_imgs[i])
            psnrs.append(float(-10.0 * np.log10(np.mean((rgb1 - gt) ** 2))))
            psnrs0.append(float(-10.0 * np.log10(np.mean((rgb0 - gt) ** 2))))

        if savedir is not None:
            savedir = Path(savedir)
            savedir.mkdir(parents=True, exist_ok=True)
            write_png(savedir / f"{i:03d}.png", to8b(rgb1))
            write_png(savedir / f"rgb0_{i:03d}.png", to8b(rgb0))
            write_png(
                savedir / f"depth_{i:03d}.png",
                to8b(depth / max(depth.max(), 1e-8)),
            )
            if gt_imgs is not None:
                write_png(savedir / f"gt_{i:03d}.png",
                          to8b(np.asarray(gt_imgs[i])))

    result = {
        "rgbs0": np.stack(rgbs0) if rgbs0 else None,
        "rgbs1": np.stack(rgbs1) if rgbs1 else None,
        "depths": np.stack(depths) if depths else None,
        "psnrs": psnrs,
        "psnrs0": psnrs0,
        "times_ms": times_ms,
        "amortized_ms": amortized_ms,
        "null_ms": null_ms,
    }
    if psnrs:
        print(psnrs)
        print(f"Mean Test PSNR {float(np.mean(psnrs))}")
    if psnrs0:
        print(psnrs0)
        print(f"Mean Test PSNR {float(np.mean(psnrs0))}")
    return result


def save_video(frames, path, fps: int = 30) -> str:
    """Write a [N, H, W, 3] float stack as a video; returns the path
    written. Where imageio imports, the JAX package's calls: mp4, and a GIF
    beside it when no mp4 backend is there. Without imageio, or where its
    GIF writer cannot import Pillow, the port's own GIF writer
    (``utils.gif``, a fixed 252-colour palette). Used by the
    ``render-path`` verb and the trainer's ``i_video``."""
    from pronerf_tpu_torch.ops.metrics import to8b
    from pronerf_tpu_torch.utils.gif import write_gif

    frames8 = [to8b(f) for f in np.asarray(frames)]
    path = str(path)
    gif = path.rsplit(".", 1)[0] + ".gif"
    try:
        import imageio.v2 as imageio
    except ImportError:
        return write_gif(gif, frames8, fps)
    try:
        imageio.mimwrite(path, frames8, fps=fps, quality=8)
        return path
    except (ValueError, RuntimeError, OSError, ImportError):  # no mp4 backend
        pass
    try:
        imageio.mimwrite(gif, frames8, duration=1.0 / fps)
        return gif
    except ImportError:  # imageio's GIF writer is Pillow's
        return write_gif(gif, frames8, fps)
