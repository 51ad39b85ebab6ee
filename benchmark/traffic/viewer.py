"""Traffic ``viewer``: one viewer flying through a trained scene, frame after
frame (a closed loop with one client).

Each frame is the pose handed to the port's frame renderer
(``render/renderer.py:make_frame_renderer``, the function the ``infer``,
``eval`` and ``render-path`` verbs call, one pose at a time) and its
``rgb1`` read into host memory before the next pose is sent. Poses follow
the LLFF spiral of the scene's poses and bounds; the seed picks the start
on the spiral and a small offset of each frame's camera. A frame's latency
runs from the call to the end of its readback.

Parameters (the cell's ``params``): ``height``, ``width``, ``path_poses``,
``offset`` (the largest camera offset a frame, in scene units),
``warmup_frames``, ``check_frames`` (frames of the window kept for the
check, drawn from the seed by reservoir sampling), ``trace_frames`` (frames
profiled after the window with ``--trace 1``), ``reference_block`` (rays a
reference call).
"""

from __future__ import annotations

import dataclasses
import gc
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import harness
from reference import msgpack
from reference import pronerf as ref
from reference import scene as rscene


class Viewer:
    """The cell's set-up (weights, scene, renderer, every shape warmed) and
    its window. ``statics`` replaces the configuration's (the control
    serves the program's int8 path through it)."""

    def __init__(self, cell, config, device, statics=None):
        from pronerf_tpu_torch.convert import params_from_numpy
        from pronerf_tpu_torch.models.pronerf import RenderStatics
        from pronerf_tpu_torch.render.raygen import prepare_scene
        from pronerf_tpu_torch.render.renderer import make_frame_renderer

        self.cell, self.config, self.p = cell, config, cell["params"]
        self.dev = torch.device(device)
        self.on_card = self.dev.type == "cuda"
        H, W = self.H, self.W = self.p["height"], self.p["width"]
        self.tree = msgpack.read_checkpoint(harness.ROOT / config["weights"])
        sc = config["scene"]
        i_test = set(range(sc["views"])[::sc["llffhold"]])
        i_train = [i for i in range(sc["views"]) if i not in i_test]
        self.views = i_train[:config["statics"]["num_neighbor"]]
        self.sc = rscene.synthetic_scene(sc["views"], H, W, seed=sc["seed"],
                                         views=self.views)
        self.path = rscene.spiral(self.sc["poses"], self.sc["bds"],
                                  self.p["path_poses"])
        self.params = params_from_numpy(self.nets(), self.dev)
        self.scene = prepare_scene(
            self.sc["images"], self.sc["poses"][self.views], self.sc["K"],
            pack_corners="u8", device=self.dev)
        self.render = make_frame_renderer(
            statics or RenderStatics.infer(**config["statics"]), H, W,
            self.sc["K"], config["tile_rays"], device=self.dev)
        self.host = torch.empty((H, W, 3), dtype=torch.float32,
                                pin_memory=self.on_card)
        self.spans = harness.Spans()
        for i in range(self.p["warmup_frames"]):
            self.frame(self.path[i].astype(np.float32))
        self.slots = [{k: torch.empty_like(v) for k, v in self.out.items()}
                      for _ in range(self.p["check_frames"])]
        self.sync()

    def nets(self):
        return {net: self.tree[key]
                for net, key in self.config["nets"].items()}

    def sync(self):
        if self.on_card:
            torch.cuda.synchronize(self.dev)

    def frame(self, c2w):
        """One frame: ``(start, end)`` of its latency by the host clock."""
        t0 = time.perf_counter()
        with self.spans("render_frame"):
            self.out = self.render(self.params, self.scene, c2w)
        with self.spans("readback"):
            self.host.copy_(self.out["rgb1"])
        return t0, time.perf_counter()

    def window(self, seed: int, seconds: float):
        """Frames for ``seconds`` from the seed's start on the path; returns
        the latencies, the window's seconds and the kept frames' poses (the
        frames themselves are in ``slots``)."""
        seq = np.random.SeedSequence(seed)
        pose_rng, keep_rng = (np.random.default_rng(s) for s in seq.spawn(2))
        self.start = int(pose_rng.integers(len(self.path)))
        self.pose_rng = pose_rng
        kept = [None] * len(self.slots)
        lat, t_w0, i = [], None, 0
        self.spans.record = True
        while True:
            with self.spans("pose"):
                c2w = self.pose(i)
            t0, t1 = self.frame(c2w)
            t_w0 = t0 if t_w0 is None else t_w0
            lat.append(t1 - t0)
            j = i if i < len(kept) else int(keep_rng.integers(i + 1))
            if j < len(kept):  # kept for the check (no allocation)
                for k, v in self.out.items():
                    self.slots[j][k].copy_(v)
                kept[j] = c2w
            i += 1
            if t1 - t_w0 >= seconds:
                break
        self.spans.record = False
        self.next_frame = i
        return lat, t1 - t_w0, t_w0, kept

    def pose(self, i: int):
        c2w = self.path[(self.start + i) % len(self.path)].copy()
        off = self.p["offset"]
        c2w[:, 3] += self.pose_rng.uniform(-off, off, 3)
        return c2w.astype(np.float32)

    def traced(self, n_frames: int) -> harness.Trace:
        """``n_frames`` more frames under ``torch.profiler`` (after two
        frames of its warm-up), reduced to a ``harness.Trace``."""
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CPU]
        if self.on_card:
            acts.append(ProfilerActivity.CUDA)
        self.spans.profiled = True
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=2, active=n_frames, repeat=1)) as prof:
            for _ in range(n_frames + 2):
                with self.spans("frame"):
                    with self.spans("pose"):
                        c2w = self.pose(self.next_frame)
                    self.frame(c2w)
                self.next_frame += 1
                prof.step()
        self.spans.profiled = False
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            return harness.read_chrome_trace(path, "frame", n_frames)

    def free(self):
        """Drop the program's state (renderer, weights, scene)."""
        self.render = self.params = self.scene = self.out = None
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

    def reference(self, c2w, quant=None):
        """The float32 reference's frame at ``c2w``, through the source-row
        windows the served form resolves (``gather_tiles = -1``) at this
        size, which the reference works out again."""
        if getattr(self, "P", None) is None:
            self.P = ref.weights_from_tree(*self.nets().values(),
                                           device=self.dev)
            self.rsc = {
                "images": torch.as_tensor(self.sc["images"], device=self.dev),
                "poses": torch.as_tensor(self.sc["poses"][self.views],
                                         device=self.dev),
                "K": self.sc["K"]}
        windows = ref.window_rule(self.H, self.W) \
            if self.config["statics"]["gather_tiles"] == -1 else None
        return ref.render_frame(
            self.P, self.rsc, torch.as_tensor(c2w, device=self.dev), self.H,
            self.W, self.sc["K"], self.config["statics"]["num_neighbor"],
            self.p["reference_block"], quant, windows)


def rms_errors(frames, references) -> dict:
    """For each output, the largest RMS difference over the frames (NaN
    where any is)."""
    worst = {}
    for got, want in zip(frames, references):
        for k in ref.FRAME_KEYS:
            err = float((got[k].float() - want[k]).square().mean().sqrt())
            prev = worst.get(k, 0.0)
            worst[k] = err if err != err or prev != prev else max(prev, err)
    return {f"{k}_rms": v for k, v in worst.items()}


@dataclasses.dataclass
class Record:
    """What the per-layer readers read besides the trace."""

    cell: dict
    config: dict
    spans: harness.Spans


def run(ctx) -> harness.Outcome:
    v = Viewer(ctx["cell"], ctx["config"], ctx["device"])
    lat, window_s, t_w0, kept = v.window(ctx["seed"], ctx["seconds"])
    e2e = {"setup_s": t_w0 - ctx["t_start"],
           "frame_ms": window_s * 1e3 / len(lat),
           "frame_p95_ms": harness.nearest_rank(lat, 0.95) * 1e3}
    card = harness.gpu_state() if ctx["device"] != "cpu" else ""
    trace = v.traced(v.p["trace_frames"]) if ctx["trace"] else None
    peak = torch.cuda.max_memory_allocated(v.dev) if v.on_card else 0
    v.free()
    frames = [s for s, c in zip(v.slots, kept) if c is not None]
    refs = [v.reference(c) for c in kept if c is not None]
    limits = ctx["cell"]["limits"]
    checks = {k: (e, limits[k]) for k, e in rms_errors(frames, refs).items()}
    return harness.Outcome(e2e, checks, len(lat), 0, peak,
                           Record(ctx["cell"], ctx["config"], v.spans), trace,
                           card)
