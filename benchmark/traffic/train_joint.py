"""Traffic ``train_joint``: stage-2 training of a scene (the joint step of
all three nets, ``train/stage2.py:make_stage2_step``) in chunks of
``scan_steps`` steps a call, on the path ``train/loop.py:run_training``
takes for ``train-stage2`` with ``scan_steps > 1``: the state resumed by
``stage2_restore`` (params, the Adam state ``opt`` over all three nets and
the never-stepped ``opt_nerf``), the executor ``make_scan_executor(...,
stage=2, ...)``, the pool on the device reshuffled by ``device_reshuffle``.

Everything else is ``train_chunks``' (whose helpers this module imports):
batches sliced on the device from the whole ray pool, one loss read a
chunk, set-up's first chunk (the step graph captured), one reshuffle, then
``reshuffle_after`` chunks before the pool's end, so that the window
reshuffles at the same chunk every run; the window runs whole chunks for
``--seconds`` and at least up to the chunk the check follows.

Set-up ends once the card's cost a kernel launch is back at the floor it
read before set-up's first device allocation (``LaunchProbe``, ``settle``;
``setup_s`` leaves that wait out: it is the program's set-up).
On an H100 each kernel launch costs 0.2 to 0.35 us more for 1 to 50 s
after this set-up (device allocations raise it: freeing 4 GB and
allocating it again does so for about 2 s), while the clocks, compute and
memory bandwidth stay as they were; this step's ~1,500 kernels a step run
7% slower meanwhile.

The check follows two chunks with the float32 stage-2 reference
(``reference/train_s2.py``): set-up's first, from the checkpoint, and one
of the ``check_within`` chunks after the window's reshuffle, from the
program's state before it. Each number the worse chunk's: ``loss_gap``
(the first three steps' relative loss gaps), ``grad_gap_median`` and
``change_gap_median`` (the median leaf's gap between the norms of Adam's
first-moment change and of the parameters' change over the chunk, as
``train_chunks.leaf_gaps`` takes it).

With ``--trace 1`` the ``trace_chunks`` profiled chunks run under the
port's ``profiling.tracing()``, and the trace keeps the port's spans and
the span of each kernel's launch (``program_trace.py``).

Parameters (the cell's ``params``): ``reshuffle_after``, ``check_within``,
``trace_chunks``.
"""

from __future__ import annotations

import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import harness
import program_trace
from reference import msgpack
from reference import pronerf as ref
from reference import scene as rscene
from reference import train as rtrain
from reference import train_s2 as rs2
from traffic import train_chunks
from traffic.train_chunks import _clone, leaf_gaps, ray_pool, training_views

# Faults planted in the reference, in the program's place: what the check
# has to see (``control_joint.py``, the tests).
FAULTS = {
    "half_batch": {"batch_share": 0.5},
    "unchanged": {"update": False},
    "no_offsets": {"st": dict(rs2.STAGE2, offsets=False)},
    "no_jitter": {"st": dict(rs2.STAGE2, jitter=False)},
    "no_mm": {"st": dict(rs2.STAGE2, use_mm=False)},
    "frozen": {"st": dict(rs2.STAGE2, frozen=True)},
    "row_zero": {},  # the chunk's rows from the pool's row 0
}


class LaunchProbe:
    """A CUDA graph of ``n`` kernels of one 1,024-float block each:
    ``read()`` gives the device ms of one replay (the mean of ``burst``
    replays, after as many untimed ones), the card's cost a launch."""

    def __init__(self, device, n=400, burst=20):
        self.x = torch.zeros(1024, device=device)
        self.burst = burst
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._kernels(n)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._kernels(n)

    def _kernels(self, n):
        for _ in range(n):
            self.x.add_(1.0)

    def read(self):
        for _ in range(self.burst):
            self.graph.replay()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(self.burst):
            self.graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / self.burst

    def floor(self, reads=5):
        readings = []
        for _ in range(reads):
            readings.append(self.read())
            time.sleep(SETTLE_GAP_S)
        return min(readings)


# A reading counts as settled within 5% of the floor (the raised state
# reads 18% over it), ``SETTLE_RUN`` in a row; readings SETTLE_GAP_S
# apart, so that the card idles in between; set-up goes on after
# SETTLE_CAP_S whatever the readings.
SETTLE_RATIO, SETTLE_RUN, SETTLE_GAP_S, SETTLE_CAP_S = 1.05, 3, 0.1, 60.0


def settled(readings, floor):
    """Whether the last ``SETTLE_RUN`` readings are within
    ``SETTLE_RATIO`` of ``floor``."""
    last = readings[-SETTLE_RUN:]
    return len(last) == SETTLE_RUN and all(
        r <= floor * SETTLE_RATIO for r in last)


def settle(read, floor, cap_s=SETTLE_CAP_S):
    """Read ``read()`` until ``settled`` or for ``cap_s`` seconds: (the
    seconds waited, the last reading)."""
    t0 = time.perf_counter()
    readings = []
    while True:
        readings.append(read())
        waited = time.perf_counter() - t0
        if settled(readings, floor) or waited >= cap_s:
            return waited, readings[-1]
        time.sleep(SETTLE_GAP_S)


class JointTrainer(train_chunks.Trainer):
    """The cell's set-up: scene, pool, the resumed stage-2 state, the
    executor, its first chunk (the graph captured), one reshuffle and the
    launch cost settled (``Trainer``'s set-up restores and builds stage 1
    inline, so it is written out again here); the window, the rows and the
    chunks are ``Trainer``'s."""

    def __init__(self, cell, config, device, seed):
        from pronerf_tpu_torch.config import Config
        from pronerf_tpu_torch.models.pronerf import init_pronerf_params
        from pronerf_tpu_torch.render.raygen import prepare_scene
        from pronerf_tpu_torch.train.fast_loop import make_scan_executor
        from pronerf_tpu_torch.train.loop import stage2_restore
        from pronerf_tpu_torch.train.stage2 import init_stage2_state

        self.cell, self.config, self.p = cell, config, cell["params"]
        self.dev = torch.device(device)
        self.on_card = self.dev.type == "cuda"
        # the launch cost's floor, read before any other device allocation
        self.probe = LaunchProbe(self.dev) if self.on_card else None
        floor = self.probe.floor() if self.on_card else None
        self.cfg = Config(**config["train"])
        sc = config["scene"]
        self.H, self.W = sc["height"], sc["width"]
        self.views = training_views(sc)
        self.sc = rscene.synthetic_scene(sc["views"], self.H, self.W,
                                         seed=sc["seed"], views=self.views)
        self.focal = float(self.sc["K"][0, 0])
        keys_seq, exec_seq, check_seq = np.random.SeedSequence(seed).spawn(3)
        self.keys_rng = np.random.default_rng(keys_seq)
        self.exec_seed = int(np.random.default_rng(exec_seq).integers(2**62))
        self.images_d = torch.as_tensor(self.sc["images"], device=self.dev)
        self.poses_d = torch.as_tensor(self.sc["poses"][self.views],
                                       device=self.dev)
        self.pool_d, self.ids_d = ray_pool(self.images_d, self.poses_d,
                                           self.sc["K"])
        self.M = self.pool_d.shape[0]
        self.scene = prepare_scene(self.sc["images"],
                                   self.sc["poses"][self.views],
                                   self.sc["K"], device=self.dev)

        def nets(seed):
            w = config["widths"]
            return init_pronerf_params(
                torch.Generator().manual_seed(seed), netdepth=w["netdepth"],
                netwidth=w["netwidth"], mmnetdepth=w["mmnetdepth"],
                mmnetwidth=w["mmnetwidth"], N_samples=self.cfg.N_samples,
                N_point_ray_enc=self.cfg.N_point_ray_enc,
                num_neighbor=self.cfg.num_neighbor, device=self.dev)

        self.state, _ = stage2_restore(
            harness.ROOT / config["weights"],
            init_stage2_state(nets(0), self.cfg.weight_decay),
            nets(1)["nerf"])
        self.step0 = int(self.state["global_step"])
        self.K = self.cfg.scan_steps
        self.stride = self.K * self.cfg.N_rand
        self.executor = make_scan_executor(
            self.cfg, self.H, self.W, self.focal, len(self.views), 2, self.K)
        self.spans = harness.Spans()
        self.keys, self.followed = [], []
        self.reshuffle()  # the pool's first order
        self.followed_chunk(from_state=False)  # from the checkpoint
        self.reshuffle()
        self.i_batch = max(self.M // self.stride - self.p["reshuffle_after"],
                           0) * self.stride
        self.check_at = self.p["reshuffle_after"] + 1 + int(
            np.random.default_rng(check_seq).integers(
                self.p["check_within"]))
        self.sync()
        self.settle_s = 0.0
        if self.on_card:
            self.settle_s, reading = settle(self.probe.read, floor)
            print(f"set-up: launch cost {reading:.4f} ms a probe after "
                  f"{self.settle_s:.2f} s (floor {floor:.4f})",
                  file=sys.stderr)

    def snapshot(self, moments=("mu", "nu")):
        """The state's step counts and copies of its tensors, on the
        device: params and the joint optimizer's ``moments``."""
        from pronerf_tpu_torch.train.state import named_params

        opt = self.state["opt"]
        snap = {"step": int(self.state["global_step"]),
                "count": int(opt["count"]),
                "params": _clone(named_params(self.state["params"]))}
        for m in moments:
            snap[m] = _clone(opt[m])
        return snap

    def traced(self, n_chunks):
        """``n_chunks`` more chunks under ``torch.profiler`` (after one of
        its warm-up) with the port's spans on, reduced to a
        ``program_trace.ProgramTrace``."""
        from torch.profiler import ProfilerActivity, profile, schedule

        from pronerf_tpu_torch.utils import profiling

        acts = [ProfilerActivity.CPU]
        if self.on_card:
            acts.append(ProfilerActivity.CUDA)
        self.spans.profiled = True
        with profiling.tracing(), profile(activities=acts, schedule=schedule(
                wait=0, warmup=1, active=n_chunks, repeat=1)) as prof:
            for _ in range(n_chunks + 1):
                with self.spans("chunk"):
                    self.chunk()
                prof.step()
        self.spans.profiled = False
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            return program_trace.read(path, "chunk", n_chunks * self.K)

    # ------------------------------------------------------ the check --

    def checkpoint_start(self):
        """(params, {count, mu, nu} of the joint Adam, step) as the
        checkpoint holds them, read by the reference's own msgpack
        reader."""
        dev = self.dev
        tree = msgpack.read_checkpoint(harness.ROOT / self.config["weights"])
        P = ref.weights_from_tree(tree["network_fine"],
                                  tree["mmr_network_fn"], tree["refine_net"],
                                  dev)
        a = msgpack.adam_state(tree["optimizer_state_dict"])
        opt = {"count": int(a["count"]),
               "mu": rtrain.moments_from_tree(a["mu"], dev),
               "nu": rtrain.moments_from_tree(a["nu"], dev)}
        return P, opt, int(tree["global_step"])

    def reference_chunk(self, followed, tf32=False, fault=None):
        """A followed chunk by the float32 stage-2 reference, from the
        checkpoint or from the state before the chunk: (losses, params
        after, mu after, (params before, mu before)). ``tf32`` and
        ``fault`` (a key of ``FAULTS``) plant the control and the faults
        the check has to see."""
        dev = self.dev
        b = followed["before"]
        if b is None:
            P, opt, step0 = self.checkpoint_start()
        else:
            P = {k: v.to(dev).clone() for k, v in b["params"].items()}
            opt = {"count": b["count"],
                   "mu": {k: v.to(dev).clone() for k, v in b["mu"].items()},
                   "nu": {k: v.to(dev).clone() for k, v in b["nu"].items()}}
            step0 = b["step"]
        before = ({k: v.cpu() for k, v in P.items()},
                  {k: v.cpu() for k, v in opt["mu"].items()})
        if fault == "row_zero":
            followed = dict(followed, start=0)
        pool, ids, idx = self.rows(followed)
        scene = {"images": self.images_d, "poses": self.poses_d,
                 "K": self.sc["K"]}
        was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            losses = rs2.stage2_steps(
                P, opt, scene, pool, ids, idx, self.exec_seed, step0,
                self.config["train"], self.H, self.W, self.focal,
                **FAULTS.get(fault, {}))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = was
        return (losses, {k: v.cpu() for k, v in P.items()},
                {k: v.cpu() for k, v in opt["mu"].items()}, before)


def chunk_gaps(after, reference, K):
    """A followed chunk (``after``: its losses, params, mu) against the
    reference's: each step's relative loss gap, and each leaf's gap
    (``leaf_gaps``) of the first moments' change over the chunk (the
    chunk's gradients as Adam got them) and of the parameters' change."""
    losses, P, mu, (P0, mu0) = reference
    loss = [abs(a - b) / abs(b)
            for a, b in zip(after["losses"].tolist(), losses)]
    decay = rtrain.B1 ** K
    grads = leaf_gaps({k: after["mu"][k] - decay * mu0[k] for k in mu},
                      {k: mu[k] - decay * mu0[k] for k in mu})
    change = leaf_gaps({k: after["params"][k] - P0[k] for k in P},
                       {k: P[k] - P0[k] for k in P})
    return loss, grads, change


def compare(after, reference, K):
    """The numbers the check holds: the largest loss gap of the first
    three steps, and the median leaf's gap of the moments' change and of
    the parameters' change over the chunk (``chunk_gaps``)."""
    loss, grads, change = chunk_gaps(after, reference, K)
    return {"loss_gap": max(loss[:3]),
            "grad_gap_median": statistics.median(grads.values()),
            "change_gap_median": statistics.median(change.values())}


def check(t):
    """Each number of ``compare``, the worse of the two followed chunks."""
    got = [compare(f["after"], t.reference_chunk(f), t.K)
           for f in t.followed]
    return {k: max(g[k] for g in got) for k in got[0]}


def run(ctx) -> harness.Outcome:
    t = JointTrainer(ctx["cell"], ctx["config"], ctx["device"], ctx["seed"])
    shuffled = len(t.keys)
    steps, failed, window_s, t_w0 = t.window(ctx["seconds"])
    print(f"window: {steps // t.K} chunks, {len(t.keys) - shuffled} "
          "reshuffle(s)", file=sys.stderr)
    # the program's set-up: the wait for the card's launch cost is the
    # benchmark's, not the program's
    e2e = {"setup_s": t_w0 - ctx["t_start"] - t.settle_s,
           "train_step_ms": window_s * 1e3 / steps}
    card = harness.gpu_state() if ctx["device"] != "cpu" else ""
    trace = t.traced(t.p["trace_chunks"]) if ctx["trace"] else None
    peak = torch.cuda.max_memory_allocated(t.dev) if t.on_card else 0
    t.free()
    got = check(t)
    checks = {k: (got[k], lim) for k, lim in ctx["cell"]["limits"].items()}
    return harness.Outcome(e2e, checks, steps, failed, peak,
                           train_chunks.Record(ctx["cell"], ctx["config"],
                                               t.spans, t.K),
                           trace, card)
