"""Traffic ``train_chunks``: stage-1 training of a scene in chunks of
``scan_steps`` steps a call (``train/fast_loop.py:make_scan_executor``,
the path ``train/loop.py:run_training`` takes for ``scan_steps > 1``).

The state is resumed from the configuration's checkpoint (params and both
Adam states, as ``run_training`` resumes one). Each call runs one chunk on
``N_rand``-ray batches sliced on the device from the whole ray pool; the
pool is reshuffled on the device (``device_reshuffle``) when the next
chunk would pass its end, and the host reads the chunk's mean loss once a
chunk (``run_training``'s NaN guard). The seed makes the reshuffles' keys
(the pool's first order is one), the executor's per-step draws, and which
chunk of the window the check follows.

Set-up makes the pool on the device, runs the first chunk (it captures
the step graphs) and one reshuffle, then moves to ``reshuffle_after``
chunks before the pool's end, so that every window reshuffles at the same
chunk. The window runs whole chunks for ``--seconds``, and at least up to
the chunk the check follows.

The check follows two chunks with the float32 reference: set-up's first,
from the checkpoint, and one of the ``check_within`` chunks after the
window's reshuffle (so it starts at a non-zero row of a reshuffled pool),
from the program's state as it stood before that chunk. The reference
works out each chunk's rows again from the reshuffles' keys.

Parameters (the cell's ``params``): ``reshuffle_after``, ``check_within``,
``trace_chunks`` (chunks profiled after the window with ``--trace 1``,
after one chunk of the profiler's warm-up).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import harness
from reference import msgpack
from reference import pronerf as ref
from reference import scene as rscene
from reference import train as rtrain

OPTS = {"nerf": "opt_nerf", "s": "opt_s"}


def training_views(sc):
    i_test = set(range(sc["views"])[::sc["llffhold"]])
    return [i for i in range(sc["views"]) if i not in i_test]


def ray_pool(images, poses, K):
    """All rays of the training views in view order, made on ``images``'
    device: (origin, direction, colour) [M, 3, 3] f32 and each ray's view
    index [M] int32. The same inputs give the same bits."""
    n, H, W = images.shape[:3]
    pool = torch.empty(n, H * W, 3, 3, device=images.device)
    for v in range(n):
        o, d = rscene.rays_for_pose(H, W, K, poses[v])
        pool[v, :, 0], pool[v, :, 1] = o, d
        pool[v, :, 2] = images[v].reshape(-1, 3)
    ids = torch.arange(n, dtype=torch.int32, device=images.device)
    return pool.reshape(-1, 3, 3), ids.repeat_interleave(H * W)


def pool_order(M: int, keys, device):
    """Which row of the view-ordered pool each row holds after the
    reshuffles ``keys``: ``device_reshuffle``'s permutation worked out
    again (the same draw from a generator on ``device`` seeded by each
    key), composed in order."""
    order = torch.arange(M, device=device)
    for key in keys:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(key))
        order = order[torch.randperm(M, generator=gen, device=device)]
    return order


def _clone(tree):
    return {k: v.detach().clone() for k, v in tree.items()}


def _cpu(x):
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    return x.cpu() if torch.is_tensor(x) else x


class Trainer:
    """The cell's set-up: scene, pool, the resumed state, the executor,
    its first chunk (the graphs captured) and one reshuffle."""

    def __init__(self, cell, config, device, seed):
        from pronerf_tpu_torch.config import Config
        from pronerf_tpu_torch.models.pronerf import init_pronerf_params
        from pronerf_tpu_torch.render.raygen import prepare_scene
        from pronerf_tpu_torch.train.fast_loop import make_scan_executor
        from pronerf_tpu_torch.train.loop import stage1_restore
        from pronerf_tpu_torch.train.stage1 import init_stage1_state

        self.cell, self.config, self.p = cell, config, cell["params"]
        self.dev = torch.device(device)
        self.on_card = self.dev.type == "cuda"
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
        w = config["widths"]
        params = init_pronerf_params(
            torch.Generator().manual_seed(0), netdepth=w["netdepth"],
            netwidth=w["netwidth"], mmnetdepth=w["mmnetdepth"],
            mmnetwidth=w["mmnetwidth"], N_samples=self.cfg.N_samples,
            N_point_ray_enc=self.cfg.N_point_ray_enc,
            num_neighbor=self.cfg.num_neighbor, device=self.dev)
        self.state = stage1_restore(
            harness.ROOT / config["weights"],
            init_stage1_state(params, self.cfg.weight_decay))
        self.step0 = int(self.state["global_step"])
        self.K = self.cfg.scan_steps
        self.stride = self.K * self.cfg.N_rand
        self.executor = make_scan_executor(
            self.cfg, self.H, self.W, self.focal, len(self.views), 1, self.K)
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

    def batches(self):
        return max(self.M // self.cfg.N_rand, 1)

    def sync(self):
        if self.on_card:
            torch.cuda.synchronize(self.dev)

    def reshuffle(self):
        from pronerf_tpu_torch.train.fast_loop import device_reshuffle

        key = int(self.keys_rng.integers(2**63 - 1))
        self.keys.append(key)
        with self.spans("reshuffle"):
            device_reshuffle(self.pool_d, self.ids_d, key)
        self.i_batch = 0

    def chunk(self):
        """One chunk as ``run_training`` runs it; returns its mean loss."""
        if self.i_batch + self.stride > self.M:
            self.reshuffle()
        self.start = self.i_batch
        with self.spans("executor"):
            self.state, metrics = self.executor(
                self.state, self.scene, self.pool_d, self.ids_d,
                self.i_batch, self.exec_seed)
        self.i_batch += self.stride
        with self.spans("loss_read"):
            return float(metrics["mean_loss"])

    def snapshot(self, moments=("mu", "nu")):
        """The state's step counts and copies of its tensors, on the
        device: params and each optimizer's ``moments`` by name."""
        from pronerf_tpu_torch.train.state import named_params

        snap = {"step": int(self.state["global_step"]),
                "count": {o: int(self.state[key]["count"])
                          for o, key in OPTS.items()},
                "params": _clone(named_params(self.state["params"]))}
        for m in moments:
            snap[m] = {o: _clone(self.state[key][m])
                       for o, key in OPTS.items()}
        return snap

    def followed_chunk(self, from_state):
        """One chunk, keeping what the check needs of it in ``followed``:
        the state before it (``from_state``), its losses, the params and
        first moments after it, its first row and the reshuffles before
        it. Returns its mean loss."""
        before = self.snapshot() if from_state else None
        loss = self.chunk()
        after = self.snapshot(moments=("mu",))
        after["losses"] = self.executor.buf["losses"].detach().clone()
        self.followed.append({"before": before, "after": after,
                              "start": self.start, "keys": list(self.keys)})
        return loss

    def window(self, seconds):
        """Whole chunks for ``seconds``, and at least up to the followed
        chunk: (steps, failed steps, window s, start)."""
        self.spans.record = True
        steps = failed = n = 0
        t0 = time.perf_counter()
        while True:
            loss = self.followed_chunk(from_state=True) \
                if n == self.check_at else self.chunk()
            n += 1
            steps += self.K
            failed += 0 if math.isfinite(loss) else self.K
            t1 = time.perf_counter()
            if t1 - t0 >= seconds and n > self.check_at:
                break
        self.spans.record = False
        return steps, failed, t1 - t0, t0

    def traced(self, n_chunks):
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CPU]
        if self.on_card:
            acts.append(ProfilerActivity.CUDA)
        self.spans.profiled = True
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=1, active=n_chunks, repeat=1)) as prof:
            for _ in range(n_chunks + 1):
                with self.spans("chunk"):
                    self.chunk()
                prof.step()
        self.spans.profiled = False
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            return harness.read_chrome_trace(path, "chunk",
                                             n_chunks * self.K)

    def free(self):
        """Drop the program's state; keep the followed chunks on the host."""
        self.followed = [_cpu(f) for f in self.followed]
        self.state = self.executor = self.pool_d = self.ids_d = None
        self.scene = None
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

    # ------------------------------------------------------ the check --

    def checkpoint_start(self):
        """(params, {opt: {count, mu, nu}}, step) as the checkpoint holds
        them, read by the reference's own msgpack reader."""
        dev = self.dev
        tree = msgpack.read_checkpoint(harness.ROOT / self.config["weights"])
        P = ref.weights_from_tree(tree["network_fn"], tree["mmr_network_fn"],
                                  tree["refine_net"], dev)
        opts = {}
        for name, key in (("nerf", "optimizer"), ("s", "s_optimizer")):
            a = msgpack.adam_state(tree[key])
            opts[name] = {"count": int(a["count"]),
                          "mu": rtrain.moments_from_tree(a["mu"], dev),
                          "nu": rtrain.moments_from_tree(a["nu"], dev)}
        return P, opts, self.step0

    def rows(self, followed):
        """The followed chunk's batches as the reference makes them: the
        pool's rows and view ids, and each step's index tensor."""
        order = pool_order(self.M, followed["keys"], self.dev)
        n = self.cfg.N_rand
        at = torch.cat([
            order[followed["start"] + (k % self.batches()) * n:][:n]
            for k in range(self.K)])
        pool, ids = ray_pool(self.images_d, self.poses_d, self.sc["K"])
        idx = [torch.arange(k * n, (k + 1) * n, device=self.dev)
               for k in range(self.K)]
        return pool[at], ids[at], idx

    def reference_chunk(self, followed, tf32=False, batch_share=1.0,
                        update=True):
        """A followed chunk by the float32 reference, from the checkpoint
        or from the state before the chunk: (losses, params after, {opt:
        mu after}, (params before, {opt: mu before})). ``tf32``,
        ``batch_share`` and ``update`` plant the control and the faults the
        check has to see."""
        dev = self.dev
        b = followed["before"]
        if b is None:
            P, opts, step0 = self.checkpoint_start()
        else:
            P = {k: v.to(dev).clone() for k, v in b["params"].items()}
            opts = {o: {"count": b["count"][o],
                        "mu": {k: v.to(dev).clone()
                               for k, v in b["mu"][o].items()},
                        "nu": {k: v.to(dev).clone()
                               for k, v in b["nu"][o].items()}}
                    for o in OPTS}
            step0 = b["step"]
        before = ({k: v.cpu() for k, v in P.items()},
                  {o: {k: v.cpu() for k, v in opts[o]["mu"].items()}
                   for o in opts})
        pool, ids, idx = self.rows(followed)
        scene = {"images": self.images_d, "poses": self.poses_d,
                 "K": self.sc["K"]}
        was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            losses = rtrain.stage1_steps(
                P, opts, scene, pool, ids, idx, self.exec_seed, step0,
                self.config["train"], self.H, self.W, self.focal,
                batch_share, update)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = was
        return (losses, {k: v.cpu() for k, v in P.items()},
                {o: {k: v.cpu() for k, v in opts[o]["mu"].items()}
                 for o in opts}, before)


def leaf_gaps(got, want, floor=1e-3):
    """Each leaf's gap between the norms of ``got`` and ``want`` (dicts of
    tensors), against the larger of the leaf's norm in ``want`` and the
    median leaf's; leaves under ``floor`` of the median are left out
    (their change is round-off)."""
    norms = {k: float(v.norm()) for k, v in want.items()}
    med = statistics.median(norms.values())
    return {k: abs(float(got[k].norm()) - n) / max(n, med)
            for k, n in norms.items() if n >= floor * med}


def chunk_gaps(after, reference, K):
    """A followed chunk (``after``: its losses, params, {opt: mu}) against
    the reference's: each step's relative loss gap, and each leaf's gap
    (``leaf_gaps``) of the first moments' change over the chunk (the
    chunk's gradients as the optimizers got them, both optimizers'
    leaves) and of the parameters' change."""
    losses, P, mu, (P0, mu0) = reference
    loss = [abs(a - b) / abs(b)
            for a, b in zip(after["losses"].tolist(), losses)]
    decay = rtrain.B1 ** (K // 2)
    grads = {}
    for o in OPTS:
        grads.update({(o, k): v for k, v in leaf_gaps(
            {k: after["mu"][o][k] - decay * mu0[o][k] for k in mu[o]},
            {k: mu[o][k] - decay * mu0[o][k] for k in mu[o]}).items()})
    change = leaf_gaps({k: after["params"][k] - P0[k] for k in P},
                       {k: P[k] - P0[k] for k in P})
    return loss, grads, change


def compare(after, reference, K):
    """The numbers the check holds: the largest loss gap of the first
    three steps, and the median leaf's gap of the moments' change and of
    the parameters' change over the chunk (``chunk_gaps``). The worst
    leaf's gaps are no number of the check: on sound seeds they swing up
    to the control's (a last-bit flip of a step's discrete choice, which
    later steps carry on into a few small leaves)."""
    loss, grads, change = chunk_gaps(after, reference, K)
    return {"loss_gap": max(loss[:3]),
            "grad_gap_median": statistics.median(grads.values()),
            "change_gap_median": statistics.median(change.values())}


def check(t):
    """Each number of ``compare``, the worse of the two followed chunks."""
    got = [compare(f["after"], t.reference_chunk(f), t.K)
           for f in t.followed]
    return {k: max(g[k] for g in got) for k in got[0]}


@dataclasses.dataclass
class Record:
    cell: dict
    config: dict
    spans: harness.Spans
    K: int


def run(ctx) -> harness.Outcome:
    t = Trainer(ctx["cell"], ctx["config"], ctx["device"], ctx["seed"])
    steps, failed, window_s, t_w0 = t.window(ctx["seconds"])
    e2e = {"setup_s": t_w0 - ctx["t_start"],
           "train_step_ms": window_s * 1e3 / steps}
    card = harness.gpu_state() if ctx["device"] != "cpu" else ""
    trace = t.traced(t.p["trace_chunks"]) if ctx["trace"] else None
    peak = torch.cuda.max_memory_allocated(t.dev) if t.on_card else 0
    t.free()
    got = check(t)
    checks = {k: (got[k], lim) for k, lim in ctx["cell"]["limits"].items()}
    return harness.Outcome(e2e, checks, steps, failed, peak,
                           Record(ctx["cell"], ctx["config"], t.spans, t.K),
                           trace, card)
