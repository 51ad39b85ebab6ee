"""Several training steps a dispatch: the counterpart of
``pronerf_tpu/train/fast_loop.py`` (``scan_steps > 1``).

The per-step loop dispatches some 1,500 small kernels a step from the host,
and the sampler and stage-2 steps are bound by that. This executor runs K
steps as a chunk:

- the WHOLE ray pool stays on the device, and each step slices its batch
  there, at ``i_batch0 + (k % n_batches) * N_rand`` (k the step in the
  chunk): the in-chunk batch index wraps modulo the pool's capacity, as the
  JAX executor's does;
- every step's random choices (n_mult ~ U{1..max_mult}, the two direction
  coins ~ Bernoulli(0.5), the neighbour subset: a sorted draw without
  replacement) and its noise are drawn on the device ahead of the chunk, by
  a generator seeded from (seed, step) alone (``draw_device_controls``, the
  counterpart of ``fold_in(base_key, step)``): a resumed run draws what the
  uninterrupted run drew. The draws are read once a chunk where
  ``explore_buckets`` needs the widths on the host;
- on the card, the steps are CUDA graphs: one of the sampler step, one of
  the stage-2 step, one of the NeRF step per width (one width unless
  ``explore_buckets``). They read their batch, controls, learning rate and
  Adam step count from static device buffers by a device step index that
  each step advances, and write their metrics to a [K] buffer, so a chunk
  replays them back to back with no host sync inside it. The graphs hold no
  random draw: everything random was drawn before the chunk. Stage 1 runs
  (NeRF step, sampler step) pairs, so a chunk starts at an even step;
- on the CPU the same chunk body runs eagerly, step by step;
- with ``utils/profiling.tracing()`` on, a chunk is the span ``pn/chunk``,
  holding ``pn/fill`` (the chunk's draws and buffers), ``pn/capture`` (each
  capture) and one ``pn/step.<kind>`` a step (a replay on the card, the
  eager step on the CPU); ``device_reshuffle`` is ``pn/reshuffle``.

A capture that fails raises; nothing carries on eagerly on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from pronerf_tpu_torch.train.stage1 import (
    explore_widths,
    make_stage1_steps,
    step_width,
)
from pronerf_tpu_torch.train.stage2 import make_stage2_step
from pronerf_tpu_torch.train.state import stage1_lr, stage2_lr
from pronerf_tpu_torch.utils.profiling import cuda_graph, span

# Warm-up runs of each step before its capture (on a side stream, as
# PyTorch's CUDA-graph notes ask): they make the lazy allocations and the
# library handles outside the capture. The state they change is restored.
WARMUP = 2


def state_tensors(state, opts):
    """Every tensor a training step updates in place: the nets' params and
    the moments of the optimizers ``opts``."""
    out = []
    for net in state["params"].values():
        out += list(net.parameters())
    for opt in opts:
        for part in ("mu", "nu"):
            out += list(state[opt][part].values())
    return out


def capture_step_graph(run, mutables, pool=None, reset=None):
    """A CUDA graph of ``run()`` (training steps, which update tensors in
    place; ``utils/profiling.cuda_graph`` with WARMUP warm-ups): the
    tensors in ``mutables`` (params, moments) are put back afterwards, so
    that neither the warm-ups nor the capture move the state. ``reset()``
    runs before each warm-up and the capture, outside the graph (e.g. to
    zero a device step index). The caller puts back the host counters the
    steps advanced."""
    saved = [t.detach().clone() for t in mutables]
    graph, _ = cuda_graph(run, WARMUP, pool, before=reset)
    with torch.no_grad():
        for t, v in zip(mutables, saved):
            t.copy_(v)
    return graph


def _step_seed(seed: int, step: int) -> int:
    return (int(seed) * 1_000_003 + int(step)) % (2**63 - 1)


def device_reshuffle(pool, pool_ids, seed: int):
    """Permute the device-resident ray pool and its view ids together, in
    place (the captured steps read the pool at its address), by a uniform
    permutation drawn on the device from a generator seeded with ``seed``.
    Returns ``(pool, pool_ids)``."""
    with span("reshuffle"):
        gen = torch.Generator(device=pool.device)
        gen.manual_seed(int(seed))
        perm = torch.randperm(pool.shape[0], generator=gen,
                              device=pool.device)
        pool.copy_(pool.index_select(0, perm))
        pool_ids.copy_(pool_ids.index_select(0, perm))
    return pool, pool_ids


def draw_device_controls(seed: int, step: int, n_train: int,
                         num_neighbor: int, max_mult: int, n_rand: int,
                         width: int, device="cpu") -> dict:
    """The random choices of training step ``step`` (1-based), drawn on
    ``device`` from a generator seeded by (seed, step) alone: ``n_mult`` ~
    U{1..max_mult} (0-d int64), ``dir_expand`` and ``dir_jitter`` ~
    Bernoulli(0.5) (0-d bool), ``neighbor_subset``: ``num_neighbor`` of
    ``n_train - 1`` without replacement, sorted ([V] int64),
    ``target_t`` zeros, and the step's N(0, 1) noise ``raw_noise`` and
    ``jitter_noise`` ([n_rand, width] f32). The structure of the JAX
    package's ``_draw_device_controls``, with the noise drawn here where
    JAX hands its step a key."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(_step_seed(seed, step))
    n_mult = torch.randint(1, max_mult + 1, (), generator=gen, device=device)
    coins = torch.rand(2, generator=gen, device=device) < 0.5
    keys = torch.rand(n_train - 1, generator=gen, device=device)
    subset = torch.sort(
        torch.argsort(keys, stable=True)[:num_neighbor]).values
    return {
        "n_mult": n_mult,
        "dir_expand": coins[0],
        "dir_jitter": coins[1],
        "neighbor_subset": subset,
        "target_t": torch.zeros(3, dtype=torch.float32, device=device),
        "raw_noise": torch.randn(n_rand, width, generator=gen,
                                 device=device),
        "jitter_noise": torch.randn(n_rand, width, generator=gen,
                                    device=device),
    }


# The per-step controls a chunk keeps, in [K, ...] device buffers
_CONTROL_KEYS = ("n_mult", "dir_expand", "dir_jitter", "neighbor_subset",
                 "raw_noise", "jitter_noise")


class _ScanExecutor:
    """``(state, scene, pool, pool_ids, i_batch0, seed, controls=None) ->
    (state, metrics)``; see :func:`make_scan_executor`."""

    def __init__(self, cfg, H, W, focal, n_train, stage, scan_steps):
        if stage == 1 and scan_steps % 2:
            raise ValueError("the stage-1 executor runs step pairs: "
                             f"scan_steps={scan_steps} must be even")
        self.cfg, self.stage, self.K = cfg, stage, scan_steps
        self.n_train = n_train
        self.n_rand = cfg.N_rand
        self.max_mult = max(1, 64 // cfg.N_samples)
        if stage == 1:
            nerf, sampler = make_stage1_steps(cfg, H, W, focal)
            self.steps = {"nerf": nerf, "sampler": sampler}
            self.widths = explore_widths(cfg, 64)
            self.noise_width = 64
        else:
            self.steps = {"joint": make_stage2_step(cfg, H, W, focal)}
            self.widths = [None]
            self.noise_width = cfg.N_samples
        self.buf = None
        self.graphs = {}
        self.graph_key = None
        self.mempool = None

    # ------------------------------------------------------- buffers --

    def _buffers(self, device):
        K, V, n = self.K, self.cfg.num_neighbor, self.n_rand

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(*shape, dtype=dtype, device=device)

        return {
            "n_mult": zeros(K, dtype=torch.int64),
            "dir_expand": zeros(K, dtype=torch.bool),
            "dir_jitter": zeros(K, dtype=torch.bool),
            "neighbor_subset": zeros(K, V, dtype=torch.int64),
            "raw_noise": zeros(K, n, self.noise_width),
            "jitter_noise": zeros(K, n, self.noise_width),
            # the step's f32 learning rate and Adam step count
            "lr": zeros(K), "adam_count": zeros(K),
            "k": zeros(1, dtype=torch.int64),
            "start": zeros((), dtype=torch.int64),
            "losses": zeros(K), "psnrs": zeros(K),
        }

    def _kinds(self):
        """The step kind of each step of a chunk."""
        if self.stage == 1:
            return ["nerf", "sampler"] * (self.K // 2)
        return ["joint"] * self.K

    def _fill(self, state, steps, seed, controls, device):
        """Write the chunk's controls, learning rates and Adam counts into
        the buffers; returns each NeRF step's width (host ints)."""
        buf = self.buf
        if controls is None:
            controls = [draw_device_controls(
                seed, i, self.n_train, self.cfg.num_neighbor, self.max_mult,
                self.n_rand, self.noise_width, device) for i in steps]
        if len(controls) != self.K:
            raise ValueError(f"{len(controls)} controls for {self.K} steps")
        for key in _CONTROL_KEYS:
            rows = [torch.as_tensor(c[key], device=device) for c in controls]
            if key.endswith("noise"):
                rows = [r[:, : self.noise_width] for r in rows]
            buf[key].copy_(torch.stack(rows).to(buf[key].dtype))
        # learning rates in float64 on the host, as the per-step loop takes
        # them, handed over in f32; Adam counts as each optimizer goes
        lr_fn = stage1_lr if self.stage == 1 else stage2_lr
        lrs = lr_fn(np.asarray(steps, np.float64) - 1, self.cfg.lrate,
                    self.cfg.lrate_decay)
        counts, c = [], {k: state[k]["count"] for k in self._opts()}
        for kind in self._kinds():
            opt = self._opt_of(kind)
            c[opt] += 1
            counts.append(c[opt])
        host = torch.tensor(np.stack([lrs, counts]), dtype=torch.float32)
        if device.type == "cuda":
            host = host.pin_memory()
        both = host.to(device, non_blocking=True)
        buf["lr"].copy_(both[0])
        buf["adam_count"].copy_(both[1])
        if self.stage != 1 or len(self.widths) == 1:
            return [self.widths[0]] * self.K
        # one read a chunk: the widths must be known on the host
        n_mult = buf["n_mult"].tolist()
        return [step_width({"n_mult": m}, self.widths, self.cfg.N_samples)
                for m in n_mult]

    def _opts(self):
        return ("opt_nerf", "opt_s") if self.stage == 1 else ("opt",)

    def _opt_of(self, kind):
        return {"nerf": "opt_nerf", "sampler": "opt_s", "joint": "opt"}[kind]

    # ---------------------------------------------------------- steps --

    def _step(self, kind, width, state, scene):
        """One step of the chunk, reading everything from the buffers by
        the device step index, which it advances: no host sync."""
        buf = self.buf
        k = buf["k"]

        def row(key):
            return buf[key].index_select(0, k)[0]

        n_batches = max(self.pool.shape[0] // self.n_rand, 1)
        start = buf["start"] + (k[0] % n_batches) * self.n_rand
        idx = start + torch.arange(self.n_rand, device=k.device)
        batch = self.pool.index_select(0, idx)
        bids = self.ids.index_select(0, idx)
        controls = {key: row(key) for key in _CONTROL_KEYS}
        controls["target_t"] = torch.zeros(3, dtype=torch.float32,
                                           device=k.device)
        controls["adam_count"] = row("adam_count")
        controls["width"] = width
        _, m = self.steps[kind](state, scene, batch, bids, controls,
                                row("lr"))
        buf["losses"].index_copy_(0, k, m["loss"].reshape(1))
        buf["psnrs"].index_copy_(0, k, m["psnr"].reshape(1))
        k.add_(1)

    def _mutables(self, state):
        return state_tensors(state, self._opts())

    def _capture(self, kind, width, state, scene):
        """A CUDA graph of one step: warm-up runs on a side stream, then
        the capture; the state the warm-ups changed is put back."""
        host = {"global_step": state["global_step"],
                **{o: state[o]["count"] for o in self._opts()}}
        graph = capture_step_graph(
            lambda: self._step(kind, width, state, scene),
            self._mutables(state), self.mempool, self.buf["k"].zero_)
        state["global_step"] = host["global_step"]
        for o in self._opts():
            state[o]["count"] = host[o]
        return graph

    # ---------------------------------------------------------- chunk --

    def __call__(self, state, scene, pool, pool_ids, i_batch0, seed,
                 controls=None):
        with span("chunk"):
            return self._chunk(state, scene, pool, pool_ids, i_batch0, seed,
                               controls)

    def _chunk(self, state, scene, pool, pool_ids, i_batch0, seed, controls):
        device = pool.device
        if self.buf is None or self.buf["k"].device != device:
            self.buf = self._buffers(device)
            self.graphs, self.graph_key = {}, None
        self.pool, self.ids = pool, pool_ids
        g0 = int(state["global_step"])
        if self.stage == 1 and g0 % 2:
            raise ValueError(f"stage-1 chunk at odd step {g0}: pairs start "
                             "at an even step")
        steps = list(range(g0 + 1, g0 + self.K + 1))
        counts0 = {o: state[o]["count"] for o in self._opts()}
        with span("fill"):
            widths = self._fill(state, steps, seed, controls, device)
        self.buf["start"].fill_(int(i_batch0))
        kinds = self._kinds()
        plan = [(kind, widths[j] if kind == "nerf" else None)
                for j, kind in enumerate(kinds)]
        if device.type == "cuda":
            key = (tuple(t.data_ptr() for t in self._mutables(state)),
                   pool.data_ptr(), pool_ids.data_ptr(),
                   tuple(v.data_ptr() for v in scene.values()
                         if torch.is_tensor(v)))
            if key != self.graph_key:  # other tensors: capture anew
                self.graphs, self.graph_key = {}, key
                self.mempool = torch.cuda.graph_pool_handle()
            for kw in dict.fromkeys(plan):
                if kw not in self.graphs:
                    with span("capture"):
                        self.graphs[kw] = self._capture(*kw, state, scene)
            self.buf["k"].zero_()
            for kw in plan:
                with span("step." + kw[0]):
                    self.graphs[kw].replay()
        else:
            self.buf["k"].zero_()
            for kind, width in plan:
                with span("step." + kind):
                    self._step(kind, width, state, scene)
        # the host's step counts advance by the chunk (the replays do not
        # touch them; the eager steps did the same)
        state["global_step"] = g0 + self.K
        for o in self._opts():
            state[o]["count"] = counts0[o] + sum(
                self._opt_of(kind) == o for kind in kinds)
        losses, psnrs = self.buf["losses"], self.buf["psnrs"]
        return state, {
            "loss": losses[-1].clone(), "psnr": psnrs[-1].clone(),
            "mean_loss": losses.mean(), "mean_psnr": psnrs.mean(),
        }

    def chunk_controls(self):
        """The controls the last chunk ran with, per step, as the step
        functions take them (for holding a chunk against eager steps)."""
        out = []
        for j in range(self.K):
            c = {key: self.buf[key][j].clone() for key in _CONTROL_KEYS}
            c["target_t"] = torch.zeros(3, device=self.buf["k"].device)
            c["lr"] = float(self.buf["lr"][j])
            out.append(c)
        return out


def make_scan_executor(cfg, H: int, W: int, focal: float, n_train: int,
                       stage: int, scan_steps: int):
    """Build an executor running ``scan_steps`` consecutive steps a call:

      (state, scene, pool [M, 3, 3], pool_ids [M], i_batch0, seed,
       controls=None) -> (state, metrics)

    ``state`` is updated in place (params, moments, the host step counts,
    ``global_step`` by ``scan_steps``); ``metrics`` holds the last step's
    ``loss`` and ``psnr`` and the chunk's ``mean_loss`` and ``mean_psnr``
    as 0-d device tensors. Steps draw their controls with
    ``draw_device_controls(seed, i, ...)`` for their 1-based step number i,
    unless ``controls`` gives them (a list of per-step dicts, as that
    function returns; for tests). The caller reshuffles the pool between
    chunks (``device_reshuffle``, in place). A stage-1 chunk starts at an
    even ``global_step`` and ``scan_steps`` is even.

    On the card every step kind is captured once as a CUDA graph (at the
    first call, again if the state, pool or scene tensors change) and a
    chunk replays the graphs; on the CPU the steps run eagerly."""
    return _ScanExecutor(cfg, H, W, focal, n_train, stage, scan_steps)
