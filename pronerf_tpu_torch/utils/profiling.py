"""Timing, tracing and analytic operation counts of the render pipeline.

The counterpart of ``pronerf_tpu/utils/profiling.py``:

- ``readback``, ``null_dispatch_ms``, ``device_timer``: host-clock times of
  a call and its readback (a true synchronisation), and the floor under
  them;
- ``timed_ms``: one call by CUDA events on the card (the host clock on the
  CPU);
- ``cuda_graph`` and ``amortized_timer``: on the card, ``iters`` calls of a
  ``carry -> carry`` function captured as one CUDA graph and replayed (the
  counterpart of a ``lax.scan`` inside one dispatch); on the CPU a plain
  loop;
- the port's spans and counters, at the boundaries of its layers:
  ``span(name)`` is a ``torch.profiler.record_function`` range named
  ``pn/<name>`` while ``tracing()`` is on, and one shared do-nothing
  context otherwise (so the ranges sit in the profiler's trace beside the
  kernels they launch, on its clock); ``tracing(counters=True)`` also
  turns on the device counters (``count``: int64 sums kept on the device,
  no host sync; ``read_device_counters``: one sync), which add work to the
  frame and are never launched outside it; ``COUNTERS`` counts, always,
  the rare slow events that rebuild state (``param_packs``,
  ``kernel_loads``, ``kernel_builds``, ``graph_captures``), the frames
  ``render_frame`` served by a replay of its CUDA graph or ran eagerly
  (``frame_replays``, ``frame_eager``) and the NeRF kernel's launches from
  the host on the card by form (``nerf_composite_launches``,
  ``nerf_raw_launches``: eager frames and captures; a replay launches
  nothing from the host), the DoNeRF kernel's (``donerf_launches``),
  the sampler depths' sort kernel's (``depth_sort_launches``), and the
  training chunks whose controls were drawn while the previous chunk ran
  (``fill_predrawn``) or at the call (``fill_drawn``);
- ``trace``: ``torch.profiler`` around a block, with spans on, written as a
  Chrome trace;
- ``pipeline_macs``: analytic multiply-adds a frame.

Profiler traces are reduced by their readers (the benchmark reads the
Chrome trace). The second reduction that lived here, device time by kernel
name stem through ``key_averages`` (``profile_categories``,
``aggregate_events``, ``kernel_category``, ``KERNEL_STEMS``), had no caller
but its own tests and is gone, with those tests
(``test_aggregate_events_equals_jax``, four cases, and
``test_kernel_category``); ``tests/test_torch_profiling.py`` now holds the
spans, the counters and ``trace``.
"""

from __future__ import annotations

import collections
import contextlib
import time
from pathlib import Path

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


def device_timer(fn, *args, reps: int = 5) -> float:
    """Median wall ms of ``fn(*args)`` with a readback of its result (one
    call and its synchronisation), after one warm-up call."""
    readback(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        readback(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


# ---------------------------------------------------- spans, counters --

_NO_SPAN = contextlib.nullcontext()
_spans_on = False
_counters_on = False
_device_counts: dict = {}

# Host counts, always on, each where its event already happens: the rare,
# slow events that rebuild state; the frames ``render_frame`` served by a
# graph replay (``frame_replays``) or ran eagerly (``frame_eager``), whose
# hit share is replays over both; and the NeRF kernel's launches from the
# host by form (``nerf_composite_launches``, ``nerf_raw_launches``: which
# one composited a frame, in eager frames and captures only), the DoNeRF
# kernel's, either form (``donerf_launches``), and the sampler depths' sort
# kernel's (``depth_sort_launches``: 1 an eager served frame, 0 a replay);
# and the training chunks (``train/fast_loop.py``) that took controls drawn
# while the previous chunk ran (``fill_predrawn``) or drew them at the call
# (``fill_drawn``), whose hit share is the first over both.
COUNTERS = collections.Counter()


def span(name: str):
    """A ``with`` range ``pn/<name>`` of the profiler's trace while
    ``tracing()`` is on; else the one shared do-nothing context. Off while
    ``torch.export`` or ``torch.compile`` traces, so no program records a
    profiler op."""
    if not _spans_on or torch.compiler.is_compiling():
        return _NO_SPAN
    return torch.profiler.record_function("pn/" + name)


def counting() -> bool:
    """Whether the device counters are on (``tracing(counters=True)``)."""
    return _counters_on and not torch.compiler.is_compiling()


def count(name: str, mask):
    """Add the true elements of ``mask`` to device counter ``name``, on
    the device (no host sync). Callers test ``counting()`` first, so that
    no mask is made while the counters are off."""
    add(name, mask.sum(dtype=torch.int64))


def add(name: str, n):
    """Add ``n`` (an int64 0-d tensor on the device) to device counter
    ``name``. Callers test ``counting()`` first."""
    acc = _device_counts.get(name)
    if acc is None:
        _device_counts[name] = n
    else:
        acc.add_(n)


def read_device_counters() -> dict:
    """{name: count} of the device counters since they were turned on
    (one host sync)."""
    names = list(_device_counts)
    if not names:
        return {}
    vals = torch.stack([_device_counts[n] for n in names]).tolist()
    return dict(zip(names, vals))


@contextlib.contextmanager
def tracing(counters: bool = False):
    """Spans on inside the block; with ``counters`` the device counters
    too, from zero. The state before the block is restored after it."""
    global _spans_on, _counters_on
    before = _spans_on, _counters_on
    if counters and not _counters_on:
        _device_counts.clear()
    _spans_on, _counters_on = True, counters or _counters_on
    try:
        yield
    finally:
        _spans_on, _counters_on = before


# Warm-up calls on a side stream before a capture, as PyTorch's CUDA-graph
# notes ask: lazy allocations and library handles are made outside it.
GRAPH_WARMUP = 1


def cuda_graph(fn, warmup: int = GRAPH_WARMUP, pool=None, before=None):
    """``(graph, out)``: a CUDA graph of ``fn()`` and the tensors its
    capture returned, which each ``graph.replay()`` rewrites in place.
    ``fn`` runs ``warmup`` times on a side stream first; it must make no
    host sync (a capture fails on one) and read its inputs from tensors
    whose addresses stay put. ``before()``, if given, runs before each
    warm-up and before the capture, outside the graph."""
    COUNTERS["graph_captures"] += 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            if before is not None:
                before()
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    if before is not None:
        before()
    with torch.cuda.graph(graph, pool=pool):
        out = fn()
    return graph, out


def _chain(step_fn, carry, iters):
    for _ in range(iters):
        carry = step_fn(carry)
    return carry


def amortized_timer(step_fn, init_carry, iters: int = 8, reps: int = 3,
                    null_ms: float = 0.0) -> float:
    """Per-iteration ms of ``carry -> carry`` ``step_fn``, amortized over
    ``iters`` iterations a call: ``(median call ms - null_ms) / iters``,
    each call timed by the host clock to the readback of its last carry.

    On the card the ``iters`` iterations are captured once as one CUDA
    graph (from ``init_carry``, a tensor or a tuple of tensors on the
    card) and each call is one replay; on the CPU each call runs the loop.

    REQUIREMENT (as in the JAX package): the carry must feed the work's
    inputs (e.g. ``c2w + 1e-7 * c``), not only fold its outputs, so that
    every iteration does the work."""
    leaf = init_carry[0] if isinstance(init_carry, tuple) else init_carry
    if leaf.device.type == "cuda":
        graph, out = cuda_graph(lambda: _chain(step_fn, init_carry, iters))

        def call():
            graph.replay()
            return out
    else:
        def call():
            return _chain(step_fn, init_carry, iters)

    readback(call())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        readback(call())
        times.append((time.perf_counter() - t0) * 1e3)
    return (float(np.median(times)) - null_ms) / iters


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir):
    """``with trace(logdir): ...`` records ``torch.profiler`` events (the
    card's kernels too, where there is one) with the port's spans on, and
    writes them to ``logdir/trace.json`` (Chrome's trace format; Perfetto
    reads it). The profiler object is yielded."""
    from torch.profiler import profile

    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=_activities()) as prof, tracing():
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(logdir / "trace.json"))


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
