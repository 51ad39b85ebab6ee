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
- ``trace``: ``torch.profiler`` around a block, written as a Chrome trace;
- ``profile_categories``: device time by kernel name stem from
  ``torch.profiler``'s events (the counterpart of ``xplane_categories``,
  which reads TPU traces), summed by ``aggregate_events`` (a copy of the
  pure ``aggregate_xplane_events``);
- ``pipeline_macs``: analytic multiply-adds a frame.
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
    card's kernels too, where there is one) and writes them to
    ``logdir/trace.json`` (Chrome's trace format; Perfetto reads it). The
    profiler object is yielded."""
    from torch.profiler import profile

    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(logdir / "trace.json"))


# Kernel name stems: the port's own kernels first (the f32 forms too), then
# PyTorch's families.
KERNEL_STEMS = (
    "minmax_wg_kernel", "nerf_q_wg_kernel", "nerf_wg_kernel",
    "minmax_kernel", "nerf_kernel",
    "at::native::vectorized_elementwise_kernel",
    "at::native::unrolled_elementwise_kernel",
    "at::native::elementwise_kernel", "at::native::reduce_kernel",
    "at::native::index_elementwise_kernel", "at::native::",
    "cub::", "Memcpy", "Memset",
)


def kernel_category(name: str, stems=KERNEL_STEMS) -> str:
    """The stem of ``stems`` a kernel's name starts with (after a leading
    ``void``), ``gemm`` for the BLAS products, else the name up to its
    template arguments."""
    head = name[5:] if name.startswith("void ") else name
    for stem in stems:
        if head.startswith(stem):
            return stem
    if "gemm" in head.lower():
        return "gemm"
    return head.split("<")[0].split("(")[0]


def profile_categories(trace_fn, iters: int = 3, stems=KERNEL_STEMS):
    """Run ``trace_fn(i)`` for ``i < iters`` under ``torch.profiler`` and
    sum the time of its events by kernel name stem: the card's kernels
    where there is one (device time), else the CPU's operators (their self
    time, for a run on the CPU). Returns ``(per_cat, per_op, total_ns)`` as
    ``aggregate_events`` does."""
    from torch.profiler import profile

    with profile(activities=_activities()) as prof:
        for i in range(iters):
            trace_fn(i)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    rows = prof.key_averages()
    on_card = [(e.key, e.device_time_total * 1e3) for e in rows
               if e.device_type.name == "CUDA" and e.device_time_total > 0]
    events = on_card or [(e.key, e.self_cpu_time_total * 1e3) for e in rows
                         if e.self_cpu_time_total > 0]
    return aggregate_events(events,
                            lambda name: kernel_category(name, stems))


def aggregate_events(events, category):
    """Aggregate ``(op_name, duration_ns)`` pairs into ``(per_cat, per_op,
    total_ns)``. Control-flow PARENT ops (``while``, ``conditional``,
    ``call``) are routed to a ``"<cat> (inclusive)"`` key and excluded from
    ``total_ns`` and the leaf categories: a trace that records a loop's
    inclusive duration beside its children would count the body twice. A
    copy of the JAX package's pure ``aggregate_xplane_events``."""
    control_flow = ("while", "conditional", "call")
    per_op = collections.Counter()
    per_cat = collections.Counter()
    inclusive = collections.Counter()
    for name, duration_ns in events:
        cat = category(name)
        if cat in control_flow:
            inclusive[f"{cat} (inclusive)"] += duration_ns
            continue
        per_op[name] += duration_ns
        per_cat[cat] += duration_ns
    total = sum(per_op.values())
    per_cat.update(inclusive)  # visible, but not in the leaf total
    return per_cat, per_op, total


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
