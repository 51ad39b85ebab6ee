"""What every cell of the benchmark shares: the manifest and the files it
names, the statistics, the host's spans, the reduction of a profiler trace
to device time, and the result line.

Nothing here knows a cell. A cell is ``workloads/<name>.json`` (its
configuration, its traffic driver and the driver's parameters, the limits
of its correctness check); a configuration is ``configs/<name>.json``; a
traffic driver is ``traffic/<driver>.py`` (``run(ctx) -> Outcome``); a
per-layer metric is ``metrics/<name>.py`` (``read(run) -> value or None``).
``BENCHMARK.json`` at the root says which metrics a cell reports.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names the run may not hold: the JAX stack and the JAX
# package (compared whole: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "pronerf_tpu")


# ------------------------------------------------------------ manifest --

def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, by path (a metric's
    name may hold a dot)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(man: dict, cell: str):
    """The end-to-end and per-layer metric entries ``cell`` reports."""
    def has(m):
        return cell in m.get("workloads", [cell])

    return ([m for m in man["end_to_end"] if has(m)],
            [m for m in man["per_layer"] if has(m)])


def gpu_state() -> str:
    """The card's SM clock, temperature and power draw as ``nvidia-smi``
    reads them (read once a window has closed, to tell a slow run's card
    from a slow program)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,"
             "power.draw,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({type(e).__name__})"
    return out.splitlines()[0] if out else "not read"


def forbidden_loaded() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


# ----------------------------------------------------------- statistics --

def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile (0 < q <= 1) by nearest rank: the smallest value
    with at least a share ``q`` of the values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


# ----------------------------------------------------------------- spans --

class Spans:
    """The host's spans around the calls into the program: the seconds of
    each, by name, while ``record`` is on; under a profiler each span is
    also a ``record_function`` range, so a trace can say what the host was
    doing in each gap of the device."""

    def __init__(self):
        self.seconds = collections.defaultdict(list)
        self.record = False
        self.profiled = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = contextlib.nullcontext()
        if self.profiled:
            import torch

            rf = torch.profiler.record_function(f"bench/{name}")
        with rf:
            t0 = time.perf_counter()
            yield
            if self.record:
                self.seconds[name].append(time.perf_counter() - t0)

    def mean_ms(self, name: str):
        v = self.seconds.get(name)
        return 1e3 * statistics.fmean(v) if v else None


# ----------------------------------------------------------------- trace --

@dataclasses.dataclass
class Trace:
    """Device activity and host spans of a traced window, times in us on
    one clock: ``kernels`` and ``copies`` (memcpy / memset) as (name,
    start, duration), ``spans`` as (name, start, duration), the window
    [t0, t1] and the frames or steps it holds (``units``)."""

    kernels: list
    copies: list
    spans: list
    t0: float
    t1: float
    units: int

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def device_busy_s(self) -> float:
        return sum(b - a for a, b in self._merged()) * 1e-6

    def _merged(self):
        """The union of device activity inside the window, as intervals."""
        iv = sorted((max(s, self.t0), min(s + d, self.t1))
                    for _, s, d in self.kernels + self.copies)
        out = []
        for a, b in iv:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def kernel_us(self, stems=None, exclude=False) -> float:
        """Summed kernel time, of the kernels whose names start with one of
        ``stems`` (all without), or of all the others with ``exclude``."""
        if stems is None:
            return sum(d for _, _, d in self.kernels)
        return sum(d for n, _, d in self.kernels
                   if _starts(n, stems) != exclude)

    def top_ops(self, n: int = 10):
        tot = collections.Counter()
        for name, _, d in self.kernels + self.copies:
            tot[_short(name)] += d * 1e-6
        return [[k, v] for k, v in tot.most_common(n)]

    def idle_by_span(self, n: int = 10):
        """The window's idle device time, by the innermost host span open
        at each gap's start (``between spans`` where none was)."""
        edges, prev = [], self.t0
        for a, b in self._merged():
            if a > prev:
                edges.append((prev, a))
            prev = b
        if self.t1 > prev:
            edges.append((prev, self.t1))
        spans = sorted(self.spans, key=lambda s: s[1])
        tot = collections.Counter()
        for a, b in edges:
            inner = [s for s in spans if s[1] <= a < s[1] + s[2]]
            name = min(inner, key=lambda s: s[2])[0] if inner \
                else "between spans"
            tot[name] += (b - a) * 1e-6
        return [[k, v] for k, v in tot.most_common(n)]


def _starts(name: str, stems) -> bool:
    """Whether a kernel's name, or its function's name without namespaces
    (``pn::nerf_wg_kernel<false>(...)`` -> ``nerf_wg_kernel``), starts with
    one of ``stems``."""
    head = name[5:] if name.startswith("void ") else name
    func = head.split("<")[0].split("(")[0].rsplit("::", 1)[-1]
    return any(head.startswith(s) or func.startswith(s) for s in stems)


def _short(name: str) -> str:
    head = name[5:] if name.startswith("void ") else name
    return head.split("(")[0][:120]


def read_chrome_trace(path, t0_name: str, units: int) -> Trace:
    """A ``torch.profiler`` Chrome trace reduced to a ``Trace``: the window
    is the extent of the spans named ``bench/<t0_name>`` (the first's start
    to the last's end); spans are the ``bench/`` ranges the host recorded."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kernels, copies, spans = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        rec = (name, float(e["ts"]), float(e.get("dur", 0.0)))
        if cat == "kernel":
            kernels.append(rec)
        elif cat in ("gpu_memcpy", "gpu_memset"):
            copies.append(rec)
        elif cat == "user_annotation" and name.startswith("bench/"):
            spans.append((name[6:],) + rec[1:])
    outer = [s for s in spans if s[0] == t0_name]
    if not outer:
        raise RuntimeError(f"the trace holds no span bench/{t0_name}")
    t0 = min(s[1] for s in outer)
    t1 = max(s[1] + s[2] for s in outer)
    return Trace(kernels, copies, spans, t0, t1, units)


# ---------------------------------------------------------------- result --

@dataclasses.dataclass
class Outcome:
    """What a traffic driver returns: ``e2e`` end-to-end values by name,
    ``checks`` the correctness numbers as name -> (value, limit), the
    window's counts, the driver's ``run`` record for the per-layer readers,
    the traced window, and the card's state as the window closed."""

    e2e: dict
    checks: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    run: object = None
    trace: Trace = None
    card: str = ""

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values())


def checks_line(checks: dict) -> dict:
    return {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
