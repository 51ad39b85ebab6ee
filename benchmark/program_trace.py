"""A ``torch.profiler`` Chrome trace reduced with the program's own spans:
the benchmark's ``bench/`` ranges and device activity, as
``harness.read_chrome_trace`` reduces them, and besides them the port's
``pn/`` ranges (``utils/profiling.span``, on under ``tracing()``) and the
span each kernel belongs to: the innermost ``pn/`` range open on the host
when the kernel was launched. A kernel's launch is the CUDA API call with
the kernel's ``correlation``; the kernels of a CUDA graph share
the correlation of its ``cudaGraphLaunch``, so a replay's kernels belong to
the span around the replay.
"""

from __future__ import annotations

import dataclasses
import json

import harness

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class ProgramTrace(harness.Trace):
    """A ``harness.Trace`` with the program's spans: ``program`` as (name
    without ``pn/``, start, duration), and ``owner``, for each of
    ``kernels``, the name of its span (None outside every ``pn/`` range)."""

    program: list = dataclasses.field(default_factory=list)
    owner: list = dataclasses.field(default_factory=list)

    def has_span(self, name: str) -> bool:
        return any(p[0] == name for p in self.program)

    def program_us(self, name: str) -> float:
        """Summed host time of the program's spans named ``name``."""
        return sum(d for n, _, d in self.program if n == name)

    def span_kernel_us(self, name: str) -> float:
        """Summed device time of the kernels launched inside span
        ``name`` (innermost)."""
        return sum(k[2] for k, o in zip(self.kernels, self.owner)
                   if o == name)

    def idle_by_span(self, n: int = 10):
        """The window's idle device time by the innermost span open at each
        gap's start, of the benchmark's (plain names) and the program's
        (``pn/`` names)."""
        both = dataclasses.replace(self, spans=self.spans + [
            ("pn/" + name, s, d) for name, s, d in self.program])
        return harness.Trace.idle_by_span(both, n)


def innermost(spans, t: float):
    """The name of the shortest of ``spans`` (name, start, duration) open
    at ``t``, or None."""
    open_ = [s for s in spans if s[1] <= t < s[1] + s[2]]
    return min(open_, key=lambda s: s[2])[0] if open_ else None


def read(path, t0_name: str, units: int) -> ProgramTrace:
    """The Chrome trace at ``path`` as a ``ProgramTrace``; the window is the
    extent of the spans ``bench/<t0_name>``, as ``harness.read_chrome_trace``
    takes it."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kernels, corr, copies, spans, program, launch = [], [], [], [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        rec = (name, float(e["ts"]), float(e.get("dur", 0.0)))
        c = (e.get("args") or {}).get("correlation")
        if cat == "kernel":
            kernels.append(rec)
            corr.append(c)
        elif cat in ("gpu_memcpy", "gpu_memset"):
            copies.append(rec)
        elif cat in LAUNCH_CATS and c is not None:
            launch[c] = rec[1]
        elif cat == "user_annotation" and name.startswith("bench/"):
            spans.append((name[6:],) + rec[1:])
        elif cat == "user_annotation" and name.startswith("pn/"):
            program.append((name[3:],) + rec[1:])
    outer = [s for s in spans if s[0] == t0_name]
    if not outer:
        raise RuntimeError(f"the trace holds no span bench/{t0_name}")
    t0 = min(s[1] for s in outer)
    t1 = max(s[1] + s[2] for s in outer)
    # a graph's kernels share one launch: one look-up a launch
    launched = set(corr)
    of_launch = {c: innermost(program, t) for c, t in launch.items()
                 if c in launched}
    owner = [of_launch.get(c) for c in corr]
    return ProgramTrace(kernels, copies, spans, t0, t1, units, program,
                        owner)
