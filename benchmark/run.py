"""The benchmark of ``pronerf_tpu_torch`` (the PyTorch/CUDA port) on one
NVIDIA H100: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's files say what to run (``harness.py``). The run sets up, warms
every shape the cell uses, measures for ``--seconds``, checks the window's
outputs against the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``: each number compared, beside its limit (also the last lines on
standard error). Without a CUDA card, or with JAX or the JAX package loaded
once the window has closed, it exits non-zero and prints no result.

Every build cache of the program sits at a fixed path inside the checkout
(``benchmark/_cache/``), so only the first run of a checkout builds.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / "_cache"
for var, sub in (("PRONERF_KERNEL_CACHE", "kernels"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(CACHE / sub)
sys.path[:0] = [str(BENCH), str(ROOT)]

import harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", workload: dict = None):
    """Run cell ``name`` once on ``device``; returns ``(outcome,
    metrics, breakdown)``. ``workload`` replaces the cell's file (tests
    drive a smaller copy of a cell on the CPU)."""
    man = harness.manifest()
    cell = workload or harness.load_json("workloads", name)
    config = harness.load_json("configs", cell["config"])
    driver = harness.load_module("traffic", cell["traffic"])
    e2e, per_layer = harness.cell_metrics(man, name)
    ctx = dict(name=name, cell=cell, config=config, seed=seed,
               seconds=seconds, trace=trace, device=device, t_start=T_START)
    outcome = driver.run(ctx)
    breakdown = None
    if not trace:
        metrics = {m["name"]: {"value": outcome.e2e[m["name"]],
                               "unit": m["unit"]} for m in e2e}
    else:
        metrics = {}
        for m in per_layer:
            value = harness.load_module("metrics", m["name"]).read(outcome)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if outcome.trace is not None:
            breakdown = {"device_ops": outcome.trace.top_ops(),
                         "idle_gaps": outcome.trace.idle_by_span()}
    return outcome, metrics, breakdown


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    cell = harness.load_json("workloads", args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    outcome, metrics, breakdown = run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace))
    bad = harness.forbidden_loaded()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": outcome.memory_peak_bytes,
              "card": outcome.card}
    if outcome.trace is not None:
        device["busy_s"] = outcome.trace.device_busy_s()
        device["window_s"] = outcome.trace.window_s
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = harness.checks_line(outcome.checks)
    for k, (v, lim) in outcome.checks.items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
