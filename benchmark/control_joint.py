"""The readings that the stage-2 training cell's correctness limits are set
from (``control.py`` for the ``train_joint`` traffic), in one process on the
card, a set-up a seed:

- the program: its two followed chunks (set-up's first, and the window's
  after its reshuffle) against the float32 stage-2 reference: the lower
  readings;
- the control: the reference in the program's place with TF32 products
  (the precision below the configuration's float32 with TF32 off): the
  upper readings;
- planted faults, the reference in the program's place
  (``train_joint.FAULTS``): half of each batch, the state unchanged, the
  point offsets, the jitter or the density terms left out, the sampler
  and refine nets frozen, the chunk's rows read from the pool's row 0.

    python3 benchmark/control_joint.py --seeds 10 --control-seeds 3 \
        [--kinds control_tf32 ...] [--out FILE]

(``--kinds`` keeps only the named controls and faults.)

Prints one JSON line a reading and a summary last: over each seed's worse
chunk (the check's reading), the largest program reading, the smallest
reading of the control and of each fault, and each number's limit.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parents[1])]

import control  # noqa: E402
import harness  # noqa: E402
from traffic import train_joint  # noqa: E402


def readings(after, want, K):
    """The check's numbers, and beside them (readings only) the loss gap
    over the whole chunk and the worst leaf's gaps."""
    loss, grads, change = train_joint.chunk_gaps(after, want, K)
    return {**train_joint.compare(after, want, K),
            "loss_gap_chunk": max(loss), "grad_gap_worst": max(grads.values()),
            "change_gap_worst": max(change.values())}


def joint_rows(cell, config, seeds, n_control, device, emit, only=None):
    """A set-up and the window up to the followed chunk a seed; a row for
    each followed chunk and one for the worse of the two (the check's
    reading), for the program and, on the first ``n_control`` seeds, for
    the control and each fault."""
    kinds = [("control_tf32", {"tf32": True})] + [
        (f"fault_{f}", {"fault": f}) for f in train_joint.FAULTS]
    kinds = [k for k in kinds if only is None or k[0] in only]
    for k, seed in enumerate(seeds):
        t = train_joint.JointTrainer(cell, config, device, seed)
        t.window(0.0)
        t.free()
        got = {}
        for f in t.followed:
            want = t.reference_chunk(f)
            got.setdefault("program", []).append(
                readings(f["after"], want, t.K))
            for kind, kw in kinds if k < n_control else ():
                got.setdefault(kind, []).append(readings(
                    control.as_after(t.reference_chunk(f, **kw)), want, t.K))
        for kind, both in got.items():
            for name, g in zip(("first", "window"), both):
                emit(kind, seed, {"chunk": name, **g})
            emit(kind, seed, {"chunk": "worse", **{
                key: max(g[key] for g in both) for key in both[0]}})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="fern_refine.train_s2")
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2**31 + 11)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kinds", nargs="*", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = harness.load_json("workloads", args.workload)
    config = harness.load_json("configs", cell["config"])
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    rows = []

    def emit(kind, seed, vals):
        rows.append({"kind": kind, "seed": seed, **vals})
        print(json.dumps(rows[-1]), flush=True)

    joint_rows(cell, config, seeds, args.control_seeds, args.device, emit,
               args.kinds)
    worse = [r for r in rows if r["chunk"] == "worse"]
    kinds = sorted({r["kind"] for r in worse} - {"program"})
    summary = {"summary": {
        k: {"program_max": max(r[k] for r in worse
                               if r["kind"] == "program"),
            **{f"{kind}_min": min(r[k] for r in worse if r["kind"] == kind)
               for kind in kinds},
            "limit": cell["limits"].get(k)}
        for k in rows[0] if k not in ("kind", "seed", "chunk")}}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows + [summary], indent=1))


if __name__ == "__main__":
    main()
