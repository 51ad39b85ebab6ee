"""The readings that a cell's correctness limits are set from, in one
process on the card.

A viewer cell (one set-up for all seeds):
- the program: the cell's window on each of ``--seeds`` seeds (``--seconds``
  each), its kept frames against the float32 reference: the lower
  readings;
- the control: the reference in the program's place, its MLP products in
  float8 e4m3 (the precision below the configuration's bf16), on the same
  poses for the first ``--control-seeds`` seeds: the upper readings;
- the program's own lower-precision path (``quant = int8``, the NeRF MLP in
  int8) on those seeds, as a second witness.

A training cell (a set-up a seed: the followed chunks depend on it):
- the program: its two followed chunks (set-up's first, and the window's
  after its reshuffle) against the reference's, on each seed;
- the control: the reference in the program's place with TF32 products
  (the precision below the configuration's float32 with TF32 off);
- planted faults, the reference in the program's place: on half of each
  batch, the mean taken over the rest; with its state left unchanged.

    python3 benchmark/control.py --workload <cell> --seeds 12 \
        --control-seeds 3 [--seconds 2] [--out FILE]

Prints one JSON line a reading and a summary (largest program reading,
smallest reading of each control, each number's limit) last.
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parents[1])]

import torch  # noqa: E402

import harness  # noqa: E402
from reference import pronerf as ref  # noqa: E402
from traffic import train_chunks, viewer  # noqa: E402


def readings(v, seed, seconds, quant=None, program=True):
    """RMS errors of one seed's kept frames: the program's (``program``)
    or the reference's in ``quant`` at the same poses."""
    _, _, _, kept = v.window(seed, seconds)
    poses = [c for c in kept if c is not None]
    frames = [s for s, c in zip(v.slots, kept) if c is not None]
    if not program:
        frames = [v.reference(c, quant) for c in poses]
    return viewer.rms_errors(frames, [v.reference(c) for c in poses])


def viewer_rows(cell, config, seeds, n_control, seconds, device, emit):
    v = viewer.Viewer(cell, config, device)
    for seed in seeds:
        emit("program", seed, readings(v, seed, seconds))
    for seed in seeds[:n_control]:
        emit("control_fp8", seed,
             readings(v, seed, seconds, ref.fp8, program=False))
    v.free()
    from pronerf_tpu_torch.models.pronerf import RenderStatics

    int8 = dataclasses.replace(RenderStatics.infer(**config["statics"]),
                               quant="int8")
    v8 = viewer.Viewer(cell, config, device, statics=int8)
    for seed in seeds[:n_control]:
        emit("program_int8", seed, readings(v8, seed, seconds))


def as_after(reference):
    """A reference chunk in the form of a followed chunk's ``after``."""
    losses, P, mu, _ = reference
    return {"losses": torch.tensor(losses), "params": P, "mu": mu}


def train_rows(cell, config, seeds, n_control, device, emit):
    """A set-up and the window up to the followed chunk a seed; each
    followed chunk (``first``: set-up's, from the checkpoint; ``window``:
    after the window's reshuffle) its own row."""
    for k, seed in enumerate(seeds):
        t = train_chunks.Trainer(cell, config, device, seed)
        t.window(0.0)
        t.free()
        for name, f in zip(("first", "window"), t.followed):
            want = t.reference_chunk(f)
            emit("program", seed, {"chunk": name,
                                   **train_readings(f["after"], want, t.K)})
            if k >= n_control:
                continue
            for kind, kw in (("control_tf32", {"tf32": True}),
                             ("fault_half_batch", {"batch_share": 0.5}),
                             ("fault_unchanged", {"update": False})):
                got = as_after(t.reference_chunk(f, **kw))
                emit(kind, seed, {"chunk": name,
                                  **train_readings(got, want, t.K)})


def train_readings(after, want, K):
    """The check's numbers, and beside them (readings only) the loss gap
    over the whole chunk and the worst leaf's gaps."""
    loss, grads, change = train_chunks.chunk_gaps(after, want, K)
    return {**train_chunks.compare(after, want, K),
            "loss_gap_chunk": max(loss), "grad_gap_worst": max(grads.values()),
            "change_gap_worst": max(change.values())}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="fern_trt.view_1008")
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=2**31 + 7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = harness.load_json("workloads", args.workload)
    config = harness.load_json("configs", cell["config"])
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    rows = []

    def emit(kind, seed, vals):
        rows.append({"kind": kind, "seed": seed, **vals})
        print(json.dumps(rows[-1]), flush=True)

    if cell["traffic"] == "viewer":
        viewer_rows(cell, config, seeds, args.control_seeds, args.seconds,
                    args.device, emit)
    else:
        train_rows(cell, config, seeds, args.control_seeds, args.device,
                   emit)
    kinds = sorted({r["kind"] for r in rows} - {"program"})
    summary = {"summary": {
        k: {"program_max": max(r[k] for r in rows if r["kind"] == "program"),
            **{f"{kind}_min": min(r[k] for r in rows if r["kind"] == kind)
               for kind in kinds},
            "limit": cell["limits"].get(k)}
        for k in rows[0] if k not in ("kind", "seed", "chunk")}}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows + [summary], indent=1))


if __name__ == "__main__":
    main()
