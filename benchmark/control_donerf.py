"""The readings that the DoNeRF viewer cell's correctness limits are set
from, in one process on the card (``control.py``'s viewer readings with the
DoNeRF driver, which ``control.py`` does not take):

- the program: the cell's window on each of ``--seeds`` seeds (``--seconds``
  each), its kept frames against the float32 DoNeRF reference: the lower
  readings;
- the control: the reference in the program's place, its MLP products in
  float8 e4m3 (the precision below the configuration's bf16), on the same
  poses for the first ``--control-seeds`` seeds: the upper readings;
- planted faults, the reference in the program's place on those seeds: the
  view features entering at layer 4 (weights drawn for that net from the
  same seed), and the density corrections or the direction term left out.

    python3 benchmark/control_donerf.py --seeds 12 --control-seeds 3 \
        [--seconds 2] [--out FILE]

Prints one JSON line a reading and a summary (largest program reading,
smallest reading of each control, each number's limit) last.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parents[1])]

import torch  # noqa: E402

import control  # noqa: E402
import harness  # noqa: E402
from reference import donerf as rdonerf  # noqa: E402
from reference import pronerf as ref  # noqa: E402
from traffic import viewer, viewer_donerf  # noqa: E402


def fault_frames(v, poses, fault):
    """The reference's frames at ``poses`` with ``fault`` planted."""
    nets = v.nets()
    donerf, skip = nets["nerf"], rdonerf.SKIP
    if fault == "view_at_layer_4":
        skip = 4
        donerf = rdonerf.draw_weights(v.config["donerf_seed"], skip=skip)
    elif fault == "no_direction":
        donerf = {"layers": [dict(p) for p in donerf["layers"]]}
        last = donerf["layers"][-1]
        last["w"] = last["w"].copy()
        last["w"][-rdonerf.DIR_CH:] = 0.0
    P = rdonerf.weights_from_tree(donerf, nets["sampler"], nets["refine"],
                                  device=v.dev)
    if fault == "no_mm":
        # the sampler's density additions 0 and multipliers 1 (its head's
        # rows for them zeroed, the multipliers' bias set to a large value)
        S = v.config["statics"]["N_samples"]
        w, b = P["sampler.out.weight"].clone(), P["sampler.out.bias"].clone()
        w[S:3 * S] = 0.0
        b[S:2 * S], b[2 * S:3 * S] = 0.0, 1.0
        P["sampler.out.weight"], P["sampler.out.bias"] = w, b
    windows = ref.window_rule(v.H, v.W)
    return [rdonerf.render_frame(
        P, v.rsc, torch.as_tensor(c, device=v.dev), v.H, v.W, v.sc["K"],
        v.config["statics"]["num_neighbor"], v.p["reference_block"], None,
        windows, skip) for c in poses]


FAULTS = ("view_at_layer_4", "no_direction", "no_mm")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="fern_donerf.view_1008")
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=2**31 + 11)
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

    v = viewer_donerf.DoNeRFViewer(cell, config, args.device)
    for seed in seeds:
        emit("program", seed, control.readings(v, seed, args.seconds))
    for seed in seeds[:args.control_seeds]:
        emit("control_fp8", seed,
             control.readings(v, seed, args.seconds, ref.fp8, program=False))
        _, _, _, kept = v.window(seed, args.seconds)
        poses = [c for c in kept if c is not None]
        want = [v.reference(c) for c in poses]
        for fault in FAULTS:
            emit(f"fault_{fault}", seed, viewer.rms_errors(
                fault_frames(v, poses, fault), want))
    kinds = sorted({r["kind"] for r in rows} - {"program"})
    summary = {"summary": {
        k: {"program_max": max(r[k] for r in rows if r["kind"] == "program"),
            **{f"{kind}_min": min(r[k] for r in rows if r["kind"] == kind)
               for kind in kinds},
            "limit": cell["limits"].get(k)}
        for k in rows[0] if k not in ("kind", "seed")}}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows + [summary], indent=1))


if __name__ == "__main__":
    main()
