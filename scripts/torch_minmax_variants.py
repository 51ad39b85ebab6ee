#!/usr/bin/env python3
"""Where the bf16 MinMax kernel's time goes: time variants of
``pronerf_tpu_torch/kernels/csrc/fused_minmax.cu`` on one CUDA card.

Each variant is the kernel's source (with its headers) under one or more
text substitutions, built with ``nvcc`` into a temporary directory (one
process per variant, started together) and called through the same C
interface as the wrapper, on the sampler and the refine pack at the ray count
of a 504x378 frame. Variants that take work away compute wrong values on
purpose: they are only timed, interleaved: one launch of each in turn, the
order reversed every turn, ``--reps`` turns (median of CUDA-event times, one
launch each; the medians of the two halves show a drift of the clock).
``as_is`` is also held against the plain version.

    python3 scripts/torch_minmax_variants.py [--rays N] [--only NAME ...]
        [--forms] [--sass] [--parent DIR] [--reps R]

``one_form`` computes the same function as ``as_is`` and must return its
output bit for bit; ``--parent DIR`` adds the variant ``parent``, the
sources of another checkout as they are (compared, not required equal).

Prints one JSON line per variant and shape, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import tempfile
from pathlib import Path

import numpy as np
import torch
from kernel_variants import (build_variants, card_line, cuda_times,
                             interleaved_times, sass_counts)

from pronerf_tpu_torch.kernels import fused_minmax as fm
from pronerf_tpu_torch.models.mlp import MinMaxMLP

# name: [(file, old, new)], every occurrence of old replaced
VARIANTS = {
    "as_is": [],
    # the ELU's exp as CUDA's accurate expf, and as the fast __expf
    "expf": [("hopper.cuh", "hp::exp_f32(x", "expf(x")],
    "fast_exp": [("hopper.cuh", "hp::exp_f32(x", "__expf(x")],
    # ReLU in the place of ELU: the epilogue without exp
    "relu": [("fused_minmax.cu", "Act::kElu", "Act::kRelu")],
    # no head products and no result rows
    "no_head": [("fused_minmax.cu", "c0 + 32 <= out_pad; c0 += 32",
                 "false; c0 += 32"),
                ("fused_minmax.cu", "c0 < out_pad; c0 += 8", "false; c0 += 8")],
    # the helpers neither read x nor write the A rows
    "no_a_rows": [("fused_minmax.cu",
                   "mm_write_a<true>(a, tile * kWgTile, pass, sm + M.a, t);", ""),
                  ("fused_minmax.cu",
                   "mm_write_a<false>(a, tile * kWgTile, pass, sm + M.a, t);", "")],
    # the helpers store nothing
    "no_store": [("fused_minmax.cu", "idx < live * out_pad / 4;", "idx < 0;"),
                 ("fused_minmax.cu", "idx < out_pad * kWgTile;", "idx < 0;")],
    # one instantiation for every C: the passes form, which at one pass
    # (C <= 128) fills the A rows once a tile and waits and arrives once
    # (the same function)
    "one_form": [
        ("fused_minmax.cu", "a.passes > 1 ? minmax_wg_kernel<true>\n"
         "                             : minmax_wg_kernel<false>",
         "minmax_wg_kernel<true>"),
        ("fused_minmax.cu", "const int fills = PASSES ? 2 * a.passes : 1;",
         "const int fills = a.passes > 1 ? 2 * a.passes : 1;"),
        ("fused_minmax.cu", "            hp::mbar_wait(at.bar(), at.phase);\n"
         "            wg_dense128_ss(",
         "            if (a.passes > 1 || hf == 0)\n"
         "              hp::mbar_wait(at.bar(), at.phase);\n"
         "            wg_dense128_ss("),
        ("fused_minmax.cu", "            if (lane == 0) hp::mbar_arrive(a_empty);\n"
         "            at.next();\n",
         "            if (a.passes > 1 || hf == 1) {\n"
         "              if (lane == 0) hp::mbar_arrive(a_empty);\n"
         "              at.next();\n"
         "            }\n"),
    ],
    # the two consumer warpgroups do not take turns
    "no_turns": [("hopper.cuh", "hp::named_barrier(4 + (threadIdx.x >> 7), 256);",
                  ""),
                 ("hopper.cuh",
                  "hp::named_barrier_arrive(5 - (threadIdx.x >> 7), 256);", ""),
                 ("fused_minmax.cu", "if (wg == 1) wg_turn_pass();", "")],
}

SHAPES = {"sampler": (48, 0, 27), "refine": (8, 96, 35)}


ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=378 * 504)
    ap.add_argument("--only", nargs="*", default=sorted(VARIANTS))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another checkout to time as 'parent'")
    ap.add_argument("--forms", action="store_true",
                    help="also time each variant with a bf16 input and with the "
                         "[out_pad, N] output")
    ap.add_argument("--sass", action="store_true",
                    help="count the opcodes of each variant's kernel in its "
                         "SASS (cuobjdump)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    names = (["as_is"] + [n for n in args.only if n != "as_is"]
             + ["parent"] * (args.parent is not None))
    with tempfile.TemporaryDirectory(prefix="minmax_variants_") as tmp:
        libs = build_variants("fused_minmax", VARIANTS, names, Path(tmp),
                              "pn_fused_minmax", ARGTYPES, args.parent)
        if args.sass:
            for name in names:
                print(json.dumps({"variant": name, "sass": sass_counts(
                    libs[name][1], "minmax_wg_kernel")}), flush=True)
        rng = np.random.default_rng(0)
        for shape, (reps, rest, out_w) in SHAPES.items():
            net = MinMaxMLP(input_ch=6 * reps + rest, output_ch=out_w,
                            generator=torch.Generator().manual_seed(0))
            packed = {k: v.to(dev) for k, v in fm.pack_minmax_params(
                net, reps, torch.bfloat16).items()}
            blob = fm._blob(packed)
            C, N = 6 + rest, args.rays
            x_t = torch.from_numpy(
                rng.standard_normal((C, N), dtype=np.float32)).to(dev)
            out_pad = packed["wout_t"].shape[0]
            depth = 6

            def make_launch(name, xx, sr, sc, out):
                fn = libs[name][0]

                def launch():
                    err = fn(xx.data_ptr(), int(xx.dtype == torch.bfloat16),
                             blob.data_ptr(), blob.numel(), out.data_ptr(),
                             N, C, depth, out_pad, sr, sc, 1,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise SystemExit(f"{name}: launch error {err}")
                return launch

            outs = {name: torch.empty(N, out_pad, device=dev)
                    for name in names}
            times = interleaved_times(
                {name: make_launch(name, x_t, out_pad, 1, outs[name])
                 for name in names}, args.reps)
            for name in names:
                ts = times[name]
                row = {"variant": name, "shape": shape, "rays": N,
                       "launches": len(ts), "ms": statistics.median(ts),
                       "ms_min": min(ts),
                       "ms_first_half": statistics.median(ts[:len(ts) // 2]),
                       "ms_second_half": statistics.median(ts[len(ts) // 2:]),
                       "ptxas": libs[name][2]}
                if name in ("one_form", "parent"):
                    row["equal_to_as_is"] = bool(torch.equal(
                        outs[name], outs["as_is"]))
                if name == "as_is":
                    want = fm.fused_minmax_plain(packed, x_t[:, :16384])
                    row["max_abs_err_16384"] = float(
                        (outs[name][:16384] - want).abs().max())
                print(json.dumps(row), flush=True)
                if name == "one_form" and not row["equal_to_as_is"]:
                    raise SystemExit("one_form differs from as_is")
            if args.forms:
                # the wrapper's other input dtype and output layout
                for name in names:
                    out = torch.empty(N, out_pad, device=dev)
                    for form, xx, (sr, sc) in (
                            ("bf16_x", x_t.to(torch.bfloat16), (out_pad, 1)),
                            ("untransposed", x_t, (1, N))):
                        ts = cuda_times(make_launch(name, xx, sr, sc, out),
                                        args.reps)
                        print(json.dumps({
                            "variant": name, "shape": shape, "form": form,
                            "rays": N, "ms": statistics.median(ts),
                            "ms_min": min(ts)}), flush=True)
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
