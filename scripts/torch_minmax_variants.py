#!/usr/bin/env python3
"""Where the bf16 MinMax kernel's time goes: time variants of
``pronerf_tpu_torch/kernels/csrc/fused_minmax.cu`` on one CUDA card.

Each variant is the kernel's source (with its headers) under one or more
text substitutions, built with ``nvcc`` into a temporary directory (one
process per variant, started together) and called through the same C
interface as the wrapper, on the sampler and the refine pack at the ray count
of a 504x378 frame. Variants that take work away compute wrong values on
purpose: they are only timed (median of CUDA-event times, one launch each).
``as_is`` is also held against the plain version.

    python3 scripts/torch_minmax_variants.py [--rays N] [--only NAME ...]
        [--forms] [--sass]

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
from kernel_variants import build_variants, card_line, cuda_times, sass_counts

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
                   "mm_write_a<true>(a, tile * kWgTile, sm + M.a, t);", ""),
                  ("fused_minmax.cu",
                   "mm_write_a<false>(a, tile * kWgTile, sm + M.a, t);", "")],
    # the helpers store nothing
    "no_store": [("fused_minmax.cu", "idx < live * out_pad / 4;", "idx < 0;"),
                 ("fused_minmax.cu", "idx < out_pad * kWgTile;", "idx < 0;")],
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
    with tempfile.TemporaryDirectory(prefix="minmax_variants_") as tmp:
        libs = build_variants("fused_minmax", VARIANTS, args.only, Path(tmp),
                              "pn_fused_minmax", ARGTYPES)
        if args.sass:
            for name in args.only:
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
            for name in args.only:
                fn, _, ptxas = libs[name]
                out = torch.empty(N, out_pad, device=dev)
                forms = [("", x_t, (out_pad, 1))]
                if args.forms:
                    # the wrapper's other input dtype and output layout
                    forms += [("bf16_x", x_t.to(torch.bfloat16), (out_pad, 1)),
                              ("untransposed", x_t, (1, N))]
                for form, xx, (sr, sc) in forms:
                    def launch():
                        err = fn(xx.data_ptr(), int(xx.dtype == torch.bfloat16),
                                 blob.data_ptr(), blob.numel(), out.data_ptr(),
                                 N, C, depth, out_pad, sr, sc, 1,
                                 torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise SystemExit(f"{name} {form}: launch error {err}")

                    times = cuda_times(launch, args.reps)
                    row = {"variant": name, "shape": shape, "rays": N,
                           "ms": statistics.median(times), "ms_min": min(times)}
                    if form:
                        row["form"] = form
                    else:
                        row["ptxas"] = ptxas
                        if name == "as_is":
                            want = fm.fused_minmax_plain(packed, x_t[:, :16384])
                            row["max_abs_err_16384"] = float(
                                (out[:16384] - want).abs().max())
                    print(json.dumps(row), flush=True)
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
