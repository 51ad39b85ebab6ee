#!/usr/bin/env python3
"""Where the bf16 NeRF kernel's time goes: time variants of
``pronerf_tpu_torch/kernels/csrc/fused_nerf.cu`` (the raw form) on one CUDA
card.

Each variant is the kernel's source (with its headers) under one or more
text substitutions, built with ``nvcc`` (one process per variant, started
together) and called through the same C interface as the wrapper, on a bf16
pack of a seeded NeRF at the ray count of a 504x378 frame, S = 8. Every
variant here computes the same function at S = 8 by other instructions and
must return the output of ``as_is`` bit for bit. ``--parent DIR`` adds the
variant ``parent``: the sources of another checkout as they are (its result
is compared, not required to be equal). The variants are timed interleaved:
one launch of each in turn, the order reversed every turn, ``--reps`` turns
(median of CUDA-event times, one launch each; the medians of the first and
the second half show a drift of the clock). ``as_is`` is also held against
the plain version on 16,384 rays.

    python3 scripts/torch_nerf_variants.py [--rays N] [--only NAME ...]
        [--parent DIR] [--reps R]

Prints one JSON line per variant, then the card's name and power limit.
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
from kernel_variants import build_variants, card_line, interleaved_times

from pronerf_tpu_torch.kernels import fused_nerf as fn
from pronerf_tpu_torch.models.mlp import NeRFMLP
from pronerf_tpu_torch.models.pronerf import view_contribution
from pronerf_tpu_torch.ops.encoding import positional_encoding

_STORE = "          store_raw(a, base, live, s0, n, res, t, kHelpers);"

# name: [(file, old, new)], every occurrence of old replaced
VARIANTS = {
    "as_is": [],
    # the helpers store a tile whose S results are one chunk (S <= 8) as one
    # contiguous copy, as the kernel did before the chunks
    "contiguous_store": [("fused_nerf.cu", _STORE, """\
          if (S == kResChunk) {
            float4* dst =
                reinterpret_cast<float4*>(a.raw + (size_t)base * S * 4);
            const uint2* src = reinterpret_cast<const uint2*>(res);
            for (int idx = t; idx < live * S; idx += kHelpers) {
              const uint2 v = src[idx];
              dst[idx] = make_float4(hp::bf16_lo(v.x), hp::bf16_hi(v.x),
                                     hp::bf16_lo(v.y), hp::bf16_hi(v.y));
            }
          } else {
  """ + _STORE + "\n          }")],
    # the consumers without the hand-over between chunks inside the sample
    # loop (the same function at S <= 8 only)
    "no_chunk_turn": [("fused_nerf.cu",
                       "if (s > 0 && s % kResChunk == 0) {", "if (false) {")],
}

ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=378 * 504)
    ap.add_argument("--only", nargs="*", default=sorted(VARIANTS))
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another checkout to time as 'parent'")
    ap.add_argument("--reps", type=int, default=60)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import pronerf_tpu_torch  # noqa: F401  (switches TF32 off)

    dev = torch.device("cuda", 0)
    names = ["as_is"] + [n for n in args.only if n != "as_is"]
    if args.parent is not None:
        names = ["parent"] + names
    with tempfile.TemporaryDirectory(prefix="nerf_variants_") as tmp:
        libs = build_variants("fused_nerf", VARIANTS, names, Path(tmp),
                              "pn_fused_nerf_raw", ARGTYPES, args.parent)

        net = NeRFMLP(generator=torch.Generator().manual_seed(0)).to(dev)
        packed = fn.pack_nerf_params(net, torch.bfloat16)
        blob = fn._blob(packed)
        rng = np.random.default_rng(2)
        N, S = args.rays, 8
        pts = torch.from_numpy(
            rng.uniform(-1, 1, (S * 3, N)).astype(np.float32)).to(dev)
        dirs = torch.from_numpy(
            rng.standard_normal((N, 3)).astype(np.float32)).to(dev)
        dirs = dirs / dirs.norm(dim=-1, keepdim=True)
        with torch.no_grad():
            vcon = view_contribution(net, positional_encoding(dirs, 4),
                                     torch.bfloat16).contiguous()
        outs, launches = {}, {}
        for name in names:
            fn_c = libs[name][0]
            outs[name] = torch.empty(N, S, 4, device=dev)

            def launch(fn_c=fn_c, raw=outs[name], name=name):
                err = fn_c(pts.data_ptr(), vcon.data_ptr(), blob.data_ptr(),
                           blob.numel(), raw.data_ptr(), N, S, 1,
                           torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"{name}: launch error {err}")

            launches[name] = launch
        times = interleaved_times(launches, args.reps)
        for name in names:
            print(json.dumps({
                "variant": name, "rays": N, "launches": args.reps,
                "ms": statistics.median(times[name]),
                "ms_min": min(times[name]),
                "ms_first_half": statistics.median(
                    times[name][: args.reps // 2]),
                "ms_second_half": statistics.median(
                    times[name][args.reps // 2:]),
                "ptxas": libs[name][2]}), flush=True)
        n = min(N, 16384)
        with torch.no_grad():
            want = fn.fused_nerf_raw_plain(packed, pts[:, :n].contiguous(),
                                           vcon[:, :n].contiguous(), S)
        check = {"as_is_max_abs_err_16384":
                 float((outs["as_is"][:n] - want).abs().max())}
        for name in names:
            if name != "as_is":
                check[f"{name}_equal_to_as_is"] = bool(
                    torch.equal(outs[name], outs["as_is"]))
        print(json.dumps(check), flush=True)
        unequal = [k for k, v in check.items() if v is False
                   and not k.startswith("parent")]
        if unequal:
            raise SystemExit(f"variants that differ from as_is: {unequal}")
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
