#!/usr/bin/env python3
"""Where the int8 NeRF kernel's time goes: time variants of
``pronerf_tpu_torch/kernels/csrc/fused_nerf_q.cu`` on one CUDA card.

Each variant is the kernel's source (with its headers) under one or more
text substitutions, built with ``nvcc`` (one process per variant, started
together) and called through the same C interface as the wrapper, on an int8
pack of a seeded NeRF at the ray count of a 504x378 frame, S = 8. Variants
marked EXACT compute the same function by other instructions and must
return the output of ``as_is`` bit for bit; the others compute wrong values
on purpose and are only timed (median of CUDA-event times, one launch each).
``as_is`` is also held against the plain version on 16,384 rays.

    python3 scripts/torch_nerf_q_variants.py [--rays N] [--only NAME ...]
        [--sass]

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
from kernel_variants import build_variants, card_line, cuda_times, sass_counts

from pronerf_tpu_torch.kernels import fused_nerf_q as fq
from pronerf_tpu_torch.models.mlp import NeRFMLP
from pronerf_tpu_torch.models.pronerf import view_contribution
from pronerf_tpu_torch.ops.encoding import positional_encoding

KERNEL = "nerf_q_wg_kernel"
_S32 = "return __int2float_rn(v);"
_Y = ('asm("add.rn.sat.f32 %0, %1, 0f3B000000;\\n" : "=f"(y) : "f"(t));')
_REQUANT = ("return __float_as_uint(__fadd_rd(fminf(y, 0.9921875f), "
            "32768.50390625f));")

# name: ([(file, old, new)], EXACT)
VARIANTS = {
    "as_is": ([], True),
    # the floor and the clamps with the conversion instructions (FRND and
    # F2I), as the first int8 kernel wrote them (on t = 256 t'): the same codes
    "conversions": ([
        ("hopper.cuh", _Y,
         "y = fminf(fmaxf(floorf(__fadd_rn(__fmul_rn(t, 256.0f), 0.5f)), "
         "0.0f), 254.0f);"),
        ("hopper.cuh", _REQUANT, "return (uint32_t)(__float2int_rn(y) - 127);"),
    ], True),
    # s32 -> f32 as the bits of 1.5 * 2^23 + v, less 1.5 * 2^23 (an IADD
    # and an FADD in the place of one I2FP)
    "magic_s32": ([("hopper.cuh", _S32, "return __fsub_rn(__int_as_float("
                    "v + 0x4B400000), 12582912.0f);")], True),
    # the clamp at 0 as an FMNMX, as step 5 had it
    "fmnmx": ([("hopper.cuh", _Y, "y = fmaxf(__fadd_rn(t, 0.001953125f), 0.0f);")],
              True),
    # the floor's add rounded to nearest (wrong codes on purpose): what the
    # round-down mode costs
    "rn_floor": ([("hopper.cuh", _REQUANT,
                   "return __float_as_uint(__fadd_rn(fminf(y, 0.9921875f), "
                   "32768.50390625f));")], False),
    # no clamps (wrong codes on purpose): what the two FMNMX cost
    "no_clamp": ([("hopper.cuh", _Y, "y = __fadd_rn(t, 0.001953125f);"),
                  ("hopper.cuh", _REQUANT,
                   "return __float_as_uint(__fadd_rd(y, 32768.50390625f));")],
                 False),
    # no clamp and no floor: the f32 value's low byte
    "no_requant": ([("hopper.cuh", _REQUANT,
                     "return __float_as_uint(t);")], False),
    # ... and no s32 -> f32 either: what is left of the epilogue is the
    # per-channel multiply and add and the packing
    "no_requant_no_s32": ([("hopper.cuh", _REQUANT,
                            "return __float_as_uint(t);"),
                           ("hopper.cuh", _S32, "return __int_as_float(v);")],
                          False),
    # the view epilogue without the vcon term (wrong values on purpose)
    "no_vcon": ([("fused_nerf_q.cu", "vc[i] = vv[(16 * e + i) * 128];",
                  "vc[i] = 0.0f;")], False),
}

ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=378 * 504)
    ap.add_argument("--only", nargs="*", default=sorted(VARIANTS))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", action="store_true",
                    help="count the opcodes of each variant's kernel in its "
                         "SASS (cuobjdump)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import pronerf_tpu_torch  # noqa: F401  (switches TF32 off)

    dev = torch.device("cuda", 0)
    names = ["as_is"] + [n for n in args.only if n != "as_is"]
    with tempfile.TemporaryDirectory(prefix="nerf_q_variants_") as tmp:
        libs = build_variants(
            "fused_nerf_q", {n: v[0] for n, v in VARIANTS.items()}, names,
            Path(tmp), "pn_fused_nerf_raw_q", ARGTYPES)
        if args.sass:
            for name in names:
                print(json.dumps({"variant": name, "sass": sass_counts(
                    libs[name][1], KERNEL)}), flush=True)

        net = NeRFMLP(generator=torch.Generator().manual_seed(0)).to(dev)
        packed = fq.pack_nerf_params_int8(net)
        blob = fq._blob(packed)
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
        first = None
        for name in names:
            fn, _, ptxas = libs[name]
            raw = torch.empty(N, S, 4, device=dev)

            def launch():
                err = fn(pts.data_ptr(), vcon.data_ptr(), blob.data_ptr(),
                         blob.numel(), raw.data_ptr(), N, S,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"{name}: launch error {err}")

            times = cuda_times(launch, args.reps)
            row = {"variant": name, "rays": N, "ms": statistics.median(times),
                   "ms_min": min(times), "ptxas": ptxas}
            if name == "as_is":
                first = raw.clone()
                n = min(N, 16384)
                with torch.no_grad():
                    want = fq.fused_nerf_raw_q_plain(
                        packed, pts[:, :n].contiguous(),
                        vcon[:, :n].contiguous(), S)
                diff = (raw[:n] - want).abs()
                std = float(want.std())
                row["max_over_std_16384"] = float(diff.max()) / std
                row["differing_share_16384"] = float(
                    (diff > 1e-5 * std).float().mean())
            elif VARIANTS[name][1]:
                row["equal_to_as_is"] = bool(torch.equal(raw, first))
                if not row["equal_to_as_is"]:
                    print(json.dumps(row), flush=True)
                    raise SystemExit(f"{name} is marked exact and differs "
                                     "from as_is")
            print(json.dumps(row), flush=True)
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
