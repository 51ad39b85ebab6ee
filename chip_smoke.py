#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pronerf_tpu_torch``) on one NVIDIA
Hopper card: ``python3 chip_smoke.py``.

It needs a CUDA device and ``nvcc`` and fails without them; nothing here
falls back to the CPU. Phases, each printing one JSON line:

1. ``device``   card name and power limit (nvidia-smi), torch/CUDA versions;
2. ``build``    builds the host runtime (``pronerf_tpu_torch/native``, g++)
                and compiles ``pronerf_tpu_torch/kernels/csrc/*.cu`` (one
                nvcc per source, started together) and reads ``ptxas
                -v``'s report of the three ``wgmma`` kernels: it fails if
                any of their
                products was serialized or if one spills, and if the int8
                kernel's SASS holds more conversion instructions (I2F, F2I,
                FRND, ...; not I2FP) than the bf16 NeRF kernel's, whose only
                ones are in the PE code that both share;
3. ``kernels``  every fused kernel, in bf16 and in f32 (the int8 NeRF
                kernel in int8), at the width and ray count of a 504x378
                frame, on inputs made from a numpy seed: held against its
                plain PyTorch version on the same inputs (the plain version
                runs in chunks of rays, for memory), on a ragged ray count
                too, on 100 rays (one block, one ragged tile) for every
                kernel, and timed with CUDA events.
                The MinMax kernel also with ``transpose_out=False``, with a
                bf16 input and, for the refine shape, with the transposed
                graph's permuted pack; the int8 kernel also against the bf16
                kernel; each kernel past its former limits (the refine
                net at C = 198 and 1542 input rows, 128 samples a ray); the
                refine net of 2 neighbours (C = 54); and each at the 762,048
                rays of a 1008x756 frame;
4. ``frame``    the serving path end to end, three times through
                ``run_inference`` on the synthetic 504x378 scene with 17
                views, release widths, bf16, whole frame in one tile, fused
                kernels on: the default graph (raw kernel + composite op),
                ``quant = int8``, and ``transposed = True``; then the default
                graph's frame with the composite fused into the NeRF kernel;
                then a tile of the frame's own rays, all nine outputs, each
                relative to its size: the composite forms against each other,
                the kernel path against the port's kernel-free bf16 path and
                against the plain versions (the same code on CPU tensors),
                the int8 path against the bf16 kernel path and against its
                plain versions, the transposed graph against the row-major
                one; then four more drives at the shapes past the kernels'
                former limits: 16 samples a ray (refine C = 198), and 128
                (refine C = 1542, its head in parts; the NeRF kernels at S =
                128) in the default, the int8 and the transposed graph, and
                2 neighbours (refine C = 54) in the default graph.
                Launch counters (the MinMax one by input width, so sampler
                and refine are counted apart, and its untransposed form
                apart again; the NeRF ones also by samples a ray) are zeroed
                before and read after each drive;
4b. ``fullres`` the serving path at 1008x756 (the reference engine's frame;
                ``synthetic:1008x756x17``, ``fern_trt.txt``, 3 held-out
                poses): the statics ``gather_tiles = -1`` resolves to
                (printed; 8 ray tiles of 198-row windows), the default
                (windowed) form through ``run_inference``, then the
                windowed, unwindowed (``gather_tiles = 0``), transposed and
                int8 forms through the frame renderer, each with ms a frame
                (CUDA events, median of 9 after a warm-up frame a pose),
                launches and peak memory; a split frame equal to the
                windowed one bit for bit; on the first pose's own points the
                share the windows miss, the windowed colours equal to the
                unwindowed ones wherever the window hits, the transposed
                emit and the split fetch equal to the row form, and each
                gather's ms; the windowed frame equal to the unwindowed one
                on every ray no window missed, the transposed frame against
                the row-major one, int8 against bf16; the headline bench's
                second point, 2 neighbours (refine C = 54), windowed: ms a
                frame, launches, device busy ms and kernels a frame
                (profiler), the frame against the same frame with the plain
                versions on the card (tile by tile; no kernel launched); a
                tile of the frame against the kernel-free bf16 path and the
                plain versions;
4c. ``gathers`` at 504x378: a ``gather_split`` frame equal to the default
                frame bit for bit, ``warp_interp = nearest`` served through
                ``run_inference``, the per-view training gather equal to the
                all-views one on a batch's points (both timed) and a stage-1
                sampler step with ``train_gather = 1`` against the same step
                with the all-views gather (``TRAIN_TOL``);
5. ``train``    the training slice at release widths (``fern_epi.txt``,
                ``fern_refine.txt``) on the same scene (14 train views):
                ``run_training`` for 4 steps of stage 1 (2 pairs, writing an
                ``i_img`` PNG) and 2 of stage 2 bootstrapped from that
                expdir, every kernel counter 0 across both (training runs no
                kernel); a run of 2 steps resumed for 2 more, equal to the
                uninterrupted run in every logged loss and in the weights;
                the stage-2 checkpoint served by ``run_inference`` through
                the kernels (``fern_trt.txt``), its frame equal to a render
                from the checkpoint's params passed in directly and not to
                one from untrained weights; ms a step by CUDA events (median
                of 5 after 2) and peak memory for the NeRF step at n_mult =
                1 and 8, the sampler step and the stage-2 step, at 4096
                rays; one step of each kind on the card held against the
                same step on CPU tensors (``TRAIN_TOL``);
5a. ``scan``    several training steps a dispatch (``train/fast_loop.py``)
                at release widths on the training scene: a stage-1 chunk of
                8 steps (4 pairs) and a stage-2 chunk of 8 from one state,
                each step kind a CUDA graph, held against the eager steps fed
                the controls and noise the chunk drew (``TRAIN_TOL``); ms a
                step eager against each graph's replay and a whole chunk
                (median of 5), device busy ms and kernels a step (profiler),
                the capture's seconds, peak memory, the floors; an odd
                stage-1 resume taking the per-step loop with its note; a NaN
                state raising FloatingPointError at its first chunk's end;
5b. ``donerf``  ``netarch = donerf`` at D = 8, W = 256: one 504x378 frame
                through ``run_inference`` (no kernel runs: they implement
                the NeRF MLP) and one stage-1 NeRF step on the card against
                the same step on CPU tensors (``TRAIN_TOL``);
5c. ``export`` the exported renderer (``render/export.py``):
                ``run_export`` at 1008x756 with the ``--use-trt`` statics
                (the windows resolved, checked), then ``quant = int8`` and
                ``transposed = True`` at 504x378, each program loaded back
                and its frames on 3 held-out poses (9 timed a pose) equal to
                the live renderer's bit for bit, with the same launches a
                frame (the kernels' ops counted inside the program); export
                and load seconds, artifact bytes, ms a frame both ways;
5d. ``multi``  several scenes, ranks and the frame as a CUDA graph:
                ``train-multi`` through ``cli.main`` on 8 synthetic scenes of
                504x378x17 (``fern_epi.txt``: 2 steps, resumed for 2 more
                with one held-out render a scene; stage 2 from that expdir
                for 2 steps), per-scene checkpoints, no kernel launched; the
                multi-scene step as one CUDA graph of the scenes' steps at
                1, 2 and 8 scenes against each scene's eager step
                (``TRAIN_TOL``), ms a step both ways and peak memory; in a
                world of one over NCCL, the sharded frame renderer at
                504x378 (default, ``fuse_composite``, int8, transposed) and
                1008x756 equal to the live renderer bit for bit with the
                same launches (the slice's kernel path), the frame body as
                a CUDA graph replayed equal to the eager frame, the
                steady-state ms/frame (``amortized_timer``) beside the eager
                frame and its busy time;
6. ``cli``      the command line (``pronerf_tpu_torch.cli.main``, in process)
                on an LLFF capture of fern's shape written by the port's
                fixtures (the consistent scene, 20 views, ``images_4`` PNGs of
                504x378, ``poses_bounds.npy`` at the raw scale, a binary
                COLMAP model): ``train-stage1`` (``fern_epi.txt``, 4 steps),
                ``train-stage2`` (``fern_refine.txt``, 2 steps, from that
                expdir), ``eval --use-trt`` on the 3 held-out views and
                ``infer --use-trt -- --quant int8``, each with the counters
                zeroed just before and read just after: training runs no
                kernel and the native pool twice; eval the sampler, refine
                and raw NeRF kernels, int8 the int8 one; the native COLMAP
                scan once each; losses and frames finite, PNGs written;
                ``i_ref`` equal to the Python path's greedy pick; the eval
                frame equal to a render from the checkpoint's params passed
                in directly; ``render-path --use-trt --n-frames 6`` written
                as a GIF (the port's own writer where imageio is absent),
                read back, frame 0 against a direct render within the
                palette's bound; a 4-step ``train-stage1`` with ``i_video =
                2`` writing its spiral videos at steps 2 and 4;
                ``train-stage1`` / ``train-stage2 -- --scan_steps 4`` for 8
                steps each (CUDA graphs; ``000008.ckpt``); ``export
                --use-trt`` at 504x378 from the stage-2 checkpoint and
                ``infer --from-export --max-images 1 --timing-reps 3``,
                its PNG equal to the eval frame's; ``infer --use-trt
                --timing-reps 3`` printing the steady-state line. A
                ``cli_timings`` line: seconds to write, load and decode the
                capture (and a Paeth-filtered PNG), to build the pool
                natively and in NumPy, ms per eval frame, the render-path
                and i_video runs' seconds, with the card's name and power
                limit.

Then the card's name and power limit, one ``{"kernels": [...]}`` line with
the roofline bound of each kernel beside its measured time (and its
launches on the main path, in the export phase's programs, on the sharded
renderer's drives and in the frame graphs' captures), and last
``{"ok": true, "device": {...}}``. Any failure raises, so the exit code is
non-zero and no result line is printed.

``--only build|kernels|frame|fullres|gathers|train|scan|donerf|export|multi|cli``
runs a
subset while developing, ``--rays N`` shrinks the kernel phase,
``--profile`` adds ``profile`` lines (device time by kernel name over a few
frames of the fused-composite, the int8 and the transposed frame and of
each 1008x756 form; the launches of the MinMax and the int8 NeRF kernel one
by one).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import io
import json
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
H, W_IMG, N_VIEWS = 378, 504, 17
FRAME_RAYS = H * W_IMG
FULL_H, FULL_W = 756, 1008   # the reference engine's frame (full res)
FULL_RAYS = FULL_H * FULL_W
CHUNK = 16384          # rays per call of a plain version
RAGGED = 16384 - 37    # not a multiple of any kernel tile
TINY = 100             # NeRF and MinMax kernels: one ragged tile, one block

# Published dense peaks of one H100 SXM (NVIDIA data sheet).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

# Tolerances, kernel against plain version on the card, same inputs.
# f32: both sides do the same arithmetic and differ at most in the order of
# the f32 sums, so the bound is tight enough to catch an indexing mistake.
# bf16: both sides round at the same points, but a sum taken in another
# order can land on the other side of a bf16 rounding boundary (one unit in
# the last place, 2^-8 relative), and later layers carry that on. With the
# seeded nets the heads are of size ~1, so a few such units: 0.02 on heads
# and raw logits, 0.005 on composited values (weights sum to at most 1).
# Both are tighter than the JAX package's own bf16 bounds (0.15 on raw
# logits, 0.02 on composited rgb and depth). disp = 1 / (depth / acc) is
# compared relative to its size.
TOL = {
    "float32": {"head": 2e-4, "raw": 2e-4, "comp": 2e-4, "disp_rel": 2e-3},
    "bfloat16": {"head": 0.02, "raw": 0.02, "comp": 0.005, "disp_rel": 0.05},
    # The int8 kernel cannot equal its plain version to the bit: sincosf and
    # torch.sin differ in the last place, which moves a bf16 PE value by a
    # step, and the two K = 63 products sum in f32 in another order; either
    # can push a layer-0 or layer-5 sum across a .5 requantisation boundary
    # and flip a code by one step, which later layers carry on. Everything
    # after a given set of codes is exact integer arithmetic. So two
    # measures: the share of raw elements that differ by more than the last
    # bits of an f32 (1e-5 of the spread), and the largest difference over
    # std(plain raw). Both bounds are several times tighter than the distance
    # between the int8 and the bf16 chain (max 0.25 std + 0.02, mean 0.02 std
    # + 0.002, the JAX package's test bounds, also held here), so they tell a
    # wrong kernel (a swapped panel, a wrong k permutation) from a right one.
    # Measured on an H100 at 190,512 rays: 0.043% of the elements differ,
    # by 0.008 std at most.
    "int8": {"share": 0.005, "max_over_std": 0.05, "last_bits": 1e-5},
}
# measures listed in a row's errs/tols that are not absolute errors of the
# kernel against its plain version
NOT_ABS = ("_rel", "_share", "_vs_bf16")
# bf16 renders of the same rays against each other, per output key: the
# largest difference over the largest size of the reference. Relative, because
# with seeded random weights the rays are near-transparent (rgb1, acc and
# sigma are a few hundredths at most): an absolute bound of 0.02 would pass a
# NeRF kernel that returned zeros.
# FORMS_REL: between the two composite forms everything up to the NeRF kernel
# is the same code on the same inputs; only the f32 compositing is summed in
# another order.
# PATHS_REL: kernel path against the kernel-free bf16 path (stricter than the
# 0.02 absolute that the JAX package's tests allow on rgb1 and depth, since no
# output here is larger than 1). sigma is left out of this one: the kernel
# encodes the bf16-rounded point, the kernel-free net the f32 point, and at
# the top frequency (2^9) that rounding moves the phase by up to a radian, so
# the two nets' raw logits differ by a third of their size by construction.
# PLAIN_REL, PLAIN_SHARE: kernel path on the card against the same code on CPU
# tensors, where each wrapper takes its plain version (same rounding points,
# sigma included). A head that lands on the other side of a bf16 boundary on
# one of the two machines moves that ray's depths or points by a bf16 step,
# and the ray's sigma with them, so a small share of elements may differ by
# more than the bound (measured on an H100: 0.03% of sigma, largest 0.2 of its
# size; every other key within 0.008 everywhere).
# QUANT_REL: the int8 frame against the bf16 kernel frame, same graph up to
# the NeRF kernel. The JAX package's test holds PSNR(rgb1) above 32 dB and
# depth within 0.05, which near-transparent rays pass with a zero output, so
# every key is also held relative to its size (a zero output is off by 1).
# TRANSPOSED_*: the transposed graph against the row-major one: the JAX
# test's bulk and tail bounds for bf16 (99th percentile of the difference
# under 0.02, under 1% of elements over 0.05), and the relative bound of
# PLAIN_REL / PLAIN_SHARE, since the two graphs differ as two machines do:
# the refine product sums its rows in a permuted order and the projection is
# written out, so isolated rays land on the other side of a bf16 or an
# out-of-bounds boundary.
FORMS_REL = 1e-4
PATHS_REL = 0.02
PLAIN_REL = 0.05
PLAIN_SHARE = 0.005
QUANT_REL = 0.1
QUANT_PSNR_DB = 32.0
QUANT_DEPTH = 0.05
TRANSPOSED_BULK, TRANSPOSED_TAIL, TRANSPOSED_TAIL_SHARE = 0.02, 0.05, 0.01
NINE_KEYS = ("rgb0", "rgb1", "depth", "disp", "acc", "weights", "mm_rgb",
             "depth0", "sigma")


def say(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Median time of ``fn()`` in ms by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ------------------------------------------------------------- the nets --

def make_nets(seed: int, device):
    from pronerf_tpu_torch.models.pronerf import init_pronerf_params

    return init_pronerf_params(torch.Generator().manual_seed(seed),
                               device=device)


# ------------------------------------------------------ kernel phase ------

def minmax_case(net, reps, C, n_rays, dtype, device, seed):
    """One MinMax kernel case: (kernel_fn, plain_fn, compare, MACs, bytes
    moved when every input is read once and every output written once)."""
    from pronerf_tpu_torch.kernels import fused_minmax as fm
    from pronerf_tpu_torch.models.pronerf_t import refine_rest_row_perm

    packed = fm.pack_minmax_params(net, reps, dtype)
    rng = np.random.default_rng(seed)
    x_t = torch.from_numpy(
        rng.standard_normal((C, n_rays), dtype=np.float32)
    ).to(device)
    if C > 6:  # refine: warped colours in [0, 1] after the signature
        x_t[6:] = torch.from_numpy(
            rng.random((C - 6, n_rays), dtype=np.float32)).to(device)

    def kernel():
        return fm.fused_minmax_t(packed, x_t)

    def plain():
        return torch.cat([
            fm.fused_minmax_plain(packed, x_t[:, i:i + CHUNK].contiguous())
            for i in range(0, n_rays, CHUNK)
        ])

    def compare(tol):
        k, pl = kernel(), plain()
        k_t = fm.fused_minmax_t(packed, x_t, transpose_out=False)
        # a bf16 input, as the row-major graph gives the refine net
        x_b = x_t.to(torch.bfloat16)
        k_b = fm.fused_minmax_t(packed, x_b)
        pl_b = torch.cat([
            fm.fused_minmax_plain(packed, x_b[:, i:i + CHUNK].contiguous())
            for i in range(0, n_rays, CHUNK)
        ])
        errs = {
            "head": (max_err(k, pl), tol["head"]),
            # the untransposed form: the same values, element for element
            "untransposed": (max_err(k_t, k.T), 0.0),
            "bf16_input": (max_err(k_b, pl_b), tol["head"]),
        }
        if C in (54, 102):
            # the transposed graph's pack: first-layer rows permuted, and
            # the input rows with them
            perm = refine_rest_row_perm((C - 6) // 24, 8)
            packed_p = fm.pack_minmax_params(net, reps, dtype,
                                             rest_row_perm=perm)
            x_p = torch.cat([x_t[:6], x_t[6:][torch.as_tensor(
                perm, device=device)]]).contiguous()
            k_p = fm.fused_minmax_t(packed_p, x_p, transpose_out=False)
            pl_p = torch.cat([
                fm.fused_minmax_plain(
                    packed_p, x_p[:, i:i + CHUNK].contiguous())
                for i in range(0, n_rays, CHUNK)
            ])
            errs["permuted"] = (max_err(k_p.T, pl_p), tol["head"])
        return errs

    out_pad = packed["wout_t"].shape[0]
    n_out = net.out.weight.shape[0]  # the head the function needs, unpadded
    macs = n_rays * (C * 256 + 5 * 256 * 256 + 256 * n_out)
    nbytes = (x_t.numel() * 4 + n_rays * out_pad * 4
              + fm._blob(packed).numel() * packed["w0_t"].element_size())
    return kernel, plain, compare, macs, nbytes


def nerf_inputs(n_rays, device, seed, S=8):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    dirs = rng.standard_normal((n_rays, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return {
        "pts24_t": t(rng.uniform(-1, 1, (S * 3, n_rays))),
        "dirs": t(dirs),
        "z_t": t(np.sort(rng.random((S, n_rays)), axis=0)),
        "mm_add_t": t(rng.standard_normal((S, n_rays))),
        "mm_mul_t": t(rng.standard_normal((S, n_rays)) + 0.5),
        "dnorm_t": t(1.0 + rng.random((1, n_rays))),
    }


def nerf_case(kind, net, n_rays, dtype, device, seed, S=8):
    from pronerf_tpu_torch.kernels import fused_nerf as fn
    from pronerf_tpu_torch.models.pronerf import view_contribution
    from pronerf_tpu_torch.ops.encoding import positional_encoding

    packed = fn.pack_nerf_params(net, dtype)
    inp = nerf_inputs(n_rays, device, seed, S)
    vcon_t = view_contribution(
        net, positional_encoding(inp["dirs"], 4), dtype).contiguous()
    pts = inp["pts24_t"]
    aux = [inp[k] for k in ("z_t", "mm_add_t", "mm_mul_t", "dnorm_t")]

    def cols(a, i):
        return a[:, i:i + CHUNK].contiguous()

    if kind == "raw":
        def kernel():
            return fn.fused_nerf_raw_t(packed, pts, vcon_t, S)

        def plain():
            return torch.cat([
                fn.fused_nerf_raw_plain(packed, cols(pts, i), cols(vcon_t, i), S)
                for i in range(0, n_rays, CHUNK)
            ])

        def compare(tol):
            return {"raw": (max_err(kernel(), plain()), tol["raw"])}
        out_bytes = n_rays * S * 4 * 4
        in_bytes = (pts.numel() + vcon_t.numel()) * 4
    else:
        def kernel():
            return fn.fused_nerf_composite_t(packed, pts, vcon_t, *aux, S)

        def plain():
            parts = [
                fn.fused_nerf_composite_plain(
                    packed, cols(pts, i), cols(vcon_t, i),
                    *[cols(a, i) for a in aux], S)
                for i in range(0, n_rays, CHUNK)
            ]
            return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

        def compare(tol):
            k, p = kernel(), plain()
            errs = {
                key: (max_err(k[key], p[key]), tol["comp"])
                for key in ("rgb", "depth", "acc", "weights")
            }
            errs["sigma"] = (max_err(k["sigma"], p["sigma"]), tol["raw"])
            # disp = 1 / (depth / acc) is NaN where a ray's weights are all
            # zero, in both; elsewhere it is compared relative to its size
            fin = torch.isfinite(p["disp"])
            if not torch.equal(fin, torch.isfinite(k["disp"])):
                raise SystemExit("disp: kernel and plain version are "
                                 "finite on different rays")
            rel = ((k["disp"] - p["disp"]).abs() / p["disp"].abs())[fin]
            errs["disp_rel"] = (float(rel.max()), tol["disp_rel"])
            return errs
        out_bytes = n_rays * (3 + 3 + 2 * S) * 4
        in_bytes = (pts.numel() + vcon_t.numel()
                    + sum(a.numel() for a in aux)) * 4

    per_point = (63 * 256 + 4 * 256 * 256 + (63 + 256) * 256 + 2 * 256 * 256
                 + 256 + 256 * 256 + 256 * 128 + 128 * 3)
    macs = n_rays * S * per_point
    nbytes = (in_bytes + out_bytes
              + fn._blob(packed).numel() * packed["w1_t"].element_size())
    return kernel, plain, compare, macs, nbytes


def nerf_q_case(net, n_rays, device, seed, S=8):
    """The int8 NeRF kernel: against its plain version (two measures, see
    TOL["int8"]) and against the bf16 kernel on the same inputs."""
    from pronerf_tpu_torch.kernels import fused_nerf as fn
    from pronerf_tpu_torch.kernels import fused_nerf_q as fq
    from pronerf_tpu_torch.models.pronerf import view_contribution
    from pronerf_tpu_torch.ops.encoding import positional_encoding

    packed = fq.pack_nerf_params_int8(net)
    packed_bf16 = fn.pack_nerf_params(net, torch.bfloat16)
    inp = nerf_inputs(n_rays, device, seed, S)
    vcon_t = view_contribution(
        net, positional_encoding(inp["dirs"], 4), torch.bfloat16).contiguous()
    pts = inp["pts24_t"]

    def kernel():
        return fq.fused_nerf_raw_tq(packed, pts, vcon_t, S)

    def plain():
        return torch.cat([
            fq.fused_nerf_raw_q_plain(
                packed, pts[:, i:i + CHUNK].contiguous(),
                vcon_t[:, i:i + CHUNK].contiguous(), S)
            for i in range(0, n_rays, CHUNK)
        ])

    def compare(tol):
        k, pl = kernel(), plain()
        if not bool(torch.isfinite(k).all()):
            raise SystemExit("fused_nerf_raw_tq: output is not finite")
        std = float(pl.std())
        diff = (k - pl).abs()
        bf = fn.fused_nerf_raw_t(packed_bf16, pts, vcon_t, S)
        gap, bstd = (k - bf).abs(), float(bf.std())
        return {
            "raw": (float(diff.max()), tol["max_over_std"] * std),
            "differing_share": (
                float((diff > tol["last_bits"] * std).float().mean()),
                tol["share"]),
            "max_vs_bf16": (float(gap.max()), 0.25 * bstd + 0.02),
            "mean_vs_bf16": (float(gap.mean()), 0.02 * bstd + 0.002),
        }

    work = {"int8": n_rays * S * (8 * 256 * 256 + 256 * 128 + 256 + 128 * 3),
            "bfloat16": n_rays * S * 2 * 63 * 256}
    nbytes = ((pts.numel() + vcon_t.numel()) * 4 + n_rays * S * 4 * 4
              + fq._blob(packed).numel())
    return kernel, plain, compare, work, nbytes


KERNELS = (
    # name, source, the TPU kernel it replaces
    ("fused_minmax_t[sampler]", "pronerf_tpu_torch/kernels/csrc/fused_minmax.cu",
     "pronerf_tpu/kernels/fused_minmax.py:125"),
    ("fused_minmax_t[refine]", "pronerf_tpu_torch/kernels/csrc/fused_minmax.cu",
     "pronerf_tpu/kernels/fused_minmax.py:125"),
    ("fused_nerf_raw_t", "pronerf_tpu_torch/kernels/csrc/fused_nerf.cu",
     "pronerf_tpu/kernels/fused_nerf.py:196"),
    ("fused_nerf_composite_t", "pronerf_tpu_torch/kernels/csrc/fused_nerf.cu",
     "pronerf_tpu/kernels/fused_nerf.py:302"),
    ("fused_nerf_raw_tq", "pronerf_tpu_torch/kernels/csrc/fused_nerf_q.cu",
     "pronerf_tpu/kernels/fused_nerf_q.py:351"),
    # the same kernels past their former limits, at shapes the release
    # configs do not reach: the refine net of 16 samples and 128 samples of
    # 4 views (layer 0 in 2 / 13 passes), 128 samples a ray (16 chunks of
    # results). The frame phase serves frames of 16 and of 128 samples a ray
    # through the same entry point, which launch them at these shapes.
    ("fused_minmax_t[refine,C=198]",
     "pronerf_tpu_torch/kernels/csrc/fused_minmax.cu",
     "pronerf_tpu/kernels/fused_minmax.py:125"),
    ("fused_minmax_t[refine,C=1542]",
     "pronerf_tpu_torch/kernels/csrc/fused_minmax.cu",
     "pronerf_tpu/kernels/fused_minmax.py:125"),
    ("fused_nerf_raw_t[S=128]", "pronerf_tpu_torch/kernels/csrc/fused_nerf.cu",
     "pronerf_tpu/kernels/fused_nerf.py:196"),
    ("fused_nerf_composite_t[S=128]",
     "pronerf_tpu_torch/kernels/csrc/fused_nerf.cu",
     "pronerf_tpu/kernels/fused_nerf.py:302"),
    ("fused_nerf_raw_tq[S=128]",
     "pronerf_tpu_torch/kernels/csrc/fused_nerf_q.cu",
     "pronerf_tpu/kernels/fused_nerf_q.py:351"),
    # the refine net of the headline bench's second serving point,
    # num_neighbor = 2 (C = 6 + 3 * 2 * 8 = 54: one layer-0 pass of 64
    # k-rows, half of its second k-slab zero padding), at a 504x378 frame's
    # rays and (below) a 1008x756 frame's; the frame phases serve frames of
    # 2 neighbours at both sizes
    ("fused_minmax_t[refine,C=54]",
     "pronerf_tpu_torch/kernels/csrc/fused_minmax.cu",
     "pronerf_tpu/kernels/fused_minmax.py:125"),
    # every kernel at the 762,048 rays of one 1008x756 frame (phase
    # fullres), the size the reference's engine serves
    ("fused_minmax_t[sampler,N=762048]",
     "pronerf_tpu_torch/kernels/csrc/fused_minmax.cu",
     "pronerf_tpu/kernels/fused_minmax.py:125"),
    ("fused_minmax_t[refine,N=762048]",
     "pronerf_tpu_torch/kernels/csrc/fused_minmax.cu",
     "pronerf_tpu/kernels/fused_minmax.py:125"),
    ("fused_nerf_raw_t[N=762048]",
     "pronerf_tpu_torch/kernels/csrc/fused_nerf.cu",
     "pronerf_tpu/kernels/fused_nerf.py:196"),
    ("fused_nerf_composite_t[N=762048]",
     "pronerf_tpu_torch/kernels/csrc/fused_nerf.cu",
     "pronerf_tpu/kernels/fused_nerf.py:302"),
    ("fused_nerf_raw_tq[N=762048]",
     "pronerf_tpu_torch/kernels/csrc/fused_nerf_q.cu",
     "pronerf_tpu/kernels/fused_nerf_q.py:351"),
    ("fused_minmax_t[refine,C=54,N=762048]",
     "pronerf_tpu_torch/kernels/csrc/fused_minmax.cu",
     "pronerf_tpu/kernels/fused_minmax.py:125"),
)
# the rows at a full-resolution frame's rays: the shape of the row they
# repeat, at FULL_RAYS / FRAME_RAYS (4) times the rays; their main path
# instantiation only
FULL = {"fused_minmax_t[sampler,N=762048]": "fused_minmax_t[sampler]",
        "fused_minmax_t[refine,N=762048]": "fused_minmax_t[refine]",
        "fused_nerf_raw_t[N=762048]": "fused_nerf_raw_t",
        "fused_nerf_composite_t[N=762048]": "fused_nerf_composite_t",
        "fused_nerf_raw_tq[N=762048]": "fused_nerf_raw_tq",
        "fused_minmax_t[refine,C=54,N=762048]": "fused_minmax_t[refine,C=54]"}
# the instantiations each kernel has; the first is the one its main path runs
DTYPES = {"fused_nerf_raw_tq": ("int8",), "fused_nerf_raw_tq[S=128]": ("int8",),
          "fused_minmax_t[refine,C=54]": ("bfloat16",),
          "fused_minmax_t[refine,C=198]": ("bfloat16",),
          "fused_minmax_t[refine,C=1542]": ("bfloat16",)} | {
              name: ("int8",) if base == "fused_nerf_raw_tq" else (
                  "bfloat16",) for name, base in FULL.items()}
BOTH = ("bfloat16", "float32")
TINY_TOO = ("fused_minmax_t[sampler]", "fused_minmax_t[refine]",
            "fused_nerf_raw_t", "fused_nerf_composite_t", "fused_nerf_raw_tq",
            "fused_minmax_t[refine,C=54]")
# the wide rows: (samples a ray, rays); a ray count that keeps them short
# (the num_neighbor = 2 refine net is a release shape: a frame's rays)
WIDE = {"fused_minmax_t[refine,C=54]": (8, FRAME_RAYS),
        "fused_minmax_t[refine,C=198]": (16, 16384),
        "fused_minmax_t[refine,C=1542]": (128, 16384),
        "fused_nerf_raw_t[S=128]": (128, 8192),
        "fused_nerf_composite_t[S=128]": (128, 8192),
        "fused_nerf_raw_tq[S=128]": (128, 8192)}
# the kernels on wgmma, by source: ptxas must neither serialize their products
# nor spill
WGMMA_KERNELS = {"fused_minmax": "minmax_wg_kernel",
                 "fused_nerf": "nerf_wg_kernel",
                 "fused_nerf_q": "nerf_q_wg_kernel"}
# opcodes of the conversion pipe (16 results a clock an SM): the int8
# kernel's epilogue is written without them, so its SASS may hold no more of
# them than the PE code it shares with the bf16 kernel's raw form. I2FP, the
# int -> float of this card, is not one of them: measured, it is cheaper than
# the integer-add form it would replace (PERF.md, PR 5).
CONVERSIONS = ("I2F", "F2I", "F2IP", "FRND", "I2I", "I2IP")


def wide_refine(S, views, device):
    """A refine net of ``S`` samples and ``views`` views, seeded."""
    from pronerf_tpu_torch.models.mlp import MinMaxMLP

    return MinMaxMLP(6, 256, 6 * S + 3 * views * S, 4 * S + 3, (),
                     torch.Generator().manual_seed(S * views), device)


def make_case(name, nets, n_rays, dtype, device, seed):
    name = FULL.get(name, name)
    if name == "fused_minmax_t[sampler]":
        return minmax_case(nets["sampler"], 48, 6, n_rays, dtype, device,
                           seed)
    if name == "fused_minmax_t[refine]":
        return minmax_case(nets["refine"], 8, 102, n_rays, dtype, device,
                           seed)
    if name.startswith("fused_minmax_t[refine,C="):
        C, S = int(name[len("fused_minmax_t[refine,C="):-1]), WIDE[name][0]
        views = (C - 6) // (3 * S)
        return minmax_case(wide_refine(S, views, device), S, C, n_rays,
                           dtype, device, seed)
    S = WIDE.get(name, (8,))[0]
    base = name.split("[")[0]
    if base == "fused_nerf_raw_tq":
        return nerf_q_case(nets["nerf"], n_rays, device, seed, S)
    kind = "raw" if base == "fused_nerf_raw_t" else "comp"
    return nerf_case(kind, nets["nerf"], n_rays, dtype, device, seed, S)


def wrappers():
    """The four kernel wrappers, each carrying its ``launches`` count."""
    from pronerf_tpu_torch.kernels import fused_minmax as fm
    from pronerf_tpu_torch.kernels import fused_nerf as fn
    from pronerf_tpu_torch.kernels import fused_nerf_q as fq

    return {
        "fused_minmax_t": fm.fused_minmax_t,
        "fused_nerf_raw_t": fn.fused_nerf_raw_t,
        "fused_nerf_composite_t": fn.fused_nerf_composite_t,
        "fused_nerf_raw_tq": fq.fused_nerf_raw_tq,
    }


def counter(name):
    return wrappers()[name.split("[")[0]]


def ptxas_report(log, kernel):
    """What ``ptxas -v`` said of the entry functions whose name holds
    ``kernel``: registers, stack, spills; and every line of the log that
    reports serialized ``wgmma`` products (C7510 to C7520; C7519 is kept apart
    as a note)."""
    funcs, current, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props and kernel in props:
            funcs.setdefault(props, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current and kernel in current:
            funcs.setdefault(current, {})["registers"] = int(m.group(1))
    flagged = [ln.strip() for ln in log.splitlines()
               if "wgmma" in ln and "serialized" in ln]
    return {
        "functions": funcs,
        "serialized": [ln for ln in flagged if "C7519" not in ln],
        "notes": [ln for ln in flagged if "C7519" in ln],
    }


def conversion_counts():
    """Conversion instructions in the SASS of the int8 kernel and of the bf16
    NeRF kernel's raw form; fails if the int8 kernel has more."""
    from pronerf_tpu_torch.kernels import build

    def count(source, kernel):
        funcs = build.sass_opcodes(build.lib_path(source), kernel)
        if len(funcs) != 1:
            raise SystemExit(f"SASS of {kernel}: functions {sorted(funcs)}")
        ops = next(iter(funcs.values()))
        return {op: ops[op] for op in CONVERSIONS if op in ops}

    got = {"nerf_q_wg_kernel": count("fused_nerf_q", "nerf_q_wg_kernel"),
           "nerf_wg_kernel<false>": count("fused_nerf", "nerf_wg_kernelILb0E")}
    if sum(got["nerf_q_wg_kernel"].values()) > sum(
            got["nerf_wg_kernel<false>"].values()):
        raise SystemExit(f"conversion instructions in the int8 kernel: {got}")
    return got


def check_build():
    """ptxas' report of the wgmma kernels; fails on a serialized product, a
    spill, or a kernel it did not report."""
    from pronerf_tpu_torch.kernels import build

    reports = {src: ptxas_report(build.ptxas_log(src), kernel)
               for src, kernel in WGMMA_KERNELS.items()}
    bad = {src: r for src, r in reports.items()
           if not r["functions"] or r["serialized"]
           or any(f.get("spill_stores", 1) or f.get("spill_loads", 1)
                  for f in r["functions"].values())}
    if bad:
        say({"ptxas": reports})
        raise SystemExit(f"ptxas serialized, spilled or did not report: "
                         f"{sorted(bad)}")
    return reports


@torch.no_grad()
def phase_kernels(device, n_rays):
    nets = make_nets(0, device)
    rows = []
    for name, source, replaces in KERNELS:
        rays = min(n_rays, WIDE[name][1]) if name in WIDE else n_rays
        if name in FULL:
            rays = n_rays * (FULL_RAYS // FRAME_RAYS)
        for dname in DTYPES.get(name, BOTH):
            dtype = getattr(torch, dname)
            tol = TOL[dname]
            before = counter(name).launches
            # the ragged count first: a short run that also checks the mask
            _, _, compare_r, _, _ = make_case(
                name, nets, RAGGED if rays > RAGGED else rays - 37,
                dtype, device, seed=1)
            errs = {f"ragged_{k}": v for k, v in compare_r(tol).items()}
            if name in TINY_TOO and rays > TINY:
                _, _, compare_t, _, _ = make_case(
                    name, nets, TINY, dtype, device, seed=3)
                errs |= {f"tiny_{k}": v for k, v in compare_t(tol).items()}
            kernel, plain, compare, work, nbytes = make_case(
                name, nets, rays, dtype, device, seed=2)
            errs.update(compare(tol))
            torch.cuda.synchronize()
            ms = cuda_ms(kernel, 5)
            plain_ms = cuda_ms(plain, 2)
            if not isinstance(work, dict):  # multiply-adds, by operand type
                work = {dname: work}
            bound_ops = sum(2 * macs / PEAK_FLOPS[d] * 1e3
                            for d, macs in work.items())
            bound_bytes = nbytes / PEAK_BYTES_S * 1e3
            row = {
                "name": name, "dtype": dname, "route": "cuda",
                "source": source, "replaces": replaces, "rays": rays,
                # measures that are not absolute errors against the plain
                # version (disp relative to its size, the int8 kernel's
                # share and its distance to the bf16 kernel) are listed in
                # errs/tols only
                "max_abs_err": max(e for k, (e, _) in errs.items()
                                   if not k.endswith(NOT_ABS)),
                "tol": max(t for k, (_, t) in errs.items()
                           if not k.endswith(NOT_ABS)),
                "errs": {k: e for k, (e, _) in errs.items()},
                "tols": {k: t for k, (_, t) in errs.items()},
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(bound_ops, bound_bytes),
                "bound_by": "operations" if bound_ops >= bound_bytes
                else "bytes",
                "library_ms": None,
                "launches": counter(name).launches - before,
            }
            rows.append(row)
            bad = {k: (e, t) for k, (e, t) in errs.items()
                   if not (e <= t)}  # a NaN fails too
            if bad:
                say({"kernels": rows})
                raise SystemExit(f"{name} [{dname}] disagrees with its "
                                 f"plain version: {bad}")
    say({"kernels": rows})
    return rows


# ------------------------------------------------------- frame phase ------

MINMAX_WIDTH = {"fused_minmax_t[sampler]": 6, "fused_minmax_t[refine]": 102,
                "fused_minmax_t[refine,C=54]": 54,
                "fused_minmax_t[refine,C=198]": 198,
                "fused_minmax_t[refine,C=1542]": 1542}
# the NeRF kernels' rows at 128 samples a ray, counted by the wrappers'
# launches by samples
NERF_SAMPLES = {"fused_nerf_raw_t[S=128]": ("fused_nerf_raw_t", 128),
                "fused_nerf_composite_t[S=128]": ("fused_nerf_composite_t",
                                                  128),
                "fused_nerf_raw_tq[S=128]": ("fused_nerf_raw_tq", 128)}
UNTRANSPOSED = "fused_minmax_t[transpose_out=False]"


def reset_counters():
    w = wrappers()
    for fn in w.values():
        fn.launches = 0
    for name in ("fused_nerf_raw_t", "fused_nerf_composite_t",
                 "fused_nerf_raw_tq"):
        w[name].launches_by_samples.clear()
    w["fused_minmax_t"].launches_by_width.clear()
    w["fused_minmax_t"].launches_untransposed.clear()


def read_counters():
    """Launches since the last reset, by the names of ``KERNELS``: the
    MinMax shapes from the wrapper's count by input width (a width of no
    row fails), each NeRF kernel's launches at any S under its own name and
    at S = 128 under its wide row's, and the MinMax kernel's launches with
    ``transpose_out=False`` (all widths together) under their own name."""
    w = wrappers()
    by_width = w["fused_minmax_t"].launches_by_width
    counts = {name: by_width.get(c, 0) for name, c in MINMAX_WIDTH.items()}
    if sum(counts.values()) != w["fused_minmax_t"].launches:
        raise SystemExit(f"fused_minmax_t counted {w['fused_minmax_t'].launches}"
                         f" launches, by width {by_width}")
    for name in ("fused_nerf_raw_t", "fused_nerf_composite_t",
                 "fused_nerf_raw_tq"):
        counts[name] = w[name].launches
        if sum(w[name].launches_by_samples.values()) != counts[name]:
            raise SystemExit(f"{name} counted {counts[name]} launches, by "
                             f"samples {w[name].launches_by_samples}")
    for name, (fn, S) in NERF_SAMPLES.items():
        counts[name] = w[fn].launches_by_samples.get(S, 0)
    counts[UNTRANSPOSED] = sum(
        w["fused_minmax_t"].launches_untransposed.values())
    return counts


def expect_counts(what, counts, **want):
    """Fail unless the counters read ``want`` (kernels not named: 0)."""
    full = dict.fromkeys(counts, 0) | {
        {"sampler": "fused_minmax_t[sampler]",
         "refine": "fused_minmax_t[refine]",
         "untransposed": UNTRANSPOSED}.get(k, k): v for k, v in want.items()}
    if counts != full:
        raise SystemExit(f"{what}: launch counters {counts}, expected {full}")


def rel_errs(got, ref, bound, keys=NINE_KEYS):
    """Per key: the largest difference, the largest size of the reference,
    their ratio, the share of elements that differ by more than ``bound``
    times that size, and the share that is NaN on one side only (disp of an
    empty ray is NaN on both, and is left out)."""
    rows = {}
    for k in keys:
        g, r = got[k].float(), ref[k].float()
        gn, rn = torch.isnan(g), torch.isnan(r)
        d = torch.where(gn | rn, torch.zeros_like(g), (g - r).abs())
        size = float(torch.where(rn, torch.zeros_like(r), r.abs()).max())
        err = float(d.max())
        rows[k] = {
            "err": err, "size": size,
            "rel": err / size if size > 0 else float("nan"),
            "share_over": float((d > bound * size).float().mean()),
            "share_nan_one_side": float((gn ^ rn).float().mean()),
        }
    return rows


def hold(what, rows, bound, share=0.0):
    """Fail unless every key has a reference of non-zero size and at most
    ``share`` of its elements differ by more than ``bound`` times it."""
    bad = {k: v for k, v in rows.items()
           if not (v["size"] > 0 and v["share_over"] <= share
                   and v["share_nan_one_side"] <= share)}
    if bad:
        raise SystemExit(f"{what}: over {bound} of the reference's size on "
                         f"more than {share:.2%} of elements: {bad}")


def bulk_and_tail(what, got, ref,
                  keys=("rgb1", "rgb0", "mm_rgb", "depth", "acc", "depth0")):
    """The transposed graph's bounds against the row-major one: the 99th
    percentile of the difference and the share over the tail bound."""
    rows = {}
    for k in keys:
        d = (got[k].float() - ref[k].float()).abs().flatten()
        rows[k] = {"p99": float(torch.quantile(d, 0.99)),
                   "share_over_tail": float(
                       (d > TRANSPOSED_TAIL).float().mean())}
    bad = {k: v for k, v in rows.items()
           if not (v["p99"] < TRANSPOSED_BULK
                   and v["share_over_tail"] < TRANSPOSED_TAIL_SHARE)}
    if bad:
        raise SystemExit(f"{what}: {bad}")
    return rows


def all_finite(result_arrays):
    for k, v in result_arrays.items():
        a = v if isinstance(v, np.ndarray) else v.detach().cpu().numpy()
        if not np.all(np.isfinite(a)):
            raise SystemExit(f"frame output {k} is not finite")


def profile_frames(render, frames):
    """Device time by kernel name over ``frames`` calls of ``render`` (a
    frame or a training step; torch.profiler). The profiler slows the host
    down, so the call's own time is taken elsewhere, without it."""
    from torch.profiler import ProfilerActivity, profile

    render()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            render()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3 / frames, e.count // frames)
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    # the launches of the MinMax kernel (sampler, refine, sampler, ...) and of
    # the int8 NeRF kernel one by one
    def launches(part):
        return [e.device_time_total / 1e3 for e in prof.events()
                if e.device_type.name == "CUDA" and part in e.name]

    return {
        "frames": frames,
        "device_busy_ms_per_frame": busy,
        "device_kernels_per_frame": sum(r[2] for r in rows),
        "minmax_launch_ms": launches("minmax"),
        "nerf_q_launch_ms": launches("nerf_q"),
        "top": [{"kernel": k[:80], "ms_per_frame": ms, "calls_per_frame": n}
                for k, ms, n in rows[:14]],
    }


def steady_frames(reps):
    """Frames that ``render_path``'s steady-state timing adds to a drive's
    launches on the card: a CUDA graph of ``max(2, min(reps, 6))`` frames,
    warmed up once and captured once (a replay calls no wrapper)."""
    return 2 * max(2, min(reps, 6)) if reps > 0 else 0


def serve(what, cfg, reps, shape=(H, W_IMG)):
    """One drive of the serving entry point: counters zeroed just before,
    read just after; the frames must be finite and of the frame's shape.
    ``frames`` counts the frames whose kernels were launched from Python:
    a warm-up and ``reps`` timed frames a pose, and the steady-state
    graph's (``steady_frames``)."""
    from pronerf_tpu_torch.render import infer

    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = infer.run_inference(cfg, timing_reps=reps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counters()
    n_poses = len(result["rgbs1"])
    all_finite({k: result[k] for k in ("rgbs1", "rgbs0", "depths")})
    if result["rgbs1"].shape != (n_poses, *shape, 3):
        raise SystemExit(f"{what}: frame shape {result['rgbs1'].shape}")
    if not all(np.isfinite(result["psnrs"])):
        raise SystemExit(f"{what}: PSNRs {result['psnrs']}")
    return {"result": result, "counts": counts, "wall_s": wall,
            "frames": n_poses * (1 + reps) + steady_frames(reps),
            "poses": n_poses,
            "ms_per_frame": statistics.median(result["times_ms"]),
            "steady_ms_per_frame": result["amortized_ms"],
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def first_frame(drive, device):
    """The whole frame of the first pose, as run_inference returned it."""
    return {k: torch.from_numpy(drive["result"][r][0]).to(device)
            for k, r in (("rgb1", "rgbs1"), ("rgb0", "rgbs0"),
                         ("depth", "depths"))}


@torch.no_grad()
def phase_frame(device, profile=False):
    from pronerf_tpu_torch.config import Config
    from pronerf_tpu_torch.kernels import fused_minmax as fm
    from pronerf_tpu_torch.models.pronerf import render_rays
    from pronerf_tpu_torch.models.pronerf_t import render_rays_t
    from pronerf_tpu_torch.render import infer
    from pronerf_tpu_torch.render.raygen import prepare_scene, rays_for_pose
    from pronerf_tpu_torch.render.renderer import make_frame_renderer

    reps = 3
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg = Config.from_file(
            ROOT / "configs/llff/fern/fern_trt.txt",
            datadir=f"synthetic:{W_IMG}x{H}x{N_VIEWS}", use_trt=True,
            tile_rays=0, use_pallas=True, basedir=tmp, ft_path="",
        )
        # ---- the server answers a few requests, three ways: raw kernel +
        # composite op; the int8 NeRF kernel; the transposed graph
        main = serve("default graph", cfg, reps)
        expect_counts("default graph", main["counts"], sampler=main["frames"],
                      refine=main["frames"], fused_nerf_raw_t=main["frames"])
        quant = serve("quant=int8", cfg.replace(quant="int8"), reps)
        expect_counts("quant=int8", quant["counts"], sampler=quant["frames"],
                      refine=quant["frames"],
                      fused_nerf_raw_tq=quant["frames"])
        trans = serve("transposed=True", cfg.replace(transposed=True), reps)
        expect_counts("transposed=True", trans["counts"],
                      sampler=trans["frames"], refine=trans["frames"],
                      untransposed=2 * trans["frames"],
                      fused_nerf_composite_t=trans["frames"])

        # ---- the same server at shapes the kernels did not take before this
        # port lifted their limits: 16 samples a ray (the refine net's input
        # C = 6 + 3 * 4 * 16 = 198) in the default graph, 128 (C = 1542, the
        # NeRF kernels at S = 128) in the default graph, the int8 one and the
        # transposed one, each answering every test pose once more after the
        # first. A MinMax head too large for the kernel's shared memory (the
        # sampler's 3 S + 3 and the refine net's 4 S + 3 rows at S = 128)
        # runs in parts, one launch each (fused_minmax.head_parts). And the
        # headline bench's second serving point, 2 neighbours (the refine
        # net's C = 6 + 3 * 2 * 8 = 54), in the default graph.
        def launches_a_frame(C, n_out):
            return len(fm.head_parts(C, cfg.mmnetdepth, -(-n_out // 8) * 8))

        wide = {}
        for S, what, over, kernels in (
                (16, "N_samples=16", {},
                 {"fused_minmax_t[refine,C=198]": None,
                  "fused_nerf_raw_t": 1}),
                (128, "N_samples=128", {},
                 {"fused_minmax_t[refine,C=1542]": None,
                  "fused_nerf_raw_t": 1, "fused_nerf_raw_t[S=128]": 1}),
                (128, "N_samples=128,quant=int8", {"quant": "int8"},
                 {"fused_minmax_t[refine,C=1542]": None,
                  "fused_nerf_raw_tq": 1, "fused_nerf_raw_tq[S=128]": 1}),
                (128, "N_samples=128,transposed=True", {"transposed": True},
                 {"fused_minmax_t[refine,C=1542]": None,
                  "fused_nerf_composite_t": 1,
                  "fused_nerf_composite_t[S=128]": 1}),
                (8, "num_neighbor=2", {"num_neighbor": 2},
                 {"fused_minmax_t[refine,C=54]": None,
                  "fused_nerf_raw_t": 1})):
            drive = serve(what, cfg.replace(N_samples=S, **over), 1)
            sampler = launches_a_frame(6, 3 * S + 3)
            views = over.get("num_neighbor", cfg.num_neighbor)
            refine = launches_a_frame(6 + 3 * views * S, 4 * S + 3)
            want = {k: refine if n is None else n for k, n in kernels.items()}
            if over.get("transposed"):
                want["untransposed"] = sampler + refine
            expect_counts(what, drive["counts"],
                          **{k: n * drive["frames"] for k, n in
                             (want | {"sampler": sampler}).items()})
            wide[what] = drive

        # ---- the default graph's frame with the composite fused into the
        # kernel
        data = infer.load_inference_data(cfg)
        params = infer._load_params(cfg, infer.setup_expdir(cfg), device)
        scene = prepare_scene(
            data["images"][data["i_ref"]], data["poses"][data["i_ref"]],
            data["K"], pack_corners="u8", device=device)
        statics = infer._infer_statics(cfg, use_bf16=True)
        fused = dataclasses.replace(statics, fuse_composite=True)
        statics_q = dataclasses.replace(statics, quant="int8")
        statics_t = dataclasses.replace(statics, transposed=True)
        c2w = data["poses"][data["i_test"][0]][:3, :4]
        renderer = make_frame_renderer(fused, H, W_IMG, data["K"], 0,
                                       device=device)
        reset_counters()
        out_f = renderer(params, scene, c2w)
        torch.cuda.synchronize()
        counts_f = read_counters()
        all_finite(out_f)
        expect_counts("fused composite", counts_f, sampler=1, refine=1,
                      fused_nerf_composite_t=1)
        ms_fused = cuda_ms(lambda: renderer(params, scene, c2w), reps)
        frame_raw = first_frame(main, device)
        forms_frame = rel_errs(out_f, frame_raw, FORMS_REL, tuple(frame_raw))
        hold("composite forms, whole frame", forms_frame, FORMS_REL)

        # ---- whole frames of the new paths against the default graph's:
        # the JAX package's int8 bounds, the transposed graph's bulk and tail
        frame_q = first_frame(quant, device)
        frame_t = first_frame(trans, device)
        mse = float(((frame_q["rgb1"].double() - frame_raw["rgb1"].double())
                     ** 2).mean())
        quant_frame = {
            "psnr_rgb1_db": -10.0 * float(np.log10(max(mse, 1e-12))),
            "depth_max_abs": max_err(frame_q["depth"], frame_raw["depth"]),
        }
        if not (quant_frame["psnr_rgb1_db"] > QUANT_PSNR_DB
                and quant_frame["depth_max_abs"] <= QUANT_DEPTH):
            raise SystemExit(
                f"int8 frame against the bf16 frame: {quant_frame}")
        trans_frame = bulk_and_tail(
            "transposed frame against the row-major frame", frame_t, out_f,
            tuple(frame_t))

        # ---- a tile of the frame's rays, all nine outputs: both composite
        # forms against each other and against the kernel-free bf16 path
        rays = rays_for_pose(H, W_IMG, data["K"], c2w, device=device)
        lo = (H // 2) * W_IMG
        tile = {k: v[lo:lo + CHUNK].contiguous() for k, v in rays.items()}
        controls = {"target_t": torch.as_tensor(
            c2w[:3, 3], dtype=torch.float32, device=device)}
        with_k = render_rays(params, tile, scene, controls, statics)
        with_kf = render_rays(params, tile, scene, controls, fused)
        without = render_rays(
            params, tile, scene, controls,
            dataclasses.replace(statics, use_kernels=False))
        forms_tile = rel_errs(with_kf, with_k, FORMS_REL)
        hold("composite forms, tile", forms_tile, FORMS_REL)
        keys = tuple(k for k in NINE_KEYS if k != "sigma")
        paths = {"raw": rel_errs(with_k, without, PATHS_REL, keys),
                 "fused": rel_errs(with_kf, without, PATHS_REL, keys)}
        for form, rows in paths.items():
            hold(f"kernel path ({form}) against kernel-free bf16 path", rows,
                 PATHS_REL)
        # the int8 path against the bf16 kernel path, and the transposed
        # graph against the row-major one (both end in the fused composite)
        from pronerf_tpu_torch.kernels.fused_nerf_q import (
            pack_nerf_params_int8,
        )

        params_q = dict(params,
                        nerf_packed_q=pack_nerf_params_int8(params["nerf"]))
        with_q = render_rays(params_q, tile, scene, controls, statics_q)
        quant_tile = rel_errs(with_q, with_k, QUANT_REL)
        hold("int8 path against the bf16 kernel path", quant_tile, QUANT_REL,
             PLAIN_SHARE)
        with_t = render_rays_t(params, tile, scene, controls, statics_t)
        trans_tile = rel_errs(with_t, with_kf, PLAIN_REL)
        hold("transposed graph against the row-major graph", trans_tile,
             PLAIN_REL, PLAIN_SHARE)
        bulk_and_tail("transposed graph against the row-major graph, tile",
                      with_t, with_kf)
        # ... and against the same code on CPU tensors, where every wrapper
        # takes its plain version: the kernels at the inputs the frame gives
        # them, sigma included. The int8 panels are carried over, so the
        # comparison is of the kernels, not of two calibrations.
        cpu = torch.device("cpu")
        params_cpu = {k: copy.deepcopy(m).to(cpu) for k, m in params.items()}
        params_cpu_q = dict(params_cpu, nerf_packed_q={
            k: v.to(cpu) for k, v in params_q["nerf_packed_q"].items()
            if not k.startswith("_")})
        tile_cpu = {k: v.to(cpu) for k, v in tile.items()}
        scene_cpu = prepare_scene(
            data["images"][data["i_ref"]], data["poses"][data["i_ref"]],
            data["K"], pack_corners="u8", device=cpu)
        controls_cpu = {k: v.to(cpu) for k, v in controls.items()}

        def on_cpu(fn, prm, st):
            out = fn(prm, tile_cpu, scene_cpu, controls_cpu, st)
            return {k: v.to(device) for k, v in out.items()}

        cpu_k = on_cpu(render_rays, params_cpu, statics)
        plain = {
            "raw": rel_errs(with_k, cpu_k, PLAIN_REL),
            "fused": rel_errs(with_kf, cpu_k, PLAIN_REL),
            "int8": rel_errs(
                with_q, on_cpu(render_rays, params_cpu_q, statics_q),
                PLAIN_REL),
            "transposed": rel_errs(
                with_t, on_cpu(render_rays_t, params_cpu, statics_t),
                PLAIN_REL),
        }
        for form, rows in plain.items():
            hold(f"kernel path ({form}) against the plain versions on the "
                 "CPU", rows, PLAIN_REL, PLAIN_SHARE)

        if profile:
            say({"profile": {"path": "fused composite"} | profile_frames(
                lambda: renderer(params, scene, c2w), 3)})
            for path, st in (("quant=int8", statics_q),
                             ("transposed=True", statics_t)):
                render = make_frame_renderer(st, H, W_IMG, data["K"], 0,
                                             device=device)
                say({"profile": {"path": path} | profile_frames(
                    lambda: render(params, scene, c2w), 3)})

    say({
        "frame": {
            "H": H, "W": W_IMG, "views": N_VIEWS, "poses": main["poses"],
            "frames_rendered": main["frames"],
            "ms_per_frame": main["ms_per_frame"],
            "ms_per_frame_fused_composite": ms_fused,
            "ms_per_frame_int8": quant["ms_per_frame"],
            "ms_per_frame_transposed": trans["ms_per_frame"],
            "run_inference_wall_s": {
                "default": main["wall_s"], "int8": quant["wall_s"],
                "transposed": trans["wall_s"]},
            "psnr": main["result"]["psnrs"],
            "launches": main["counts"], "launches_fused_composite": counts_f,
            "launches_int8": quant["counts"],
            "launches_transposed": trans["counts"],
            "wide": {what: {"frames_rendered": d["frames"],
                            "ms_per_frame": d["ms_per_frame"],
                            "run_inference_wall_s": d["wall_s"],
                            "launches": d["counts"]}
                     for what, d in wide.items()},
            "composite_forms_frame": forms_frame,
            "composite_forms_tile": forms_tile, "forms_rel_tol": FORMS_REL,
            "kernel_vs_kernel_free_bf16_tile": paths,
            "paths_rel_tol": PATHS_REL,
            "int8_vs_bf16_frame": quant_frame,
            "int8_vs_bf16_tile": quant_tile, "quant_rel_tol": QUANT_REL,
            "transposed_vs_row_major_frame": trans_frame,
            "transposed_vs_row_major_tile": trans_tile,
            "kernel_vs_plain_versions_on_cpu_tile": plain,
            "plain_rel_tol": PLAIN_REL, "plain_share": PLAIN_SHARE,
        }
    })
    # launches on each kernel's main-path drive: the default graph's for the
    # MinMax shapes and the raw kernel, the fuse_composite frame for the
    # composite kernel, the int8 drive for the int8 kernel, the transposed
    # drive for the MinMax kernel's untransposed form; the wide rows' on the
    # drives of 16 and 128 samples a ray, the C = 54 row's on the drive of 2
    # neighbours
    w16, w128 = wide["N_samples=16"], wide["N_samples=128"]
    return {
        "fused_minmax_t[sampler]": main["counts"]["fused_minmax_t[sampler]"],
        "fused_minmax_t[refine]": main["counts"]["fused_minmax_t[refine]"],
        "fused_nerf_raw_t": main["counts"]["fused_nerf_raw_t"],
        "fused_nerf_composite_t": counts_f["fused_nerf_composite_t"],
        "fused_nerf_raw_tq": quant["counts"]["fused_nerf_raw_tq"],
        UNTRANSPOSED: trans["counts"][UNTRANSPOSED],
        "fused_minmax_t[refine,C=54]": wide["num_neighbor=2"]["counts"][
            "fused_minmax_t[refine,C=54]"],
        "fused_minmax_t[refine,C=198]":
            w16["counts"]["fused_minmax_t[refine,C=198]"],
        "fused_minmax_t[refine,C=1542]":
            w128["counts"]["fused_minmax_t[refine,C=1542]"],
        "fused_nerf_raw_t[S=128]": w128["counts"]["fused_nerf_raw_t[S=128]"],
        "fused_nerf_composite_t[S=128]": wide["N_samples=128,transposed=True"][
            "counts"]["fused_nerf_composite_t[S=128]"],
        "fused_nerf_raw_tq[S=128]": wide["N_samples=128,quant=int8"][
            "counts"]["fused_nerf_raw_tq[S=128]"],
    }


# ----------------------------------------------------- fullres phase ------

FULL_REPS = 3        # timed frames a pose after its warm-up frame: 9 in all
# the JAX package's resolution of gather_tiles = -1 at 1008x756 with the
# whole frame in one call (render.renderer.resolve_gather_statics): 8 ray
# tiles, windows of 198 source rows
FULL_GATHER = (8, 198)
FRAME_KEYS = ("rgb1", "rgb0", "depth", "mm_rgb", "depth0")


def event_ms(fn) -> float:
    """One call of ``fn`` in ms by CUDA events."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def drive_renderer(render, params, scene, poses, reps=FULL_REPS):
    """Frames of one form through its frame renderer, timed as
    ``run_inference`` times them: each pose once (its warm-up), then
    ``reps`` times by CUDA events. Counters zeroed just before and read just
    after; peak memory over the drive."""
    reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, first = [], None
    for c2w in poses:
        out = render(params, scene, c2w)
        first = out if first is None else first
        for _ in range(reps):
            times.append(event_ms(lambda: render(params, scene, c2w)))
    torch.cuda.synchronize()
    counts = read_counters()
    all_finite({k: v for k, v in first.items()})
    return {"first": first, "counts": counts,
            "frames": len(poses) * (1 + reps),
            "ms_per_frame": statistics.median(times), "ms_all": times,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def frame_depths(params, rays, statics):
    """The candidate 3D depths of ``rays`` as ``render_rays`` computes them
    before its gather (sampler kernel, stable sort, NDC to 3D), so that the
    gathers can be held against each other on a frame's own points."""
    from pronerf_tpu_torch.kernels.fused_minmax import fused_minmax_t
    from pronerf_tpu_torch.ops.encoding import plucker
    from pronerf_tpu_torch.ops.sampling import ndc_to_3d_depth

    S = statics.N_samples
    sig_t = plucker(rays["ndc_o"], rays["ndc_d"]).T.contiguous()
    mm = fused_minmax_t(params["sampler_packed"], sig_t)[:, :S]
    depth = torch.sigmoid(mm) * (statics.far - statics.near) + statics.near
    depth = torch.sort(depth, dim=-1, stable=True)[0]
    return ndc_to_3d_depth(depth, statics.ndc_eps)


def nan_equal(a, b) -> bool:
    return torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def window_readings(scene, rays, z3d, nearest, n_tiles, window_rows):
    """The gathers on one frame's own points: the share of points the
    windows miss (valid unwindowed, invalid windowed), and the forms held
    against each other: no point valid only windowed, the windowed colours
    equal to the unwindowed ones wherever the window hits, the transposed
    emit and the split fetch equal to the row form bit for bit, the
    transposed graph's windowed gather against the row form: its projection
    is written out as scalar products, so the lerp weights differ in the
    last bits (colours by ~1e-7) and a point on a pixel or image border may
    flip; at most PLAIN_SHARE of the points may change validity or differ
    by more than 1e-5. Also each gather's ms (median of 5 by CUDA events,
    bf16 emit as served)."""
    from pronerf_tpu_torch.ops import warp

    args = (scene["images"], scene["fused_mats"], scene["K"], nearest,
            rays["or_o"], rays["or_d"], z3d)
    full = warp.epipolar_colors_shared(*args)
    win = warp.epipolar_colors_shared_windowed(*args, n_tiles, window_rows)
    V, S = win.shape[1:3]
    valid_full, valid_win = full.sum(-1) > 0, win.sum(-1) > 0
    missed = valid_full & ~valid_win
    t_emit = warp.epipolar_colors_shared_windowed(
        *args, n_tiles, window_rows, transposed_out=True)
    split = warp.epipolar_colors_shared_windowed(
        *args, n_tiles, window_rows, split=True)
    graph_t = warp.epipolar_colors_shared_t(
        scene["images"], scene["fused_mats"], scene["K"], nearest,
        rays["or_o"].T.contiguous(), rays["or_d"].T.contiguous(),
        z3d.T.contiguous(), n_tiles=n_tiles, window_rows=window_rows)
    win_t = win.permute(1, 3, 2, 0)  # [V, 3, S, N], the graph's layout
    graph_diff = (graph_t - win_t).abs()
    readings = {
        "points": missed.numel(),
        "share_invalid_unwindowed": float((~valid_full).float().mean()),
        "share_missed": float(missed.float().mean()),
        "share_of_valid_missed": float(missed.sum() / valid_full.sum()),
        "share_rays_with_a_miss": float(missed.any(2).any(1).float().mean()),
        "points_valid_only_windowed": int((valid_win & ~valid_full).sum()),
        "hit_colours_equal": torch.equal(win[valid_win], full[valid_win]),
        "transposed_emit_equal": torch.equal(
            t_emit, win.permute(1, 2, 3, 0).reshape(V, S * 3, -1)),
        "split_equal": torch.equal(split, win),
        "transposed_graph_share_not_bit_equal": float(
            (graph_diff > 0).float().mean()),
        "transposed_graph_share_over_1e-5": float(
            (graph_diff > 1e-5).float().mean()),
        "transposed_graph_max_diff": float(graph_diff.max()),
        "transposed_graph_share_validity_differing": float(
            ((graph_t.sum(1) > 0) != (win_t.sum(1) > 0)).float().mean()),
    }
    del t_emit, split, graph_t, win_t, graph_diff
    bf16 = {"out_dtype": torch.bfloat16}
    readings["gather_ms"] = {
        "unwindowed": cuda_ms(
            lambda: warp.epipolar_colors_shared(*args, **bf16), 5),
        "windowed": cuda_ms(lambda: warp.epipolar_colors_shared_windowed(
            *args, n_tiles, window_rows, **bf16), 5),
    }
    if not (readings["points_valid_only_windowed"] == 0
            and readings["hit_colours_equal"]
            and readings["transposed_emit_equal"] and readings["split_equal"]
            and readings["transposed_graph_share_over_1e-5"] <= PLAIN_SHARE
            and readings["transposed_graph_share_validity_differing"]
            <= PLAIN_SHARE):
        raise SystemExit(f"windowed gather at {FULL_W}x{FULL_H}: {readings}")
    return readings, missed.any(2).any(1)


@contextlib.contextmanager
def plain_versions():
    """The default graph's kernel wrappers (the MinMax and the raw NeRF
    kernel) replaced by their plain versions, run on the card over tiles of
    CHUNK rays (for memory), as the kernel phase runs them: a frame rendered
    inside is the same frame with the plain versions, and launches no
    kernel."""
    from pronerf_tpu_torch.kernels import fused_minmax as fm
    from pronerf_tpu_torch.kernels import fused_nerf as fn

    def minmax(packed, x_t, transpose_out=True):
        return torch.cat([
            fm.fused_minmax_plain(packed, x_t[:, i:i + CHUNK].contiguous(),
                                  transpose_out)
            for i in range(0, x_t.shape[1], CHUNK)],
            dim=0 if transpose_out else 1)

    def raw(packed, pts24_t, vcon_t, n_samples=8):
        return torch.cat([
            fn.fused_nerf_raw_plain(packed, pts24_t[:, i:i + CHUNK]
                                    .contiguous(),
                                    vcon_t[:, i:i + CHUNK].contiguous(),
                                    n_samples)
            for i in range(0, pts24_t.shape[1], CHUNK)])

    kept = fm.fused_minmax_t, fn.fused_nerf_raw_t
    fm.fused_minmax_t, fn.fused_nerf_raw_t = minmax, raw
    try:
        yield
    finally:
        fm.fused_minmax_t, fn.fused_nerf_raw_t = kept


@torch.no_grad()
def fullres_two_neighbours(cfg, scene, K, poses, device):
    """The headline bench's second serving point: 1008x756 frames of 2
    neighbours (the refine net's C = 6 + 3 * 2 * 8 = 54), windowed as the
    JAX rule resolves it, through the frame renderer: ms a frame and
    launches as the other forms (``drive_renderer``), device busy ms and
    kernels a frame (profiler, 3 frames), peak memory; the first pose's
    frame held against the same frame with the plain versions on the card
    (``plain_versions``: no kernel launched), every key, PLAIN_REL on at
    least 1 - PLAIN_SHARE of its elements."""
    from pronerf_tpu_torch.render import infer
    from pronerf_tpu_torch.render.renderer import make_frame_renderer

    cfg2 = cfg.replace(num_neighbor=2)
    params = infer._load_params(cfg2, infer.setup_expdir(cfg2), device)
    render = make_frame_renderer(infer._infer_statics(cfg2, use_bf16=True),
                                 FULL_H, FULL_W, K, 0, device=device)
    st = render.statics
    windows = [st.gather_tiles, st.gather_window_rows]
    if st.num_neighbor != 2 or windows != list(FULL_GATHER):
        raise SystemExit(f"fullres num_neighbor=2: statics {st}")
    drive = drive_renderer(render, params, scene, poses)
    n = drive["frames"]
    expect_counts("fullres num_neighbor=2", drive["counts"], sampler=n,
                  fused_nerf_raw_t=n, **{"fused_minmax_t[refine,C=54]": n})
    torch.cuda.empty_cache()
    prof = profile_frames(lambda: render(params, scene, poses[0]), 3)
    reset_counters()
    with plain_versions():
        plain = render(params, scene, poses[0])
    torch.cuda.synchronize()
    expect_counts("fullres num_neighbor=2 with the plain versions",
                  read_counters())
    errs = rel_errs(drive["first"], plain, PLAIN_REL, FRAME_KEYS)
    hold("fullres num_neighbor=2 frame against the plain versions", errs,
         PLAIN_REL, PLAIN_SHARE)
    del plain
    torch.cuda.empty_cache()
    return {"statics_windows": windows,
            "refine_kernel_rows": render.pack(params)["refine_packed"][
                "w0_t"].shape[1],
            "frames": n, "ms_per_frame": drive["ms_per_frame"],
            "ms_all": drive["ms_all"],
            "device_busy_ms_per_frame": prof["device_busy_ms_per_frame"],
            "kernels_per_frame": prof["device_kernels_per_frame"],
            "top": prof["top"][:8],
            "peak_mem_bytes": drive["peak_mem_bytes"],
            "launches": drive["counts"], "vs_plain_versions": errs}


@torch.no_grad()
def phase_fullres(device, profile=False):
    """The serving path at 1008x756 (the reference engine's frame): the
    default (windowed) form through ``run_inference``, then the unwindowed,
    transposed and int8 forms and a split frame through the frame renderer,
    each timed, counted and measured; the gathers on the frame's own
    points; the frames held against each other; a tile against the
    kernel-free bf16 path and the plain versions on the CPU."""
    from pronerf_tpu_torch.config import Config
    from pronerf_tpu_torch.kernels.packing import pack_serving_params
    from pronerf_tpu_torch.models.pronerf import _nearest_views, render_rays
    from pronerf_tpu_torch.render import infer
    from pronerf_tpu_torch.render.raygen import prepare_scene, rays_for_pose
    from pronerf_tpu_torch.render.renderer import (
        make_frame_renderer,
        resolve_gather_statics,
    )

    shape = (FULL_H, FULL_W)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fullres_") as tmp:
        cfg = Config.from_file(
            ROOT / "configs/llff/fern/fern_trt.txt",
            datadir=f"synthetic:{FULL_W}x{FULL_H}x{N_VIEWS}", use_trt=True,
            tile_rays=0, use_pallas=True, basedir=tmp, ft_path="",
        )
        statics = infer._infer_statics(cfg, use_bf16=True)
        resolved = resolve_gather_statics(statics, *shape, FULL_RAYS)
        tiles, rows = resolved.gather_tiles, resolved.gather_window_rows
        say({"fullres_statics": {"gather_tiles": tiles,
                                 "gather_window_rows": rows,
                                 "expected": list(FULL_GATHER)}})

        # ---- the server answers the held-out poses in the default form
        main = serve("fullres default (windowed)", cfg, FULL_REPS, shape)
        expect_counts("fullres default", main["counts"],
                      sampler=main["frames"], refine=main["frames"],
                      fused_nerf_raw_t=main["frames"])

        # ---- every form through the frame renderer, the same protocol
        data = infer.load_inference_data(cfg)
        params = infer._load_params(cfg, infer.setup_expdir(cfg), device)
        scene = prepare_scene(
            data["images"][data["i_ref"]], data["poses"][data["i_ref"]],
            data["K"], pack_corners="u8", device=device)
        K = data["K"]
        poses = [data["poses"][i][:3, :4] for i in data["i_test"]]
        forms = {
            "windowed": statics,
            "unwindowed": dataclasses.replace(statics, gather_tiles=0),
            "transposed": dataclasses.replace(statics, transposed=True),
            "int8": dataclasses.replace(statics, quant="int8"),
        }
        renderers = {name: make_frame_renderer(st, *shape, K, 0,
                                               device=device)
                     for name, st in forms.items()}
        drives = {}
        for name, render in renderers.items():
            drives[name] = drive_renderer(render, params, scene, poses)
            torch.cuda.empty_cache()
        n = drives["windowed"]["frames"]
        for name in ("windowed", "unwindowed"):
            expect_counts(f"fullres {name}", drives[name]["counts"],
                          sampler=n, refine=n, fused_nerf_raw_t=n)
        expect_counts("fullres transposed", drives["transposed"]["counts"],
                      sampler=n, refine=n, untransposed=2 * n,
                      fused_nerf_composite_t=n)
        expect_counts("fullres int8", drives["int8"]["counts"], sampler=n,
                      refine=n, fused_nerf_raw_tq=n)
        fw, fu = drives["windowed"]["first"], drives["unwindowed"]["first"]
        served = first_frame(main, device)
        served_err = max(max_err(served[k], fw[k]) for k in served)
        # the split fetch: the same colours, so the same frame
        split = make_frame_renderer(
            dataclasses.replace(statics, gather_split=True), *shape, K, 0,
            device=device)(params, scene, poses[0])
        split_equal = {k: nan_equal(split[k], fw[k]) for k in FRAME_KEYS}
        if served_err != 0.0 or not all(split_equal.values()):
            raise SystemExit(f"fullres: served frame against the renderer's "
                             f"{served_err}; split frame equal "
                             f"{split_equal}")

        # ---- the gathers on the first pose's own points
        rays = rays_for_pose(*shape, K, poses[0], device=device)
        packed = pack_serving_params(params, resolved)
        z3d = frame_depths(packed, rays, resolved)
        controls = {"target_t": torch.as_tensor(
            poses[0][:3, 3], dtype=torch.float32, device=device)}
        nearest = _nearest_views(resolved, scene, controls)
        windows, ray_missed = window_readings(scene, rays, z3d, nearest,
                                              tiles, rows)
        torch.cuda.empty_cache()

        # ---- the frames against each other: windowed against unwindowed
        # (equal on every ray no window missed), transposed against
        # row-major (bulk and tail), int8 against bf16 (the JAX bounds)
        hit = ~ray_missed.reshape(shape)
        windowed_vs = {}
        for k in FRAME_KEYS:
            d = (fw[k].float() - fu[k].float()).abs()
            d = d if d.dim() == 2 else d.amax(-1)
            windowed_vs[k] = {"equal_where_no_miss": nan_equal(
                fw[k][hit], fu[k][hit]),
                "max_diff_missed_rays": float(d[~hit].max())
                if (~hit).any() else 0.0,
                "share_pixels_differing": float((d > 0).float().mean())}
        if not all(v["equal_where_no_miss"] for v in windowed_vs.values()):
            raise SystemExit(f"fullres windowed against unwindowed frame: "
                             f"{windowed_vs}")
        trans_vs = bulk_and_tail(
            "fullres transposed frame against the row-major frame",
            drives["transposed"]["first"], fw, FRAME_KEYS)
        fq = drives["int8"]["first"]
        mse = float(((fq["rgb1"].double() - fw["rgb1"].double()) ** 2)
                    .mean())
        int8_vs = {"psnr_rgb1_db": -10.0 * float(np.log10(max(mse, 1e-12))),
                   "depth_max_abs": max_err(fq["depth"], fw["depth"])}
        if not (int8_vs["psnr_rgb1_db"] > QUANT_PSNR_DB
                and int8_vs["depth_max_abs"] <= QUANT_DEPTH):
            raise SystemExit(f"fullres int8 frame against bf16: {int8_vs}")
        two = fullres_two_neighbours(cfg, scene, K, poses, device)

        # ---- a tile of the frame's rays (its own 8 ray tiles and windows)
        # through the kernels, the kernel-free bf16 path and the plain
        # versions on CPU tensors
        lo = (FULL_H // 2) * FULL_W
        tile = {k: v[lo:lo + CHUNK].contiguous() for k, v in rays.items()}
        with_k = render_rays(packed, tile, scene, controls, resolved)
        without = render_rays(params, tile, scene, controls,
                              dataclasses.replace(resolved,
                                                  use_kernels=False))
        keys = tuple(k for k in NINE_KEYS if k != "sigma")
        paths = rel_errs(with_k, without, PATHS_REL, keys)
        hold("fullres tile: kernel path against kernel-free bf16 path",
             paths, PATHS_REL)
        cpu = torch.device("cpu")
        scene_cpu = prepare_scene(
            data["images"][data["i_ref"]], data["poses"][data["i_ref"]],
            K, pack_corners="u8", device=cpu)
        on_cpu = render_rays(
            {k: copy.deepcopy(m).to(cpu) for k, m in params.items()},
            {k: v.to(cpu) for k, v in tile.items()}, scene_cpu,
            {k: v.to(cpu) for k, v in controls.items()}, resolved)
        plain = rel_errs(with_k, {k: v.to(device) for k, v in on_cpu.items()},
                         PLAIN_REL)
        hold("fullres tile: kernel path against the plain versions on the "
             "CPU", plain, PLAIN_REL, PLAIN_SHARE)

        profiles = {}
        if profile:
            for name, render in renderers.items():
                profiles[name] = profile_frames(
                    lambda: render(params, scene, poses[0]), 3)
                say({"profile": {"path": f"fullres {name}"}
                     | profiles[name]})

    say({"fullres": {
        "H": FULL_H, "W": FULL_W, "views": N_VIEWS, "poses": len(poses),
        "gather_tiles": tiles, "gather_window_rows": rows,
        "run_inference": {"frames": main["frames"],
                          "ms_per_frame": main["ms_per_frame"],
                          "wall_s": main["wall_s"],
                          "peak_mem_bytes": main["peak_mem_bytes"],
                          "launches": main["counts"],
                          "psnr": main["result"]["psnrs"]},
        "forms": {name: {k: d[k] for k in ("frames", "ms_per_frame",
                                           "ms_all", "peak_mem_bytes",
                                           "counts")}
                  for name, d in drives.items()},
        "device_busy_ms_per_frame": {
            name: p["device_busy_ms_per_frame"]
            for name, p in profiles.items()} or "run with --profile",
        "kernels_per_frame": {name: p["device_kernels_per_frame"]
                              for name, p in profiles.items()}
        or "run with --profile",
        "served_vs_renderer_max_err": served_err,
        "split_frame_equal": split_equal,
        "windows": windows,
        "windowed_vs_unwindowed_frame": windowed_vs,
        "transposed_vs_row_major_frame": trans_vs,
        "int8_vs_bf16_frame": int8_vs,
        "num_neighbor_2": two, "card": nvidia_smi_line(),
        "tile_kernel_vs_kernel_free_bf16": paths,
        "tile_kernel_vs_plain_versions_on_cpu": plain,
    }})
    return {
        "fused_minmax_t[sampler,N=762048]":
            main["counts"]["fused_minmax_t[sampler]"],
        "fused_minmax_t[refine,N=762048]":
            main["counts"]["fused_minmax_t[refine]"],
        "fused_nerf_raw_t[N=762048]": main["counts"]["fused_nerf_raw_t"],
        "fused_nerf_composite_t[N=762048]":
            drives["transposed"]["counts"]["fused_nerf_composite_t"],
        "fused_nerf_raw_tq[N=762048]":
            drives["int8"]["counts"]["fused_nerf_raw_tq"],
        "fused_minmax_t[refine,C=54,N=762048]":
            two["launches"]["fused_minmax_t[refine,C=54]"],
    }


# ----------------------------------------------------- gathers phase ------

def phase_gathers(device):
    """The other gathers on the card at 504x378: a ``gather_split`` frame
    equal to the default frame bit for bit; ``warp_interp = nearest``
    served through ``run_inference``; the per-view training gather
    (``train_gather = 1``) equal to the all-views gather on a batch's
    points, each timed, and a stage-1 sampler step with it against the same
    step with the all-views gather (TRAIN_TOL)."""
    from pronerf_tpu_torch.config import Config
    from pronerf_tpu_torch.models.pronerf import _select_neighbors
    from pronerf_tpu_torch.ops import warp
    from pronerf_tpu_torch.render import infer
    from pronerf_tpu_torch.render.raygen import prepare_scene, rays_from_pool
    from pronerf_tpu_torch.render.renderer import make_frame_renderer

    report = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gathers_") as tmp:
        cfg = Config.from_file(
            ROOT / "configs/llff/fern/fern_trt.txt",
            datadir=f"synthetic:{W_IMG}x{H}x{N_VIEWS}", use_trt=True,
            tile_rays=0, use_pallas=True, basedir=tmp, ft_path="")
        data = infer.load_inference_data(cfg)
        params = infer._load_params(cfg, infer.setup_expdir(cfg), device)
        scene = prepare_scene(
            data["images"][data["i_ref"]], data["poses"][data["i_ref"]],
            data["K"], pack_corners="u8", device=device)
        statics = infer._infer_statics(cfg, use_bf16=True)
        c2w = data["poses"][data["i_test"][0]][:3, :4]
        with torch.no_grad():
            base = make_frame_renderer(statics, H, W_IMG, data["K"], 0,
                                       device=device)(params, scene, c2w)
            reset_counters()
            split = make_frame_renderer(
                dataclasses.replace(statics, gather_split=True), H, W_IMG,
                data["K"], 0, device=device)(params, scene, c2w)
            torch.cuda.synchronize()
        expect_counts("gather_split frame", read_counters(), sampler=1,
                      refine=1, fused_nerf_raw_t=1)
        report["split_frame_equal"] = {k: nan_equal(split[k], base[k])
                                       for k in split}
        if not all(report["split_frame_equal"].values()):
            raise SystemExit(f"gather_split frame: "
                             f"{report['split_frame_equal']}")

        near = serve("warp_interp=nearest",
                     cfg.replace(warp_interp="nearest", max_images=1), 1)
        expect_counts("warp_interp=nearest", near["counts"],
                      sampler=near["frames"], refine=near["frames"],
                      fused_nerf_raw_t=near["frames"])
        near_frame = torch.from_numpy(near["result"]["rgbs1"][0]).to(device)
        report["nearest"] = {"frames": near["frames"],
                             "ms_per_frame": near["ms_per_frame"],
                             "psnr": near["result"]["psnrs"],
                             "max_diff_from_bilinear": max_err(
                                 near_frame, base["rgb1"])}
        if report["nearest"]["max_diff_from_bilinear"] == 0.0:
            raise SystemExit("warp_interp=nearest served the bilinear frame")

        # ---- train_gather = 1: the gather on a batch's points, then a step
        tcfg = train_config(1, tmp)
        shared = training_data(tcfg)
        tdata = shared[0]
        tscene, _, batch, ids = step_setup(tcfg, shared, device, tcfg.N_rand)
        ctl = step_controls(tcfg, len(tdata["i_train"]), device, tcfg.N_rand,
                            3, 64, seed=5)
        rays = rays_from_pool(batch[:, :2], ids, tdata["H"], tdata["W"],
                              tdata["focal"])
        z3d = torch.from_numpy(np.random.default_rng(5).uniform(
            1.0, 8.0, (tcfg.N_rand, tcfg.N_samples)).astype(np.float32)).to(
                device)
        view_idx = _select_neighbors(rays, tscene, ctl)
        args = (tscene["images"], tscene["fused_mats"], tscene["K"],
                view_idx, rays["or_o"], rays["or_d"], z3d)
        all_views = warp.epipolar_colors(*args)
        per_view = warp.epipolar_colors_per_view(*args)
        report["per_view_gather"] = {
            "equal_to_all_views": torch.equal(per_view, all_views),
            "share_valid": float((all_views.sum(-1) > 0).float().mean()),
            "ms_all_views": cuda_ms(lambda: warp.epipolar_colors(*args), 5),
            "ms_per_view": cuda_ms(
                lambda: warp.epipolar_colors_per_view(*args), 5),
            "rays": tcfg.N_rand, "train_views": len(tdata["i_train"])}
        if not report["per_view_gather"]["equal_to_all_views"]:
            raise SystemExit("per-view gather differs from the all-views one")
        steps = [one_step("sampler", 3, 64, train_config(1, tmp,
                                                          train_gather=tg),
                          shared, device, tcfg.N_rand, seed=6)
                 for tg in (1, -1)]
        report["train_gather_1_step"] = steps_agree(
            "stage-1 sampler step, train_gather=1 against all views", *steps)
    say({"gathers": report})
    return report


# ------------------------------------------------------ donerf phase ------

def phase_donerf(device):
    """``netarch = donerf`` at D = 8, W = 256 on the card: one 504x378 frame
    through ``run_inference`` (the fused kernels implement the NeRF MLP, so
    none runs), and one stage-1 NeRF step against the same step on CPU
    tensors (TRAIN_TOL)."""
    from pronerf_tpu_torch.config import Config

    with tempfile.TemporaryDirectory(prefix="chip_smoke_donerf_") as tmp:
        cfg = Config.from_file(
            ROOT / "configs/llff/fern/fern_trt.txt",
            datadir=f"synthetic:{W_IMG}x{H}x{N_VIEWS}", use_trt=True,
            tile_rays=0, use_pallas=True, basedir=tmp, ft_path="",
            netarch="donerf", max_images=1)
        drive = serve("netarch=donerf", cfg, 1)
        expect_counts("netarch=donerf", drive["counts"])
        shared = training_data(train_config(1, tmp))
        vs_cpu = card_against_cpu(tmp, shared, device, (STEP_KINDS[1],),
                                  netarch="donerf")
        report = {"netdepth": cfg.netdepth, "netwidth": cfg.netwidth,
                  "frames": drive["frames"],
                  "ms_per_frame": drive["ms_per_frame"],
                  "peak_mem_bytes": drive["peak_mem_bytes"],
                  "psnr": drive["result"]["psnrs"], "card_vs_cpu": vs_cpu}
    say({"donerf": report})
    return report


# ------------------------------------------------------- train phase ------

# Release widths of the two training configs (NeRF 8x256 + 128 view branch,
# sampler and refine 6x256 unfolded, 8 samples, 4 neighbours, 4096 rays a
# step, exploration up to 64 samples a ray) on the synthetic 504x378 scene
# of 17 views (14 train, a pool of 2,667,168 rays).
TRAIN_STEPS = {1: 4, 2: 2}     # steps of run_training: 2 stage-1 pairs, 2
TIMED_STEPS = 5                # median of this many, after 2 to warm up
CPU_RAYS = 512                 # rays of the card-against-CPU step
# The card against the CPU, one step of each kind from the same params,
# batch, controls and noise: every sum is f32 on both (TF32 off), taken in
# another order by cuBLAS and by the CPU's BLAS, so the loss agrees to
# ~1e-6 of its size (bound 1e-5), and the gradients, seen through Adam's
# first moment (0.1 g after one step), to f32 rounding, except where a
# ReLU input lies within the last bits of its kink on one side only: such a
# point moves one row of a weight and, through its backward, the layers below
# (measured on the CPU against JAX: 2.8e-3 of a tensor's size in norm, 3.9e-3
# at an element; tests/torch_train_common.py). Bound: 5e-3 in norm, 1e-2 at
# an element, relative to the tensor's size. Params move by lr * u with u =
# g / (|g| + eps), about the sign of g: within 2 lr everywhere and 1e-3 lr
# on 99% of the elements.
TRAIN_TOL = {"loss_rel": 1e-5, "grad_norm_rel": 5e-3, "grad_max_rel": 1e-2,
             "param_lr": 1e-3, "param_share": 0.99}
# H100 SXM peak for f32 outside the tensor cores (TF32 is off).
PEAK_F32 = 67e12


def nerf_macs_per_point():
    """Multiply-adds of the 8x256 NeRF a point: layer 0 on the 63-wide
    encoding, layers 1-4, layer 5 on [encoding | h] (319), layers 6-7, the
    alpha head, the feature layer, the view layer on [feature | 27], the rgb
    head."""
    return (63 * 256 + 4 * 256 * 256 + 319 * 256 + 2 * 256 * 256 + 256
            + 256 * 256 + 283 * 128 + 128 * 3)


def minmax_macs_per_ray(n_in, n_out):
    return n_in * 256 + 5 * 256 * 256 + 256 * n_out


def step_flops(kind, rays, width):
    """Operations of one training step: a forward and backward costs three
    forwards (the backward takes the gradients of the inputs and of the
    weights); the stage-1 NeRF step runs the sampler and refine nets forward
    only."""
    nerf = 2 * nerf_macs_per_point() * rays * width
    mm = 2 * (minmax_macs_per_ray(288, 27) + minmax_macs_per_ray(144, 35)) \
        * rays
    if kind == "nerf":
        return 3 * nerf + mm
    return 3 * (nerf + mm)


def train_config(stage, tmp, **kw):
    from pronerf_tpu_torch.config import Config

    name = "fern_epi.txt" if stage == 1 else "fern_refine.txt"
    base = dict(datadir=f"synthetic:{W_IMG}x{H}x{N_VIEWS}", basedir=tmp,
                expname=f"stage{stage}", i_print=1, i_weights=1000, i_img=0,
                i_testset=0, i_video=0, pretrain_path="")
    return Config.from_file(ROOT / f"configs/llff/fern/{name}", **(base | kw))


def training_data(cfg):
    """The training scene and its ray pool, made once for the step drives
    (the same seed as run_training's)."""
    from pronerf_tpu_torch.render.raygen import build_ray_pool
    from pronerf_tpu_torch.train.loop import load_training_data

    data = load_training_data(cfg)
    pool, ids = build_ray_pool(data["images"], data["poses"], data["K"],
                               list(data["i_train"]), cfg.num_neighbor,
                               np.random.default_rng(cfg.seed))
    return data, pool, ids


def step_setup(cfg, shared, device, rays):
    """Params from the seed (drawn on the CPU, moved to ``device``), the
    scene, and the first ``rays`` rays of the pool, for the step
    functions."""
    from pronerf_tpu_torch.render.infer import _init_params
    from pronerf_tpu_torch.render.raygen import prepare_scene

    data, pool, ids = shared
    i_train = data["i_train"]
    scene = prepare_scene(data["images"][i_train], data["poses"][i_train],
                          data["K"], device=device)
    params = _init_params(cfg, torch.Generator().manual_seed(cfg.seed), device)
    return scene, params, torch.from_numpy(pool[:rays]).to(device), \
        torch.from_numpy(ids[:rays]).to(device)


def step_controls(cfg, n_train, device, rays, n_mult, width, seed,
                  noise=True):
    """A step's controls as the trainer draws them (``_draw_controls``, from
    a numpy Generator of ``seed``), with n_mult set, and the N(0, 1) noise
    drawn with numpy at ``[rays, width]``, so that both devices see it."""
    from pronerf_tpu_torch.train.loop import _draw_controls

    rng = np.random.default_rng(seed)
    ctl = _draw_controls(rng, n_train, cfg, seed, device)
    ctl["n_mult"] = n_mult
    if noise:
        for k in ("raw_noise", "jitter_noise"):
            ctl[k] = torch.from_numpy(
                rng.standard_normal((rays, width), dtype=np.float32)).to(device)
    return ctl


def make_step(kind, cfg, data):
    from pronerf_tpu_torch.train import stage1, stage2

    H_, W_, f = data["H"], data["W"], data["focal"]
    if kind == "stage2":
        return stage2.make_stage2_step(cfg, H_, W_, f), stage2.init_stage2_state
    nerf_step, sampler_step = stage1.make_stage1_steps(cfg, H_, W_, f)
    return (nerf_step if kind == "nerf" else sampler_step,
            stage1.init_stage1_state)


STEP_KINDS = (  # name, step, n_mult, noise width
    ("nerf[n_mult=1]", "nerf", 1, 64), ("nerf[n_mult=8]", "nerf", 8, 64),
    ("sampler", "sampler", 3, 64), ("stage2", "stage2", 3, 8))
OPT_KEY = {"nerf": "opt_nerf", "sampler": "opt_s", "stage2": "opt"}


def time_steps(tmp, shared, device, profile=False):
    """ms a step by CUDA events (median of TIMED_STEPS after two to warm
    up) and peak memory, for each kind at the configs' 4096 rays; with
    ``profile``, device time by kernel name over 3 more steps of each."""
    rows = {}
    for name, kind, n_mult, width in STEP_KINDS:
        cfg = train_config(1 if kind != "stage2" else 2, tmp)
        scene, params, batch, ids = step_setup(cfg, shared, device,
                                               cfg.N_rand)
        step, init = make_step(kind, cfg, shared[0])
        state = init(params, cfg.weight_decay)
        ctl = step_controls(cfg, len(shared[0]["i_train"]), device,
                            cfg.N_rand, n_mult, width, seed=2)
        losses = []

        def run():
            _, m = step(state, scene, batch, ids, ctl, 1e-4)
            losses.append(m["loss"])

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run()
        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(TIMED_STEPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated()
        vals = [float(v) for v in losses]
        if not all(np.isfinite(vals)):
            raise SystemExit(f"train step {name}: losses {vals}")
        w = width if kind == "nerf" else cfg.N_samples
        flops = step_flops("nerf" if kind == "nerf" else "joint", cfg.N_rand, w)
        if profile:
            say({"profile": {"path": f"train step {name}"}
                 | profile_frames(run, 3)})
        rows[name] = {
            "rays": cfg.N_rand, "samples_a_ray": w, "ms": ms, "ms_all": times,
            "flops": flops, "bound_ms": flops / PEAK_F32 * 1e3,
            "bound_by": "operations (f32)", "peak_mem_bytes": peak,
            "losses": vals,
        }
        del state, params, scene, batch
        torch.cuda.empty_cache()
    return rows


def one_step(kind, n_mult, width, cfg, shared, device, rays, seed):
    """One step of ``kind`` from the seed's params on the first ``rays``
    rays of the pool, with the controls (``n_mult`` set) and the noise (of
    ``width`` columns) of ``seed``: its loss, Adam's first moment and the
    params' change, on the CPU."""
    from pronerf_tpu_torch.train.state import named_params

    cpu = torch.device("cpu")
    scene, params, batch, ids = step_setup(cfg, shared, device, rays)
    p0 = {k: v.detach().clone() for k, v in named_params(params).items()}
    step, init = make_step(kind, cfg, shared[0])
    state = init(params, cfg.weight_decay)
    ctl = step_controls(cfg, len(shared[0]["i_train"]), device, rays,
                        n_mult, width, seed)
    state, m = step(state, scene, batch, ids, ctl, 5e-4)
    return {
        "loss": float(m["loss"]),
        "mu": {k: v.to(cpu) for k, v in state[OPT_KEY[kind]]["mu"].items()},
        "dp": {k: (v.detach() - p0[k]).to(cpu) for k, v in
               named_params(state["params"]).items()},
    }


def steps_agree(what, c, h):
    """Step ``c`` against step ``h`` (``one_step``'s results) under
    ``TRAIN_TOL``; fails outside it."""
    loss_rel = abs(c["loss"] - h["loss"]) / abs(h["loss"])
    norm_rel = max(float((c["mu"][k] - v).norm() / v.norm())
                   for k, v in h["mu"].items())
    max_rel = max(float((c["mu"][k] - v).abs().max() / v.abs().max())
                  for k, v in h["mu"].items())
    d = torch.cat([(c["dp"][k] - v).abs().flatten()
                   for k, v in h["dp"].items()])
    row = {"loss": c["loss"], "loss_ref": h["loss"],
           "loss_rel": loss_rel, "grad_norm_rel": norm_rel,
           "grad_max_rel": max_rel,
           "param_max_over_lr": float(d.max()) / 5e-4,
           "param_share_within": float((d <= TRAIN_TOL["param_lr"] * 5e-4)
                                       .float().mean())}
    if not (loss_rel <= TRAIN_TOL["loss_rel"]
            and norm_rel <= TRAIN_TOL["grad_norm_rel"]
            and max_rel <= TRAIN_TOL["grad_max_rel"]
            # a sanity check that also catches a non-finite update: after
            # one Adam step from zero moments |u| <= 1 on both sides, so a
            # finite difference is at most 2 lr
            and row["param_max_over_lr"] <= 2
            and row["param_share_within"] >= TRAIN_TOL["param_share"]):
        raise SystemExit(f"{what}: {row} (bounds {TRAIN_TOL})")
    return row


def card_against_cpu(tmp, shared, device, kinds=STEP_KINDS[1:], **cfg_kw):
    """One step of each kind on the card and on CPU tensors, from the same
    params, batch, controls and noise (TRAIN_TOL)."""
    out = {}
    for name, kind, n_mult, width in kinds:
        cfg = train_config(1 if kind != "stage2" else 2, tmp, **cfg_kw)
        card, host = (one_step(kind, n_mult, width, cfg, shared, dev,
                               CPU_RAYS, seed=4)
                      for dev in (device, torch.device("cpu")))
        out[name] = steps_agree(f"train step {name}: card against CPU", card,
                                host)
    return out


def read_losses(expdir):
    return {rec["step"]: rec["loss"] for rec in map(
        json.loads, (Path(expdir) / "metrics.jsonl").read_text().splitlines())}


def phase_train(device, profile=False):
    """The slice's main path: run_training for a few steps of stage 1 and
    then of stage 2 from its expdir, on the card, at release widths; a
    resume that must equal the uninterrupted run; the stage-2 checkpoint
    served through the kernels; per-step times; one step of each kind held
    against the CPU."""
    from pronerf_tpu_torch.config import Config
    from pronerf_tpu_torch.render import infer
    from pronerf_tpu_torch.render.raygen import prepare_scene
    from pronerf_tpu_torch.render.renderer import make_frame_renderer
    from pronerf_tpu_torch.train import checkpoint
    from pronerf_tpu_torch.train.loop import run_training
    from pronerf_tpu_torch.train.state import named_params

    report = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        # ---- the trainer: stage 1, then stage 2 from its expdir; counters
        # zeroed just before and read just after (training runs no kernel)
        reset_counters()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s1, exp1 = run_training(
            train_config(1, tmp, max_steps=TRAIN_STEPS[1], i_img=2), 1)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        s2, exp2 = run_training(
            train_config(2, tmp, max_steps=TRAIN_STEPS[2],
                         pretrain_path=str(exp1)), 2)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        counts = read_counters()
        expect_counts("training", counts)
        peak_train = torch.cuda.max_memory_allocated()
        if s1["global_step"] != TRAIN_STEPS[1] or \
                s2["global_step"] != TRAIN_STEPS[2]:
            raise SystemExit("run_training ran the wrong number of steps")
        losses1, losses2 = read_losses(exp1), read_losses(exp2)
        all_losses = list(losses1.values()) + list(losses2.values())
        if not all(np.isfinite(all_losses)):
            raise SystemExit(f"training losses {losses1} {losses2}")
        if not (Path(exp1) / "imgs" / "test0_000002.png").exists():
            raise SystemExit("i_img wrote no PNG")
        ck1 = checkpoint.latest_checkpoint(exp1)
        ck2 = checkpoint.latest_checkpoint(exp2)

        # ---- resume: 2 steps, then 2 more from the checkpoint, equal to the
        # uninterrupted run step for step and in the end
        half = TRAIN_STEPS[1] // 2
        run_training(train_config(1, tmp, expname="resumed", max_steps=half),
                     1)
        r1, exp_r = run_training(
            train_config(1, tmp, expname="resumed", max_steps=half), 1)
        resumed = read_losses(exp_r)
        steps_equal = {i: resumed[i] == losses1[i] for i in losses1}
        want = checkpoint.load_checkpoint(ck1)
        got = checkpoint.load_checkpoint(checkpoint.latest_checkpoint(exp_r))
        params_equal = all(
            torch.equal(got[net][k], v) for net in
            ("network_fn", "mmr_network_fn", "refine_net")
            for k, v in want[net].items())
        if not (all(steps_equal.values()) and params_equal):
            raise SystemExit(f"resumed run differs: losses {resumed} against "
                             f"{losses1}, params equal {params_equal}")

        # ---- the stage-2 checkpoint served through the kernels
        cfg_i = Config.from_file(
            ROOT / "configs/llff/fern/fern_trt.txt",
            datadir=f"synthetic:{W_IMG}x{H}x{N_VIEWS}", use_trt=True,
            tile_rays=0, use_pallas=True, basedir=tmp, ft_path=ck2,
            max_images=1)
        drive = serve("trained checkpoint", cfg_i, 1)
        expect_counts("trained checkpoint", drive["counts"],
                      sampler=drive["frames"], refine=drive["frames"],
                      fused_nerf_raw_t=drive["frames"])
        data = infer.load_inference_data(cfg_i)
        scene = prepare_scene(
            data["images"][data["i_ref"]], data["poses"][data["i_ref"]],
            data["K"], pack_corners="u8", device=device)
        statics = infer._infer_statics(cfg_i, use_bf16=True)
        render = make_frame_renderer(statics, H, W_IMG, data["K"], 0,
                                     device=device)
        c2w = data["poses"][data["i_test"][0]][:3, :4]
        with torch.no_grad():
            direct = render(infer.load_params_for_inference(ck2, cfg_i,
                                                            device),
                            scene, c2w)["rgb1"]
            untrained = render(infer._init_params(
                cfg_i, torch.Generator().manual_seed(cfg_i.seed), device),
                scene, c2w)["rgb1"]
        served = torch.from_numpy(drive["result"]["rgbs1"][0]).to(device)
        served_err = max_err(served, direct)
        if served_err != 0.0 or torch.equal(direct, untrained):
            raise SystemExit(f"served frame against the checkpoint's params: "
                             f"{served_err}; equal to untrained weights: "
                             f"{torch.equal(direct, untrained)}")
        trained_moved = max_err(direct, untrained)

        # ---- per-step times and memory; the card against the CPU
        shared = training_data(train_config(1, tmp))
        steps = time_steps(tmp, shared, device, profile)
        vs_cpu = card_against_cpu(tmp, shared, device)
        report = {
            "config": {"stage1": "configs/llff/fern/fern_epi.txt",
                       "stage2": "configs/llff/fern/fern_refine.txt",
                       "datadir": f"synthetic:{W_IMG}x{H}x{N_VIEWS}",
                       "N_rand": train_config(1, tmp).N_rand,
                       "card_vs_cpu_rays": CPU_RAYS},
            "run_training": {
                "stage1_steps": TRAIN_STEPS[1], "stage2_steps": TRAIN_STEPS[2],
                "wall_s": {"stage1": wall1, "stage2": wall2},
                "losses_stage1": losses1, "losses_stage2": losses2,
                "peak_mem_bytes": peak_train, "launches": counts,
                "params": sum(v.numel() for v in
                              named_params(s2["params"]).values()),
            },
            "resume": {"steps_equal": steps_equal,
                       "params_equal": params_equal},
            "serve_trained": {"ckpt": Path(ck2).name,
                              "launches": drive["counts"],
                              "served_vs_direct_max_err": served_err,
                              "trained_vs_untrained_max_diff": trained_moved,
                              "psnr": drive["result"]["psnrs"]},
            "steps": steps, "card_vs_cpu": vs_cpu, "tol": TRAIN_TOL,
            "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                     "cudnn": torch.backends.cudnn.allow_tf32},
        }
    say({"train": report})
    return report


# ---------------------------------------------------------------- multi ----

MULTI_SCENES = 8          # train-multi: all 8 LLFF scenes' count
MULTI_S = (1, 2, 8)       # scenes a step, graph against eager
MULTI_REPS = 5            # timed calls (median) after a warm-up
STEADY_ITERS = 6          # frames a replay of the steady-state graph
# the kernels of the slice's path (the sharded and the graph frame)
MULTI_PATH = ("fused_minmax_t[sampler]", "fused_minmax_t[refine]",
              "fused_nerf_raw_t", "fused_nerf_composite_t",
              "fused_nerf_raw_tq")


def multi_cli(argv):
    """``drive_cli`` with its standard output kept: ``(result, counts,
    wall s, text)``."""
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        result, counts, wall = drive_cli(argv)
    return result, counts, wall, log.getvalue()


def multi_losses(text):
    """Each ``[TRAIN-MULTI] Iter:`` line's per-scene losses."""
    out = {}
    for ln in text.splitlines():
        m = re.match(r"\[TRAIN-MULTI\] Iter: (\d+) it/s: \S+ loss (.*)", ln)
        if m:
            out[int(m.group(1))] = [float(x.split(":")[1])
                                    for x in m.group(2).split()]
    return out


def multi_training(tmp):
    """``train-multi`` through the command line on MULTI_SCENES synthetic
    scenes of the release size: stage 1 for 2 steps, resumed for 2 more
    with one held-out render a scene, then stage 2 for 2 steps from that
    expdir; per-scene checkpoints; no kernel launched (training and the
    stage's eval statics run none)."""
    scenes = ",".join([f"synthetic:{W_IMG}x{H}x{N_VIEWS}"] * MULTI_SCENES)
    names = [f"synthetic{i}" for i in range(MULTI_SCENES)]
    epi = str(ROOT / "configs/llff/fern/fern_epi.txt")
    refine = str(ROOT / "configs/llff/fern/fern_refine.txt")

    def common(expname, testset):
        return ["--scenes", scenes, "--", "--basedir", tmp, "--expname",
                expname, "--i_print", "1", "--i_weights", "1000", "--i_img",
                "0", "--i_video", "0", "--i_testset", str(testset),
                "--max_images", "1"]

    torch.cuda.reset_peak_memory_stats()
    half = TRAIN_STEPS[1] // 2
    runs = {}
    (_, _, exp1), c1, w1, t1 = multi_cli(
        ["train-multi", "--config", epi, "--no-reload", "--max-steps",
         str(half)] + common("multi_s1", 0))
    (s1, _, _), c1r, w1r, t1r = multi_cli(
        ["train-multi", "--config", epi, "--max-steps", str(half)]
        + common("multi_s1", TRAIN_STEPS[1]))
    (s2, _, exp2), c2, w2, t2 = multi_cli(
        ["train-multi", "--stage", "2", "--config", refine, "--no-reload",
         "--max-steps", str(TRAIN_STEPS[2]), "--pretrain-path", str(exp1)]
        + common("multi_s2", 0))
    peak = torch.cuda.max_memory_allocated()
    for what, c in (("stage 1", c1), ("resume", c1r), ("stage 2", c2)):
        expect_counts(f"train-multi {what}", c)
    losses = {"stage1": multi_losses(t1) | multi_losses(t1r),
              "stage2": multi_losses(t2)}
    psnr = [ln for ln in t1r.splitlines() if "per-scene test PSNR" in ln]
    ckpts = {f"{stage}/{n}": sorted(p.name for p in
                                    (Path(e) / f"scene_{n}").glob("*.ckpt"))
             for stage, e in (("s1", exp1), ("s2", exp2)) for n in names}
    renders = [n for n in names if (Path(exp1) / f"scene_{n}" /
                                    f"testset_{TRAIN_STEPS[1]:06d}" /
                                    "000.png").exists()]
    ok = (f"resumed {MULTI_SCENES} scenes at step {half}" in t1r
          and t2.count("stage-2 bootstrap from") == MULTI_SCENES
          and len(psnr) == 1 and all(f"{n}:" in psnr[0] for n in names)
          and renders == names
          and sorted(losses["stage1"]) == list(range(1, TRAIN_STEPS[1] + 1))
          and sorted(losses["stage2"]) == list(range(1, TRAIN_STEPS[2] + 1))
          and all(len(v) == MULTI_SCENES and np.all(np.isfinite(v))
                  for d in losses.values() for v in d.values())
          and [st["global_step"] for st in s1] == [TRAIN_STEPS[1]]
          * MULTI_SCENES
          and [st["global_step"] for st in s2] == [TRAIN_STEPS[2]]
          * MULTI_SCENES
          and all(v[-1] == f"{TRAIN_STEPS[1]:06d}.ckpt"
                  for k, v in ckpts.items() if k.startswith("s1"))
          and all(v[-1] == f"{TRAIN_STEPS[2]:06d}.ckpt"
                  for k, v in ckpts.items() if k.startswith("s2")))
    runs = {"scenes": MULTI_SCENES, "size": [W_IMG, H, N_VIEWS],
            "wall_s": {"stage1": w1, "stage1_resumed": w1r, "stage2": w2},
            "losses": losses, "test_psnr_line": psnr,
            "checkpoints_s1": ckpts[f"s1/{names[0]}"],
            "checkpoints_s2": ckpts[f"s2/{names[0]}"],
            "peak_mem_bytes": peak, "launches": c1}
    if not ok:
        raise SystemExit(f"train-multi: {runs}\n{t1r[-2000:]}")
    return runs


def same_tree(a, b) -> bool:
    """Two checkpoints (nested dicts of tensors and numbers) equal bit for
    bit."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_tree(a[k], b[k]) for k in a)
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def multi_world_of_one(tmp, device):
    """``train-multi --nproc 1`` through the command line, which forms (and
    closes) a world of one over NCCL, against ``run_multi_training`` called
    in this process with no process group, on the same config (2 scenes of
    the release size, 2 stage-1 steps): every checkpoint equal bit for
    bit."""
    from pronerf_tpu_torch import cli
    from pronerf_tpu_torch.train import checkpoint
    from pronerf_tpu_torch.train.multi_loop import run_multi_training

    scenes = [f"synthetic:{W_IMG}x{H}x{N_VIEWS}"] * 2

    def argv(expname):
        return ["train-multi", "--config",
                str(ROOT / "configs/llff/fern/fern_epi.txt"), "--no-reload",
                "--max-steps", "2", "--nproc", "1", "--scenes",
                ",".join(scenes), "--", "--basedir", tmp, "--expname",
                expname, "--i_print", "1", "--i_weights", "1000", "--i_img",
                "0", "--i_video", "0", "--i_testset", "0"]

    (_, names, by_cli), counts, wall, text = multi_cli(argv("multi_nproc1"))
    formed = "[TRAIN-MULTI] 1 rank over nccl" in text
    args, _ = cli.build_parser().parse_known_args(argv("multi_direct"))
    cfg = cli._build_cfg(args, cli.DEFAULT_STAGE1_CONFIG)
    t0 = time.perf_counter()
    _, _, direct = run_multi_training(cfg, scenes, device=device)
    wall_direct = time.perf_counter() - t0
    equal = {}
    for name in names:
        files = sorted(p.name for p in (by_cli / f"scene_{name}").glob(
            "*.ckpt"))
        equal[name] = files == ["000002.ckpt"] and all(same_tree(
            checkpoint.load_checkpoint(by_cli / f"scene_{name}" / f),
            checkpoint.load_checkpoint(direct / f"scene_{name}" / f))
            for f in files)
    expect_counts("train-multi --nproc 1", counts)
    report = {"group_formed": formed,
              "group_closed": not torch.distributed.is_initialized(),
              "checkpoints_equal": equal,
              "wall_s": {"cli_nproc_1": wall, "in_process": wall_direct}}
    if not (formed and report["group_closed"] and len(equal) == 2
            and all(equal.values())):
        raise SystemExit(f"train-multi --nproc 1: {report}\n{text[-2000:]}")
    return report


def multi_steps(tmp, device, profile=False):
    """The multi-scene step of each kind at S = 1, 2 and 8 scenes: one
    graph step (the capture) from seeded states against each scene's eager
    single-scene step fed the same controls and noise (TRAIN_TOL, one Adam
    step each); then ms a step of both by CUDA events (median of
    MULTI_REPS after a warm-up; the graph's with the fill of its buffers
    and its noise draws), the graph's replay alone, the capture's seconds,
    and peak memory."""
    from pronerf_tpu_torch.parallel.multi_scene import (
        make_multi_scene_pooled_step,
        make_scene_mesh,
    )
    from pronerf_tpu_torch.render.infer import _init_params
    from pronerf_tpu_torch.render.raygen import prepare_scene
    from pronerf_tpu_torch.train.loop import _draw_controls
    from pronerf_tpu_torch.train.state import named_params

    cfgs = {1: train_config(1, tmp), 2: train_config(2, tmp)}
    shared = training_data(cfgs[1])
    data, pool, ids = shared
    i_train = data["i_train"]
    scene = prepare_scene(data["images"][i_train], data["poses"][i_train],
                          data["K"], device=device)
    pool_d = torch.from_numpy(pool).to(device)
    ids_d = torch.from_numpy(ids).to(device)
    mesh = make_scene_mesh(1, 1)
    lr, out = 5e-4, {}
    for S in MULTI_S:
        pools = pool_d[None].repeat(S, 1, 1, 1)
        pool_ids = ids_d[None].repeat(S, 1)
        for kind, stage in (("nerf", 1), ("sampler", 1), ("joint", 2)):
            cfg = cfgs[stage]
            n = cfg.N_rand
            name = "stage2" if kind == "joint" else kind
            fn, init = make_step(name, cfg, data)

            def fresh(s, cfg=cfg, init=init):
                return init(_init_params(
                    cfg, torch.Generator().manual_seed(cfg.seed + s),
                    device), cfg.weight_decay)

            graph_states = [fresh(s) for s in range(S)]
            eager_states = [fresh(s) for s in range(S)]
            p0 = [{k: v.detach().clone() for k, v in
                   named_params(st["params"]).items()} for st in eager_states]
            controls = _draw_controls(np.random.default_rng(S), len(i_train),
                                      cfg, 1, device)
            step = make_multi_scene_pooled_step(
                cfg, data["H"], data["W"], data["focal"], mesh, stage, kind)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _, m = step(graph_states, [scene] * S, pools, pool_ids, 0,
                        controls, lr)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            noise = [step.scene_noise(controls, s, n, device)
                     for s in range(S)]
            host = {k: v for k, v in controls.items() if k != "rng"}

            def eager():
                return [fn(eager_states[s], scene, pools[s, :n],
                           pool_ids[s, :n], dict(host, **noise[s]), lr)[1]
                        for s in range(S)]

            e_losses = [float(em["loss"]) for em in eager()]
            opt = OPT_KEY[name]
            agree = []
            for s in range(S):
                def result(st, loss):
                    return {"loss": loss, "mu": {
                        k: v.cpu() for k, v in st[opt]["mu"].items()},
                        "dp": {k: (v.detach() - p0[s][k]).cpu() for k, v in
                               named_params(st["params"]).items()}}

                agree.append(steps_agree(
                    f"multi-scene graph step {kind} S={S} scene {s}",
                    result(graph_states[s], float(m["loss"][s])),
                    result(eager_states[s], e_losses[s])))
                if graph_states[s]["global_step"] != 1 or \
                        graph_states[s][opt]["count"] != 1:
                    raise SystemExit(f"multi-scene graph step {kind}: host "
                                     f"counters {graph_states[s]['global_step']}")
            peak_capture = torch.cuda.max_memory_allocated()

            def graph_step():
                step(graph_states, [scene] * S, pools, pool_ids, n,
                     controls, lr)

            graph = next(iter(step.graphs.values()))
            graph_step()
            t_graph = event_chunk_ms(graph_step, MULTI_REPS)
            t_replay = event_chunk_ms(graph.replay, MULTI_REPS)
            torch.cuda.reset_peak_memory_stats()
            t_eager = event_chunk_ms(eager, MULTI_REPS)
            peak_eager = torch.cuda.max_memory_allocated()
            row = {"ms_graph": statistics.median(t_graph),
                   "ms_graph_replay": statistics.median(t_replay),
                   "ms_eager": statistics.median(t_eager),
                   "ms_graph_all": t_graph, "ms_eager_all": t_eager,
                   "capture_s": capture_s,
                   "peak_mem_bytes_graph": peak_capture,
                   "peak_mem_bytes_eager": peak_eager,
                   "against_eager": agree}
            if S == MULTI_S[-1]:
                prof = profile_frames(graph.replay, 2)
                row["device_busy_ms_graph"] = prof["device_busy_ms_per_frame"]
                row["kernels_a_step_graph"] = prof["device_kernels_per_frame"]
                if profile:
                    say({"profile": {"path": f"multi {kind} S={S} graph"}
                         | prof})
            out[f"{kind}[S={S}]"] = row
            del step, graph, graph_states, eager_states, p0, noise
            torch.cuda.empty_cache()
        del pools, pool_ids
        torch.cuda.empty_cache()
    return out


@torch.no_grad()
def multi_frames(tmp, device, profile=False):
    """The slice's kernel path. The sharded frame renderer in a world of one
    over NCCL, and the frame body as a CUDA graph, at 504x378 (the default
    statics, fuse_composite, int8, transposed) and 1008x756 (the default,
    windowed): sharded frames equal the live renderer's bit for bit with
    the same launches (counters zeroed just before each, read just after);
    a captured frame (launches counted at its warm-up and capture) replayed
    equal to the eager frame bit for bit; ms a frame sharded and live in
    turns, the steady-state ms/frame (``amortized_timer``: one graph of
    STEADY_ITERS frames, replayed), the graph's replay alone, the eager
    frame (``timed_ms``) and its profiled busy time. Returns the report and
    the launches of the sharded drives and of the captures."""
    from pronerf_tpu_torch.config import Config
    from pronerf_tpu_torch.parallel import launch
    from pronerf_tpu_torch.parallel.data_parallel import make_ray_mesh
    from pronerf_tpu_torch.parallel.render_parallel import (
        make_sharded_frame_renderer,
    )
    from pronerf_tpu_torch.render import infer
    from pronerf_tpu_torch.render.renderer import make_frame_renderer
    from pronerf_tpu_torch.utils.profiling import (
        amortized_timer,
        cuda_graph,
        null_dispatch_ms,
        timed_ms,
    )
    from pronerf_tpu_torch.utils.tensors import as_f32

    backend = launch.init_group(device)
    report = {"backend": backend, "world": launch.world()}
    sharded_counts, graph_counts = {}, {}

    def add(total, counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    try:
        mesh = make_ray_mesh()
        null_ms = null_dispatch_ms(device)
        report["null_ms"] = null_ms
        for w, h in ((W_IMG, H), (FULL_W, FULL_H)):
            cfg = Config.from_file(
                ROOT / "configs/llff/fern/fern_trt.txt",
                datadir=f"synthetic:{w}x{h}x{N_VIEWS}", use_trt=True,
                tile_rays=0, use_pallas=True, ft_path="", basedir=tmp)
            data = infer.load_inference_data(cfg)
            params = infer._init_params(
                cfg, torch.Generator().manual_seed(cfg.seed), device)
            scene = infer._serving_scene(cfg, data, device)
            st = infer._infer_statics(cfg, use_bf16=True)
            forms = {"default": st}
            if w == W_IMG:
                forms |= {
                    "fuse_composite": dataclasses.replace(
                        st, fuse_composite=True),
                    "int8": dataclasses.replace(st, quant="int8"),
                    "transposed": dataclasses.replace(st, transposed=True)}
            c2w = data["poses"][data["i_test"][0]][:3, :4]
            c2w_d = as_f32(c2w, device)
            for form, statics in forms.items():
                what = f"{form} {w}x{h}"
                live = make_frame_renderer(statics, h, w, data["K"], 0,
                                           device=device)
                shard = make_sharded_frame_renderer(statics, h, w, data["K"],
                                                    mesh, device=device)
                frames, counts = [], []
                for r in (live, shard):
                    reset_counters()
                    frames.append(r(params, scene, c2w))
                    torch.cuda.synchronize()
                    counts.append(read_counters())
                unequal = [k for k in frames[0]
                           if not nan_equal(frames[0][k], frames[1][k])]
                if unequal or counts[0] != counts[1] or \
                        not any(counts[0].values()):
                    raise SystemExit(f"sharded frame {what}: differs in "
                                     f"{unequal}; launches {counts}")
                add(sharded_counts, counts[1])
                all_finite(frames[1])
                # the frame body as a CUDA graph: replayed, it equals the
                # eager frame bit for bit
                packed = live.pack(params)
                reset_counters()
                graph, g_out = cuda_graph(
                    lambda: live.frame(packed, scene, c2w_d))
                g_counts = read_counters()
                graph.replay()
                torch.cuda.synchronize()
                unequal = [k for k in frames[0]
                           if not nan_equal(frames[0][k], g_out[k])]
                if unequal or g_counts != {k: 2 * v for k, v in
                                           counts[0].items()}:
                    raise SystemExit(f"graph frame {what}: differs in "
                                     f"{unequal}; launches {g_counts} for "
                                     f"a warm-up and a capture of "
                                     f"{counts[0]}")
                add(graph_counts, g_counts)
                t_live, t_shard = [], []
                for rep_ in range(MULTI_REPS):
                    pair = ((live, t_live), (shard, t_shard))
                    for fn, ts in (pair if rep_ % 2 == 0 else pair[::-1]):
                        ts.append(event_ms(lambda: fn(params, scene, c2w)))
                replay = event_chunk_ms(graph.replay, MULTI_REPS)
                del graph, g_out

                def frame_step(c):
                    o = live.frame(packed, scene, c2w_d + 1e-7 * c)
                    return c + o["rgb1"][0, 0, 0] * 1e-9

                reset_counters()
                steady = amortized_timer(frame_step,
                                         torch.zeros((), device=device),
                                         iters=STEADY_ITERS, reps=MULTI_REPS,
                                         null_ms=null_ms)
                add(graph_counts, read_counters())
                eager = [timed_ms(lambda: live(params, scene, c2w), device)
                         for _ in range(MULTI_REPS)]
                prof = profile_frames(lambda: live(params, scene, c2w), 3)
                if profile:
                    say({"profile": {"path": f"multi frame {what}"} | prof})
                report[what] = {
                    "ms_sharded": statistics.median(t_shard),
                    "ms_live": statistics.median(t_live),
                    "ms_sharded_all": t_shard, "ms_live_all": t_live,
                    "steady_ms_per_frame": steady,
                    "ms_graph_replay": statistics.median(replay),
                    "ms_eager_timed": statistics.median(eager),
                    "device_busy_ms": prof["device_busy_ms_per_frame"],
                    "kernels_a_frame": prof["device_kernels_per_frame"],
                    "launches_a_frame": {k: v for k, v in counts[0].items()
                                         if v},
                    "sharded_equal_bit_for_bit": True,
                    "graph_equal_bit_for_bit": True,
                    "statics_windows": [shard.statics.gather_tiles,
                                        shard.statics.gather_window_rows]}
            torch.cuda.empty_cache()
    finally:
        launch.close_group()
    idle = [k for k in MULTI_PATH if sharded_counts.get(k, 0) < 1]
    if idle:
        raise SystemExit(f"kernels never launched on the sharded path: "
                         f"{idle}")
    return report, sharded_counts, graph_counts


def phase_multi(device, profile=False):
    """Several scenes in one run, the sharded renderer, the frame as a CUDA
    graph (``multi_training``, ``multi_steps``, ``multi_frames``)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_multi_") as tmp:
        report = {"train_multi": multi_training(tmp),
                  "world_of_one": multi_world_of_one(tmp, device)}
        say({"multi": report})
        report["steps"] = multi_steps(tmp, device, profile)
        say({"multi": {"steps": report["steps"]}})
        frames, sharded, graphs = multi_frames(tmp, device, profile)
    report["frames"] = frames
    report["card"] = nvidia_smi_line()
    say({"multi": {"frames": frames, "card": report["card"]}})
    return sharded, graphs


# ------------------------------------------------------------------ cli ----

CLI_VIEWS, CLI_FACTOR, CLI_REPS = 20, 4, 2
CLI_PATH_FRAMES = 6    # render-path: the spiral's first poses
CLI_SCAN = 4           # scan_steps of the verbs' chunked runs (2 chunks)
CLI_EXPORT_REPS = 3    # infer --from-export --timing-reps
CLI_STEADY_REPS = 3    # infer --timing-reps: the steady-state line


SCAN_K = 8         # steps a chunk in phase scan (4 stage-1 pairs)
SCAN_CHUNKS = 5    # chunks timed (median) after the capture and a warm-up


def chunk_against_eager(what, cfg, shared, scene, stage, ex, state0,
                        state, pool_d, ids_d, i_batch0, losses):
    """The chunk's result (``state``, its per-step ``losses``) against the
    eager per-step steps from ``state0`` on the same batches, fed the
    controls and noise the chunk drew (read back after it), with host
    values where the per-step loop has them. ``TRAIN_TOL``: every step's
    loss within ``loss_rel``; each optimizer's moments within
    ``grad_norm_rel`` in norm and ``grad_max_rel`` at an element, nu
    doubled (it holds squares); the params within ``param_lr`` of a step's
    lr on a ``param_share`` of elements and within 2 lr of each Adam step
    everywhere."""
    from pronerf_tpu_torch.train.state import named_params

    data = shared[0]
    kinds = ex._kinds()
    fns = {}
    if stage == 1:
        fns["nerf"], fns["sampler"] = make_step("nerf", cfg, data)[0], \
            make_step("sampler", cfg, data)[0]
    else:
        fns["joint"] = make_step("stage2", cfg, data)[0]
    eager_losses, lrs = [], []
    n = cfg.N_rand
    n_batches = max(pool_d.shape[0] // n, 1)
    for k, c in enumerate(ex.chunk_controls()):
        lr = c.pop("lr")
        lrs.append(lr)
        c["n_mult"] = int(c["n_mult"])
        c["dir_expand"], c["dir_jitter"] = bool(c["dir_expand"]), \
            bool(c["dir_jitter"])
        lo = i_batch0 + (k % n_batches) * n
        _, m = fns[kinds[k]](state0, scene, pool_d[lo:lo + n],
                             ids_d[lo:lo + n], c, lr)
        eager_losses.append(float(m["loss"]))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, eager_losses))
    row = {"losses": losses, "eager_losses": eager_losses,
           "loss_rel": loss_rel, "steps": len(losses)}
    opts = ("opt_nerf", "opt_s") if stage == 1 else ("opt",)
    for o in opts:
        for part, power in (("mu", 1), ("nu", 2)):
            g, h = state[o][part], state0[o][part]
            norm = max(float((g[k] - v).norm() / v.norm())
                       for k, v in h.items() if float(v.norm()) > 0)
            top = max(float((g[k] - v).abs().max() / v.abs().max())
                      for k, v in h.items() if float(v.abs().max()) > 0)
            row[f"{o}.{part}"] = {"norm_rel": norm, "max_rel": top}
            if norm > power * TRAIN_TOL["grad_norm_rel"] \
                    or top > power * TRAIN_TOL["grad_max_rel"]:
                raise SystemExit(f"{what}: {o}.{part} {row} ({TRAIN_TOL})")
        if state[o]["count"] != state0[o]["count"]:
            raise SystemExit(f"{what}: {o} counts {state[o]['count']} "
                             f"against {state0[o]['count']}")
    d = torch.cat([(a.detach() - b.detach()).abs().flatten() for a, b in zip(
        named_params(state["params"]).values(),
        named_params(state0["params"]).values())])
    lr = min(lrs)
    row["param_max_over_lr"] = float(d.max()) / lr
    row["param_share_within"] = float(
        (d <= TRAIN_TOL["param_lr"] * lr).float().mean())
    if not (loss_rel <= TRAIN_TOL["loss_rel"]
            and row["param_max_over_lr"] <= 2 * len(losses)
            and row["param_share_within"] >= TRAIN_TOL["param_share"]):
        raise SystemExit(f"{what}: {row} (bounds {TRAIN_TOL})")
    if state["global_step"] != state0["global_step"]:
        raise SystemExit(f"{what}: global_step {state['global_step']} "
                         f"against {state0['global_step']}")
    return row


def event_chunk_ms(fn, reps):
    """CUDA events around each of ``reps`` calls of ``fn``: the list of ms."""
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def phase_scan(device, profile=False):
    """Several training steps a dispatch (``train/fast_loop.py``) at release
    widths on the training scene: a stage-1 chunk of SCAN_K steps (4 pairs)
    and a stage-2 chunk of SCAN_K from one state, each held against the
    eager per-step steps fed the controls and noise the chunk drew; ms a
    step per-step (eager, host controls) against the graph replay of each
    step kind and against a whole chunk, with the capture's seconds, device
    busy ms and kernels a step (profiler), peak memory and the floors; an
    odd stage-1 resume taking the per-step loop with its note; a NaN state
    raising FloatingPointError at the end of its first chunk. No kernel of
    the port runs in training: every counter stays 0."""
    from pronerf_tpu_torch.config import Config
    from pronerf_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )
    from pronerf_tpu_torch.train.fast_loop import make_scan_executor
    from pronerf_tpu_torch.train.loop import run_training

    out = {"K": SCAN_K}
    reset_counters()
    with tempfile.TemporaryDirectory() as tmp:
        cfg1, cfg2 = train_config(1, tmp), train_config(2, tmp)
        shared = training_data(cfg1)
        data, pool, ids = shared
        n_train = len(data["i_train"])
        scene, params0, _, _ = step_setup(cfg1, shared, device, cfg1.N_rand)
        pool_d = torch.from_numpy(pool).to(device)
        ids_d = torch.from_numpy(ids).to(device)
        seed = cfg1.seed + 987654321
        for stage, cfg in ((1, cfg1), (2, cfg2)):
            _, init = make_step("nerf" if stage == 1 else "stage2", cfg, data)
            fresh = lambda: init(copy.deepcopy(params0), cfg.weight_decay)
            ex = make_scan_executor(cfg, data["H"], data["W"], data["focal"],
                                    n_train, stage, SCAN_K)
            state, state0 = fresh(), fresh()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, m = ex(state, scene, pool_d, ids_d, 0, seed)
            losses = ex.buf["losses"].tolist()
            capture_s = time.perf_counter() - t0
            name = f"stage{stage}"
            row = {"first_chunk_s_with_capture": capture_s,
                   "graphs": [list(k) for k in ex.graphs],
                   "mean_loss": float(m["mean_loss"]),
                   "against_eager": chunk_against_eager(
                       f"scan {name}", cfg, shared, scene, stage, ex, state0,
                       state, pool_d, ids_d, 0, losses)}
            # a whole chunk a call (draws, fill, replays, the mean), then
            # each step kind's graph alone
            i_batch = SCAN_K * cfg.N_rand

            def chunk():
                ex(state, scene, pool_d, ids_d, i_batch, seed)

            chunk()
            times = event_chunk_ms(chunk, SCAN_CHUNKS)
            row["chunk_ms"] = times
            row["ms_a_step_chunk"] = statistics.median(times) / SCAN_K
            row["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
            for kw, graph in ex.graphs.items():
                def replay(graph=graph):
                    ex.buf["k"].zero_()
                    graph.replay()

                replay()
                t = event_chunk_ms(replay, SCAN_CHUNKS)
                kind = kw[0]
                w = kw[1] or cfg.N_samples
                flops = step_flops("nerf" if kind == "nerf" else "joint",
                                   cfg.N_rand, w)
                prof = profile_frames(replay, 3)
                row[f"{kind}[{w}]"] = {
                    "ms_graph": statistics.median(t), "ms_graph_all": t,
                    "bound_ms": flops / PEAK_F32 * 1e3,
                    "device_busy_ms": prof["device_busy_ms_per_frame"],
                    "kernels_a_step": prof["device_kernels_per_frame"]}
                if profile:
                    say({"profile": {"path": f"scan {name} graph {kind}[{w}]"}
                         | prof})
            # the same step kinds eager, with host controls, as the per-step
            # loop runs them
            ctl = ex.chunk_controls()
            for k0, kind in ((0, ex._kinds()[0]), (1, ex._kinds()[1])):
                c = dict(ctl[k0])
                lr = c.pop("lr")
                c["n_mult"] = int(c["n_mult"])
                c["dir_expand"] = bool(c["dir_expand"])
                c["dir_jitter"] = bool(c["dir_jitter"])
                fn = make_step({"nerf": "nerf", "sampler": "sampler",
                                "joint": "stage2"}[kind], cfg, data)[0]
                b, bi = pool_d[:cfg.N_rand], ids_d[:cfg.N_rand]

                def eager():
                    fn(state, scene, b, bi, c, lr)

                eager()
                t = event_chunk_ms(eager, SCAN_CHUNKS)
                prof = profile_frames(eager, 3)
                w = ex.widths[0] if kind == "nerf" else cfg.N_samples
                row[f"{kind}[{w}]"] |= {
                    "ms_eager": statistics.median(t), "ms_eager_all": t,
                    "device_busy_ms_eager": prof["device_busy_ms_per_frame"],
                    "kernels_a_step_eager": prof["device_kernels_per_frame"]}
            out[name] = row
            del ex, state, state0
            torch.cuda.empty_cache()

        # explore_buckets: one graph a NeRF-step width, chosen on the host
        # from the chunk's n_mult (one read a chunk)
        cfg_b = train_config(1, tmp, explore_buckets=True)
        _, init = make_step("nerf", cfg_b, data)
        ex = make_scan_executor(cfg_b, data["H"], data["W"], data["focal"],
                                n_train, 1, SCAN_K)
        state = init(copy.deepcopy(params0), cfg_b.weight_decay)
        state0 = init(copy.deepcopy(params0), cfg_b.weight_decay)
        state, m = ex(state, scene, pool_d, ids_d, 0, seed)
        row = {"graphs": [list(k) for k in ex.graphs],
               "widths_drawn": [w for (k, w) in ex.graphs if k == "nerf"],
               "against_eager": chunk_against_eager(
                   "scan stage1 explore_buckets", cfg_b, shared, scene, 1,
                   ex, state0, state, pool_d, ids_d, 0,
                   ex.buf["losses"].tolist())}

        def chunk():
            ex(state, scene, pool_d, ids_d, SCAN_K * cfg_b.N_rand, seed)

        times = event_chunk_ms(chunk, SCAN_CHUNKS)
        row["ms_a_step_chunk"] = statistics.median(times) / SCAN_K
        row["graphs_after_timing"] = [list(k) for k in ex.graphs]
        out["stage1_explore_buckets"] = row
        del ex, state, state0
        torch.cuda.empty_cache()
        expect_counts("scan (training runs no kernel)", read_counters())

        # an odd stage-1 resume takes the per-step loop, with its note
        base = dict(datadir=cfg1.datadir, basedir=tmp, expname="odd",
                    i_print=1, i_weights=1000, i_img=0, i_testset=0,
                    i_video=0, pretrain_path="")
        run_training(Config.from_file(
            ROOT / "configs/llff/fern/fern_epi.txt", max_steps=3,
            **base), 1, device=device)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            run_training(Config.from_file(
                ROOT / "configs/llff/fern/fern_epi.txt", max_steps=4,
                scan_steps=4, **base), 1, device=device)
        if "requires an even resume step" not in log.getvalue():
            raise SystemExit(f"odd resume: no note in {log.getvalue()!r}")
        last = Path(latest_checkpoint(Path(tmp) / "odd")).name
        if last != "000007.ckpt":
            raise SystemExit(f"odd resume: last checkpoint {last}")
        out["odd_resume"] = {"note": True, "last_checkpoint": last}

        # a NaN state stops at the end of its first chunk
        ck_file = latest_checkpoint(Path(tmp) / "odd")
        ck = load_checkpoint(ck_file)
        w0 = next(k for k in ck["network_fn"] if k.endswith("weight"))
        ck["network_fn"][w0] = torch.full_like(ck["network_fn"][w0],
                                               float("nan"))
        ck["global_step"] = 8
        save_checkpoint(Path(ck_file).with_name("000008.ckpt"), ck)
        try:
            run_training(Config.from_file(
                ROOT / "configs/llff/fern/fern_epi.txt", max_steps=8,
                scan_steps=4, **(base | {"i_print": 1000000})), 1,
                device=device)
        except FloatingPointError as e:
            if "chunk" not in str(e):
                raise
            out["nan_chunk"] = {"raised": str(e)}
        else:
            raise SystemExit("a NaN state trained on without raising")
    out["floors_ms"] = {"nerf[64]": step_flops("nerf", 4096, 64) / PEAK_F32
                        * 1e3, "joint[8]": step_flops("joint", 4096, 8)
                        / PEAK_F32 * 1e3}
    out["card"] = nvidia_smi_line()
    say({"scan": out})
    return out


EXPORT_REPS = 9   # timed frames a pose of the exported and live renderer


def export_case(what, cfg, height, width, device, tmp):
    """``run_export`` of ``cfg`` at height x width, the program loaded
    back, and its frames on the 3 held-out poses against the live
    ``make_frame_renderer`` of the manifest's statics with the same params
    and scene: equal bit for bit, the same launches a frame (counters zeroed
    before and read after a frame a pose of each), then both timed in turns
    by CUDA events (EXPORT_REPS a pose each)."""
    from pronerf_tpu_torch.render import infer
    from pronerf_tpu_torch.render.export import (
        load_exported_renderer,
        statics_from_manifest,
    )
    from pronerf_tpu_torch.render.renderer import make_frame_renderer

    cfg = cfg.replace(basedir=tmp, expname=what)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paths = infer.run_export(cfg, height=height, width=width)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    call, params, scene, manifest = load_exported_renderer(
        paths["executable"])
    load_s = time.perf_counter() - t0
    statics = statics_from_manifest(manifest)
    live = make_frame_renderer(statics, height, width,
                               np.asarray(manifest["K"], np.float32),
                               manifest["tile_rays"], device=device)
    data = infer.load_inference_data(cfg)
    poses = [data["poses"][i][:3, :4] for i in data["i_test"][:3]]
    def frames(render):
        """A frame a pose; the launches (counters zeroed just before, read
        just after) and the peak memory."""
        reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        outs = [render(params, scene, c2w) for c2w in poses]
        torch.cuda.synchronize()
        all_finite(outs[0])
        return outs, read_counters(), torch.cuda.max_memory_allocated()

    with torch.no_grad():
        exp, exp_counts, exp_peak = frames(call)
        ref, ref_counts, _ = frames(live)
        # timed in turns (exported, live, live, exported, ...): a
        # host-bound frame's time drifts within a run
        t_exp, t_live = [], []
        for c2w in poses:
            for r in range(EXPORT_REPS):
                pair = ((call, t_exp), (live, t_live))
                for fn, out in (pair if r % 2 == 0 else pair[::-1]):
                    out.append(event_ms(lambda: fn(params, scene, c2w)))
    if exp_counts != ref_counts or not any(exp_counts.values()):
        raise SystemExit(f"{what}: the exported program's launches "
                         f"{exp_counts}, the live renderer's {ref_counts}")
    unequal = sorted({k for a, b in zip(exp, ref) for k in a
                      if not nan_equal(a[k], b[k])})
    if unequal:
        raise SystemExit(f"{what}: exported frames differ from live ones "
                         f"in {unequal}")
    n = len(poses)
    return {
        "H": height, "W": width, "statics": {
            k: manifest["statics"][k] for k in (
                "compute_dtype", "use_kernels", "quant", "transposed",
                "gather_tiles", "gather_window_rows", "fuse_composite")},
        "manifest_keys": sorted(manifest), "platforms": manifest["platforms"],
        "export_s": export_s, "load_s": load_s,
        "artifact_bytes": {k: p.stat().st_size for k, p in paths.items()},
        "frames_compared": n, "equal_bit_for_bit": True,
        "launches_a_frame": {k: v / n for k, v in exp_counts.items() if v},
        "launches": exp_counts,
        "ms_per_frame_exported": statistics.median(t_exp),
        "ms_per_frame_live": statistics.median(t_live),
        "ms_all_exported": t_exp, "ms_all_live": t_live,
        "peak_mem_bytes_exported": exp_peak,
    }


def phase_export(device):
    """The exported renderer (``render/export.py``): ``run_export`` at
    1008x756 with the ``--use-trt`` serving statics (the windowed gather
    resolved as the manifest records it), then ``quant = int8`` and
    ``transposed = True`` at 504x378; each loaded back and held against the
    live renderer (``export_case``). Its drive's launches count on the
    kernels line."""
    from pronerf_tpu_torch.config import Config

    def cfg_of(w, h, **kw):
        return Config.from_file(
            ROOT / "configs/llff/fern/fern_trt.txt",
            datadir=f"synthetic:{w}x{h}x{N_VIEWS}", use_trt=True,
            tile_rays=0, use_pallas=True, ft_path="", **kw)

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as tmp:
        out["default_1008x756"] = export_case(
            "export_full", cfg_of(FULL_W, FULL_H), FULL_H, FULL_W, device,
            tmp)
        st = out["default_1008x756"]["statics"]
        if (st["gather_tiles"], st["gather_window_rows"]) != \
                FULL_GATHER:
            raise SystemExit(f"export at 1008x756 resolved the windows to "
                             f"{st}, not {FULL_GATHER}")
        out["int8_504x378"] = export_case(
            "export_int8", cfg_of(W_IMG, H, quant="int8"), H, W_IMG, device,
            tmp)
        out["transposed_504x378"] = export_case(
            "export_t", cfg_of(W_IMG, H, transposed=True), H, W_IMG, device,
            tmp)
    out["card"] = nvidia_smi_line()
    say({"export": out})
    launches = {}
    for case in out.values():
        if isinstance(case, dict):
            for k, v in case["launches"].items():
                launches[k] = launches.get(k, 0) + v
    return launches


def paeth_png(path, img):
    """``img`` (uint8 [H, W, 3]) as a PNG whose every row carries the Paeth
    filter, the costliest for a reader to undo (PIL's encoder picks it for
    most rows of a photo); for timing ``read_png`` on such a file."""
    import zlib

    from pronerf_tpu_torch.utils import png

    x = img.astype(np.int32)
    a, b, c = (np.zeros_like(x) for _ in range(3))
    a[:, 1:], b[1:], c[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = ((x - pred) & 255).astype(np.uint8).reshape(len(img), -1)
    raw = np.concatenate([np.full((len(img), 1), 4, np.uint8), rows], 1)
    h, w = img.shape[:2]
    with open(path, "wb") as fh:
        fh.write(png._SIGNATURE)
        fh.write(png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                                 0)))
        fh.write(png._chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        fh.write(png._chunk(b"IEND", b""))


def drive_cli(argv):
    """One run of ``cli.main``: counters zeroed just before, read just
    after."""
    from pronerf_tpu_torch import cli

    reset_counters()
    t0 = time.perf_counter()
    result = cli.main(argv)
    torch.cuda.synchronize()
    return result, read_counters(), time.perf_counter() - t0


def phase_cli(device):
    """The slice's main path: the command line on an LLFF capture of fern's
    shape (the consistent synthetic scene, 20 views, ``images_4`` PNGs of
    504x378, ``poses_bounds.npy`` at the raw scale, a binary COLMAP model
    with projected visibility): train-stage1, train-stage2 from its expdir,
    eval --use-trt through the kernels, infer --use-trt with int8,
    render-path --use-trt to a GIF (frame 0 against a direct render, within
    the palette's bound), and a stage-1 run with i_video = 2 that writes
    its spiral videos."""
    from pronerf_tpu_torch import native
    from pronerf_tpu_torch.config import Config
    from pronerf_tpu_torch.data.colmap import greedy_reference_views
    from pronerf_tpu_torch.data.llff import load_llff_data
    from pronerf_tpu_torch.render import infer
    from pronerf_tpu_torch.render.raygen import build_ray_pool, prepare_scene
    from pronerf_tpu_torch.render.renderer import make_frame_renderer
    from pronerf_tpu_torch.train import checkpoint
    from pronerf_tpu_torch.ops.metrics import to8b
    from pronerf_tpu_torch.utils import gif
    from pronerf_tpu_torch.utils.fixtures import write_llff_scene
    from pronerf_tpu_torch.utils.png import read_png
    from pronerf_tpu_torch.utils.synthetic import make_consistent_scene

    timings = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        root = Path(tmp) / "fern"
        t0 = time.perf_counter()
        sc = make_consistent_scene(seed=0, W=W_IMG, H=H, n_views=CLI_VIEWS)
        timings["make_scene_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        write_llff_scene(root, sc, factor=CLI_FACTOR)
        timings["write_capture_s"] = time.perf_counter() - t0
        pngs = sorted((root / f"images_{CLI_FACTOR}").glob("*.png"))
        t0 = time.perf_counter()
        decoded = [read_png(p) for p in pngs]
        timings["decode_pngs_s"] = time.perf_counter() - t0
        paeth_png(Path(tmp) / "paeth.png", decoded[0])
        t0 = time.perf_counter()
        paeth = read_png(Path(tmp) / "paeth.png")
        timings["decode_paeth_png_s"] = time.perf_counter() - t0
        if len(pngs) != CLI_VIEWS or not np.array_equal(paeth, decoded[0]):
            raise SystemExit(f"capture: {len(pngs)} PNGs, Paeth decode "
                             f"equal {np.array_equal(paeth, decoded[0])}")
        t0 = time.perf_counter()
        images, poses, _, _, _ = load_llff_data(root, factor=CLI_FACTOR)
        timings["load_capture_s"] = time.perf_counter() - t0
        if images.shape != (CLI_VIEWS, H, W_IMG, 3):
            raise SystemExit(f"loaded capture of shape {images.shape}")

        def common(expname):
            return ["--", "--datadir", str(root), "--basedir", tmp,
                    "--expname", expname, "--i_print", "1", "--i_weights",
                    "1000", "--i_img", "0", "--i_testset", "0", "--i_video",
                    "0"]

        # ---- training: the pool (native) and the steps; no kernel runs
        pools = native.build_ray_pool_native.calls
        (s1, exp1), c1, wall1 = drive_cli(
            ["train-stage1", "--config",
             str(ROOT / "configs/llff/fern/fern_epi.txt"), "--max-steps",
             str(TRAIN_STEPS[1])] + common("cli_s1"))
        (s2, exp2), c2, wall2 = drive_cli(
            ["train-stage2", "--config",
             str(ROOT / "configs/llff/fern/fern_refine.txt"), "--max-steps",
             str(TRAIN_STEPS[2]), "--pretrain-path", str(exp1)]
            + common("cli_s2"))
        expect_counts("cli training", c1)
        expect_counts("cli training", c2)
        losses = list(read_losses(exp1).values()) + list(
            read_losses(exp2).values())
        if native.build_ray_pool_native.calls != pools + 2 or \
                s2["global_step"] != TRAIN_STEPS[2] or \
                not all(np.isfinite(losses)):
            raise SystemExit(f"cli training: native pools "
                             f"{native.build_ray_pool_native.calls - pools}"
                             f", losses {losses}")
        ck2 = checkpoint.latest_checkpoint(exp2)

        # ---- serving through the kernels: eval (bf16), infer (int8)
        vis = native.colmap_visibility_native.calls
        ev, c_ev, wall_ev = drive_cli(
            ["eval", "--use-trt", "--checkpoint", ck2, "--timing-reps",
             str(CLI_REPS)] + common("cli_eval"))
        q, c_q, wall_q = drive_cli(
            ["infer", "--use-trt", "--checkpoint", ck2]
            + common("cli_int8") + ["--quant", "int8"])
        n_ev = len(ev["rgbs1"]) * (1 + CLI_REPS) + steady_frames(CLI_REPS)
        n_q = len(q["rgbs1"])
        expect_counts("cli eval", c_ev, sampler=n_ev, refine=n_ev,
                      fused_nerf_raw_t=n_ev)
        expect_counts("cli int8 infer", c_q, sampler=n_q, refine=n_q,
                      fused_nerf_raw_tq=n_q)
        all_finite({"eval": ev["rgbs1"], "int8": q["rgbs1"],
                    "psnr": np.array(ev["psnrs"] + q["psnrs"])})
        saved = sorted(p.name for p in
                       (Path(tmp) / "cli_eval" / "renderonly_test").iterdir())
        if native.colmap_visibility_native.calls != vis + 2 or \
                len(ev["rgbs1"]) != 3 or ev["rgbs1"].shape[1:] != (
                    H, W_IMG, 3) or "002.png" not in saved:
            raise SystemExit(f"cli serving: visibility scans "
                             f"{native.colmap_visibility_native.calls - vis}"
                             f", frames {ev['rgbs1'].shape}, PNGs {saved}")
        # the steady-state line of infer --timing-reps (a CUDA graph of the
        # frame, replayed), and the JAX command line's two summary lines
        # after it: the timed eager frames under their own name, then
        # "Median render ms/frame", which is the steady-state figure
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            st, c_st, wall_st = drive_cli(
                ["infer", "--use-trt", "--checkpoint", ck2, "--max-images",
                 "1", "--timing-reps", str(CLI_STEADY_REPS)]
                + common("cli_steady"))
        lines = log.getvalue().splitlines()
        steady_lines = [ln for ln in lines
                        if ln.startswith("Steady-state render ms/frame (scan "
                                         f"x{CLI_STEADY_REPS} minus ")]
        n_st = 1 + CLI_STEADY_REPS + steady_frames(CLI_STEADY_REPS)
        expect_counts("cli infer --timing-reps", c_st, sampler=n_st,
                      refine=n_st, fused_nerf_raw_t=n_st)
        if len(steady_lines) != 1 or not st["amortized_ms"] > 0:
            raise SystemExit(f"infer --timing-reps {CLI_STEADY_REPS}: "
                             f"steady-state lines {steady_lines}")
        steady = steady_lines[0].rsplit(": ", 1)[1]
        summary = lines[-2:]
        per_dispatch = (
            "Median per-dispatch ms/frame (CUDA events around one eager "
            f"frame on {torch.cuda.get_device_name(0)}): "
            f"{statistics.median(st['times_ms']):.3f}")
        if not (summary[0] == per_dispatch
                and summary[1].startswith(f"Median render ms/frame: {steady} (")
                and summary[1].endswith(" Mrays/s, steady-state)")
                and sum(ln.startswith("Median") for ln in lines) == 2
                and lines.index(steady_lines[0]) < len(lines) - 2):
            raise SystemExit(f"infer --timing-reps {CLI_STEADY_REPS}: "
                             f"summary lines {summary}, steady-state line "
                             f"{steady_lines[0]}")
        for ln in (steady_lines[0], *summary):
            print(ln, flush=True)
        steady_report = {"line": steady_lines[0], "summary": summary,
                         "amortized_ms": st["amortized_ms"],
                         "null_ms": st["null_ms"],
                         "times_ms": st["times_ms"], "launches": c_st,
                         "wall_s": wall_st}

        # ---- the reference views: the native pick is the Python path's;
        # the served frame equals a render from the checkpoint's params
        cfg = Config.from_file(
            ROOT / "configs/llff/fern/fern_trt.txt", datadir=str(root),
            use_trt=True, tile_rays=0, use_pallas=True, basedir=tmp)
        data = infer.load_inference_data(cfg)
        i_train = [i for i in range(CLI_VIEWS) if i not in data["i_test"]]
        python_pick = greedy_reference_views(root / "sparse/0", i_train,
                                             cfg.num_neighbor, native=False)
        if not np.array_equal(data["i_ref"], python_pick):
            raise SystemExit(f"i_ref {data['i_ref']} against the Python "
                             f"path's {python_pick}")
        scene = prepare_scene(
            data["images"][data["i_ref"]], data["poses"][data["i_ref"]],
            data["K"], pack_corners="u8", device=device)
        render = make_frame_renderer(infer._infer_statics(cfg, True), H,
                                     W_IMG, data["K"], 0, device=device)
        params2 = infer.load_params_for_inference(ck2, cfg, device)
        with torch.no_grad():
            direct = render(params2, scene,
                            data["poses"][data["i_test"][0]])["rgb1"]
        served_err = max_err(torch.from_numpy(ev["rgbs1"][0]).to(device),
                             direct)
        if served_err != 0.0:
            raise SystemExit(f"eval frame against the checkpoint's params: "
                             f"{served_err}")

        # ---- render-path through the kernels: the spiral's first poses,
        # written as a GIF (the port's own writer where imageio is absent)
        rp, c_rp, wall_rp = drive_cli(
            ["render-path", "--use-trt", "--checkpoint", ck2, "--n-frames",
             str(CLI_PATH_FRAMES)] + common("cli_rp"))
        expect_counts("cli render-path", c_rp, sampler=CLI_PATH_FRAMES,
                      refine=CLI_PATH_FRAMES,
                      fused_nerf_raw_t=CLI_PATH_FRAMES)
        if not rp.endswith(".gif"):
            raise SystemExit(f"render-path wrote {rp}, not a GIF")
        t0 = time.perf_counter()
        rp_frames, rp_delays = gif.read_gif(rp)
        timings["read_gif_s"] = time.perf_counter() - t0
        with torch.no_grad():
            d8 = to8b(render(params2, scene, data["render_poses"][0])["rgb1"]
                      .cpu().numpy())
        rp_err = np.abs(rp_frames[0].astype(int) - d8).max(axis=(0, 1))
        render_path_report = {
            "path": Path(rp).name, "frames": len(rp_frames),
            "delays_cs": rp_delays, "launches": c_rp, "wall_s": wall_rp,
            "frame0_max_err_per_channel": rp_err.tolist(),
            "palette_bound": list(gif.PALETTE_MAX_ERR),
            "frame0_is_palette_of_direct": bool(np.array_equal(
                rp_frames[0], gif.palette()[gif.quantize(d8)])),
        }
        if rp_frames.shape != (CLI_PATH_FRAMES, H, W_IMG, 3) or not all(
                e <= b for e, b in zip(rp_err, gif.PALETTE_MAX_ERR)):
            raise SystemExit(f"render-path GIF: {render_path_report}")

        # ---- several steps a dispatch through the verbs: chunks of 4
        # (CUDA graphs of the steps), checkpoints at the last step
        (s1s, exp1s), c1s, wall1s = drive_cli(
            ["train-stage1", "--config",
             str(ROOT / "configs/llff/fern/fern_epi.txt"), "--max-steps",
             str(2 * CLI_SCAN)] + common("cli_s1_scan")
            + ["--scan_steps", str(CLI_SCAN)])
        (s2s, exp2s), c2s, wall2s = drive_cli(
            ["train-stage2", "--config",
             str(ROOT / "configs/llff/fern/fern_refine.txt"), "--max-steps",
             str(2 * CLI_SCAN), "--pretrain-path", str(exp1s)]
            + common("cli_s2_scan") + ["--scan_steps", str(CLI_SCAN)])
        expect_counts("cli scan training", c1s)
        expect_counts("cli scan training", c2s)
        scan_ckpts = [Path(checkpoint.latest_checkpoint(e)).name
                      for e in (exp1s, exp2s)]
        scan_losses = list(read_losses(exp1s).values()) + list(
            read_losses(exp2s).values())
        if scan_ckpts != [f"{2 * CLI_SCAN:06d}.ckpt"] * 2 or not all(
                np.isfinite(scan_losses)):
            raise SystemExit(f"cli scan training: checkpoints {scan_ckpts}, "
                             f"losses {scan_losses}")
        scan_report = {"scan_steps": CLI_SCAN, "steps": 2 * CLI_SCAN,
                       "wall_s": {"stage1": wall1s, "stage2": wall2s},
                       "losses": scan_losses, "checkpoints": scan_ckpts}

        # ---- export at the capture's size, then serve from it: the PNG
        # equals the eval frame's
        paths, c_x, wall_x = drive_cli(
            ["export", "--use-trt", "--checkpoint", ck2, "--height", str(H),
             "--width", str(W_IMG)] + common("cli_export"))
        expect_counts("cli export (traced, no launch)", c_x)
        fx, c_fx, wall_fx = drive_cli(
            ["infer", "--from-export", str(paths["executable"].parent),
             "--max-images", "1", "--timing-reps", str(CLI_EXPORT_REPS)]
            + common("cli_export"))
        n_fx = 1 + CLI_EXPORT_REPS + max(2, CLI_EXPORT_REPS)
        expect_counts("cli infer --from-export", c_fx, sampler=n_fx,
                      refine=n_fx, fused_nerf_raw_t=n_fx)
        png = read_png(Path(fx["savedir"]) / "000.png")
        if not np.array_equal(png, to8b(ev["rgbs1"][0])):
            raise SystemExit("infer --from-export: its PNG differs from the "
                             "eval frame's")
        export_report = {
            "export_wall_s": wall_x, "serve_wall_s": wall_fx,
            "launches": c_fx, "frames": n_fx, "psnr": fx["psnrs"],
            "times_ms": fx["times_ms"], "pipelined_ms": fx["pipelined_ms"],
            "artifact_bytes": {k: p.stat().st_size
                               for k, p in paths.items()},
            "png_equals_eval_frame": True}

        # ---- i_video: a 4-step stage-1 run writes its spiral at steps 2
        # and 4 (the stage's eval statics: no kernel runs), each of the
        # capture's 120 spiral poses rendered as one tile (24 times fewer
        # launches than the configs' 8,192-ray tiles on the plain f32 path)
        (_, exp_v), c_v, wall_v = drive_cli(
            ["train-stage1", "--config",
             str(ROOT / "configs/llff/fern/fern_epi.txt"), "--max-steps",
             str(TRAIN_STEPS[1])] + common("cli_video")
            + ["--i_video", "2", "--tile_rays", "0"])
        expect_counts("cli i_video", c_v)
        videos = sorted(p.name for p in Path(exp_v).glob("spiral_*"))
        spiral, _ = gif.read_gif(Path(exp_v) / videos[-1])
        video_report = {"videos": videos, "frames": len(spiral),
                        "wall_s": wall_v, "launches": c_v}
        if videos != ["spiral_000002.gif", "spiral_000004.gif"] or \
                spiral.shape != (len(data["render_poses"]), H, W_IMG, 3):
            raise SystemExit(f"i_video: {video_report}")

        # ---- host times of the pool, native and NumPy
        for native_pool in (True, False):
            t0 = time.perf_counter()
            build_ray_pool(images, poses[:, :3, :4], data["K"], i_train,
                           cfg.num_neighbor, np.random.default_rng(0),
                           native=native_pool)
            timings[f"pool_{'native' if native_pool else 'numpy'}_s"] = \
                time.perf_counter() - t0
        timings["native_build"] = dict(native.build_info)
        timings["eval_ms_per_frame"] = statistics.median(ev["times_ms"])
        timings["render_path_wall_s"] = wall_rp
        timings["i_video_run_wall_s"] = wall_v
        timings["card"] = nvidia_smi_line()
        report = {
            "capture": {"views": CLI_VIEWS, "factor": CLI_FACTOR,
                        "size": [W_IMG, H], "i_test": data["i_test"].tolist(),
                        "i_ref": data["i_ref"].tolist()},
            "train": {"wall_s": {"stage1": wall1, "stage2": wall2},
                      "losses": losses, "native_pools": 2},
            "eval": {"launches": c_ev, "frames": n_ev, "wall_s": wall_ev,
                     "psnr": ev["psnrs"], "times_ms": ev["times_ms"],
                     "served_vs_direct_max_err": served_err,
                     "visibility_scans_native": 2},
            "int8": {"launches": c_q, "frames": n_q, "wall_s": wall_q,
                     "psnr": q["psnrs"]},
            "steady_state": steady_report,
            "render_path": render_path_report,
            "i_video": video_report,
            "scan": scan_report,
            "export": export_report,
        }
    say({"cli": report})
    say({"cli_timings": timings})
    return report


# ---------------------------------------------------------------- main ----

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only",
                    choices=("build", "kernels", "frame", "fullres",
                             "gathers", "train", "scan", "donerf", "export",
                             "multi", "cli"))
    ap.add_argument("--rays", type=int, default=FRAME_RAYS)
    ap.add_argument("--verbose-build", action="store_true",
                    help="print the compiler's output of every source")
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel name for the "
                         "fused-composite, the int8 and the transposed "
                         "frame, each 1008x756 form, and each training "
                         "step (torch.profiler)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is "
                         "available (it does not run on the CPU)")
    import pronerf_tpu_torch  # noqa: F401  (switches TF32 off)
    from pronerf_tpu_torch.kernels import build

    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    say({"device": {"nvidia_smi": smi, "torch": torch.__version__,
                    "cuda": torch.version.cuda,
                    "name": torch.cuda.get_device_name(0)}})

    t0 = time.perf_counter()
    logs = build.build_all()
    seconds = time.perf_counter() - t0
    if args.verbose_build:
        for name in build.sources():
            print(f"--- nvcc {name}\n{build.ptxas_log(name)}", flush=True)
    from pronerf_tpu_torch import native

    if not native.is_available():
        raise SystemExit("the host runtime's library (g++) did not build")
    say({"build": {"seconds": seconds, "built": sorted(logs),
                   "sources": build.sources(), "ptxas": check_build(),
                   "conversions": conversion_counts(),
                   "native": native.build_info}})

    rows, launches = [], {}
    if args.only in (None, "kernels"):
        rows = phase_kernels(device, args.rays)
    if args.only in (None, "frame"):
        launches = phase_frame(device, args.profile)
    if args.only in (None, "fullres"):
        launches |= phase_fullres(device, args.profile)
    if args.only in (None, "gathers"):
        phase_gathers(device)
    if args.only in (None, "train"):
        phase_train(device, args.profile)
    if args.only in (None, "scan"):
        phase_scan(device, args.profile)
    if args.only in (None, "donerf"):
        phase_donerf(device)
    export_launches = {}
    if args.only in (None, "export"):
        export_launches = phase_export(device)
    sharded_launches, graph_launches = {}, {}
    if args.only in (None, "multi"):
        sharded_launches, graph_launches = phase_multi(device, args.profile)
    if args.only in (None, "cli"):
        phase_cli(device)

    print(smi, flush=True)
    contract = []
    for r in rows:
        if r["dtype"] != DTYPES.get(r["name"], BOTH)[0]:
            continue  # the instantiation the main path runs
        contract.append({
            k: r[k] for k in ("name", "route", "source", "replaces",
                              "max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")
        } | {"launches": launches.get(r["name"], 0),
             "launches_exported": export_launches.get(r["name"], 0),
             "launches_sharded": sharded_launches.get(r["name"], 0),
             "launches_graph": graph_launches.get(r["name"], 0)})
    if args.only is None:
        idle = [c["name"] for c in contract if c["launches"] < 1]
        if launches.get(UNTRANSPOSED, 0) < 1:
            idle.append(UNTRANSPOSED)
        if idle:
            raise SystemExit(f"kernels never launched on the main path: {idle}")
    say({"kernels": contract})
    say({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
