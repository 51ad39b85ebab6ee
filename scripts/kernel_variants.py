"""Shared parts of the kernel-variant scripts (``torch_minmax_variants.py``,
``torch_nerf_q_variants.py``): copies of ``pronerf_tpu_torch/kernels/csrc``
with text substitutions, built with ``nvcc`` one process per variant (started
together), the opcode counts of a kernel in a library's SASS, CUDA-event
times, and the card's name and power limit. Needs a CUDA card and the CUDA
toolkit; nothing here runs on import.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from pronerf_tpu_torch.kernels import build  # noqa: E402

# the opcodes of the conversion pipe that an epilogue may be built from
CONVERSIONS = ("I2F", "F2I", "FRND", "I2FP", "F2IP")


def build_variants(source, variants, names, tmp: Path, symbol, argtypes,
                   parent: Path | None = None):
    """{name: (C function, its library's path, ptxas' lines on registers,
    spills and serialized products)} for every variant in ``names``: the
    sources under ``csrc`` with each ``(file, old, new)`` of
    ``variants[name]`` applied (every occurrence; a missing ``old`` fails),
    ``csrc/<source>.cu`` built into ``tmp/<name>/lib<source>.so``. With
    ``parent`` (the root of another checkout, e.g. the parent commit unpacked
    by ``git archive``), the variant ``parent`` is that tree's sources as
    they are."""
    procs = {}
    for name in names:
        d = tmp / name
        d.mkdir()
        csrc = (parent / build.CSRC.relative_to(ROOT) if name == "parent"
                else build.CSRC)
        for src in csrc.iterdir():
            if src.suffix in (".cu", ".cuh"):
                shutil.copy(src, d / src.name)
        for fname, old, new in variants.get(name, ()):
            text = (d / fname).read_text()
            if old not in text:
                raise SystemExit(f"{name}: {old!r} not in {fname}")
            (d / fname).write_text(text.replace(old, new))
        out = d / f"lib{source}.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
             str(d / f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(out)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        libs[name] = (fn, out, [ln.strip() for ln in log.splitlines()
                                if "Used" in ln or "spill" in ln
                                or "serialized" in ln])
    return libs


def sass_counts(lib: Path, kernel):
    """Opcodes of the functions whose name holds ``kernel`` in the library's
    SASS: the total, the most frequent, and those of the conversion pipe."""
    counts = {}
    for ops in build.sass_opcodes(lib, kernel).values():
        for op, n in ops.items():
            counts[op] = counts.get(op, 0) + n
    return {"total": sum(counts.values()),
            "top": sorted(counts.items(), key=lambda kv: -kv[1])[:24],
            "conversions": {op: counts.get(op, 0) for op in CONVERSIONS}}


def cuda_times(launch, reps):
    """ms of each of ``reps`` launches by CUDA events, after one to warm up."""
    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        launch()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times


def interleaved_times(launches, reps):
    """{name: ms of each of ``reps`` launches} for every launch function in
    ``launches``, by CUDA events, after one each to warm up: one launch of
    every variant in turn, the order reversed from one turn to the next, so
    that a drift of the card's clock over the run falls on all of them
    alike."""
    names = list(launches)
    for name in names:
        launches[name]()
    torch.cuda.synchronize()
    times = {name: [] for name in names}
    for r in range(reps):
        for name in names if r % 2 == 0 else names[::-1]:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            launches[name]()
            b.record()
            torch.cuda.synchronize()
            times[name].append(a.elapsed_time(b))
    return times


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
