"""Build and bind the CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library ``_build/lib<name>-<hash>.so`` (the hash covers every file under
``csrc/``, so an edited source is rebuilt and a stale library is never
loaded), with the compiler's output beside it in ``lib<name>-<hash>.log``:
``ptxas -v`` reports each kernel's registers, spills and any ``wgmma`` it
had to serialize (:func:`ptxas_log`); :func:`sass_opcodes` counts a
kernel's instructions in a built library. ``nvcc`` compiles such a file in
seconds; nothing here includes PyTorch's headers. The libraries are loaded with ``ctypes``; the wrappers in
``fused_minmax.py`` / ``fused_nerf.py`` set ``argtypes`` (``c_void_p`` for
every pointer and for the stream, or ctypes would cut them to 32 bits).

Nothing happens at import: the first launch of a kernel calls :func:`load`,
which builds if needed. :func:`build_all` starts one ``nvcc`` per source at
once, for callers that want the whole set up front. Each library loaded and
each one built is counted in ``utils/profiling.COUNTERS`` (``kernel_loads``,
``kernel_builds``).

The libraries live in ``_build/`` beside this file, or in the directory
that ``PRONERF_KERNEL_CACHE`` names (read at each build or load; the
counterpart of the JAX package's ``PRONERF_XLA_CACHE``): an empty directory
there means a cold start, which builds every source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

from pronerf_tpu_torch.utils.profiling import COUNTERS

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CACHE_ENV = "PRONERF_KERNEL_CACHE"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict = {}


def sources() -> list:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of pronerf_tpu_torch cannot be built on this machine"
    )


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def build_dir() -> Path:
    """Where the libraries are built and loaded from: ``$PRONERF_KERNEL_CACHE``
    if set, else ``BUILD_DIR``."""
    return Path(os.environ.get(CACHE_ENV) or BUILD_DIR)


def lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{_digest()}.so"


def log_path(name: str) -> Path:
    return lib_path(name).with_suffix(".log")


def ptxas_log(name: str) -> str:
    """The compiler's output of the library built from ``csrc/<name>.cu``
    (empty if it has not been built)."""
    p = log_path(name)
    return p.read_text() if p.exists() else ""


def sass_opcodes(lib: Path, kernel: str) -> dict:
    """{function: {opcode: count}} of the entry functions whose (mangled) name
    holds ``kernel`` in the SASS of the library ``lib`` (``cuobjdump -sass``,
    from the toolkit that holds ``nvcc``)."""
    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    funcs, counts = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            counts = funcs.setdefault(m.group(1), {}) if kernel in m.group(1) \
                else None
        elif counts is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_]*)", line)
            if m:
                counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return funcs


def _command(name: str, out: Path) -> list:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def _finish(name: str, proc, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    log_path(name).write_text(log)
    os.replace(tmp, out)
    return log


def build_all() -> dict:
    """Build every missing library, all ``nvcc`` processes started together.
    Returns {name: compiler output} for the ones that were built."""
    build_dir().mkdir(parents=True, exist_ok=True)
    running = []
    for name in sources():
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        proc = subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        running.append((name, proc, tmp, out))
    COUNTERS["kernel_builds"] += len(running)
    return {n: _finish(n, p, t, o) for n, p, t, o in running}


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if it is not there."""
    lib = _loaded.get(name)
    if lib is None:
        out = lib_path(name)
        if not out.exists():
            build_all()
        lib = _loaded[name] = ctypes.CDLL(str(out))
        COUNTERS["kernel_loads"] += 1
    return lib
