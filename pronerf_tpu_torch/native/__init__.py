"""ctypes bindings of the host runtime, ``csrc/*.cpp``.

Counterpart of ``pronerf_tpu/native/__init__.py``, with the same functions
and the same rule: a caller takes the native path whenever the library loads
(:func:`is_available`) and its NumPy path otherwise.
``csrc/pronerf_native.cpp`` is the JAX package's runtime (ray pool, COLMAP
scan); ``csrc/jpeg_decode.cpp`` adds the port's JPEG decoder
(:func:`decode_jpeg_native`, the twin of
``utils/jpeg.py:decode_jpeg_plain``). That one is the exception to the
rule: its NumPy twin, a Python loop over the bits, is the tests' reference,
too slow for a camera view, so ``read_jpeg`` raises without the library.

Nothing is built at import. The first call compiles the sources into one
library with the JAX package's compiler line (``native/Makefile``: ``g++ -O3
-march=native -fPIC -std=c++17 -Wall -pthread -shared``), into
``_build/libpronerf_native-<hash>.so``, where the hash covers every source
and the flags, so an edited source is rebuilt and a stale library is never
loaded. Without ``g++`` the library is unavailable; a compiler that fails on
a source raises with its output.

Each entry point counts its runs in ``<function>.calls``, so a caller can
show which path it took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "pronerf_native.cpp", CSRC / "jpeg_decode.cpp")
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
            "-pthread", "-shared")

# what the first load did: {"built": bool, "seconds": float, "path": str}
build_info: dict = {}
_lib = None
_tried = False


def lib_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(hashlib.sha256(src.read_bytes()).digest())
    h.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"libpronerf_native-{h.hexdigest()[:12]}.so"


def _build(out: Path, cxx: str) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp),
                           *map(str, SOURCES)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed on "
                           f"{', '.join(p.name for p in SOURCES)}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def _load():
    """The library, built first if it is not there; None without g++."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    out = lib_path()
    t0 = time.perf_counter()
    built = not out.exists()
    if built:
        cxx = shutil.which("g++")
        if cxx is None:
            return None
        _build(out, cxx)
    lib = ctypes.CDLL(str(out))
    lib.build_ray_pool.restype = ctypes.c_int
    lib.build_ray_pool.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_uint64, ctypes.c_int,
    ]
    lib.colmap_points3d_visibility.restype = ctypes.c_int64
    lib.colmap_points3d_visibility.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.greedy_cover.restype = ctypes.c_int
    lib.greedy_cover.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p,
    ]
    lib.jpeg_header.restype = ctypes.c_int
    lib.jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_int32]
    lib.jpeg_decode.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_char_p, ctypes.c_int32]
    build_info.update(built=built, seconds=time.perf_counter() - t0,
                      path=str(out))
    _lib = lib
    return _lib


def is_available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def build_ray_pool_native(images, poses, K, seed: int, shuffle: bool = True):
    """[T,H,W,3] images + [T,3,4] poses + [3,3] K -> ([T*H*W,3,3] pool,
    [T*H*W] int32 train-subset ids), Fisher-Yates shuffled from ``seed``
    when ``shuffle``. None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    images = np.ascontiguousarray(images, np.float32)
    poses = np.ascontiguousarray(poses, np.float32)
    K = np.ascontiguousarray(K, np.float32)
    if images.ndim != 4 or images.shape[-1] != 3 or \
            poses.shape != (images.shape[0], 3, 4) or K.shape != (3, 3):
        raise ValueError(f"build_ray_pool_native: images {images.shape}, "
                         f"poses {poses.shape}, K {K.shape}")
    T, H, W, _ = images.shape
    rays = np.empty((T * H * W, 3, 3), np.float32)
    ids = np.empty((T * H * W,), np.int32)
    rc = lib.build_ray_pool(_ptr(images), _ptr(poses), _ptr(K), T, H, W,
                            _ptr(rays), _ptr(ids), ctypes.c_uint64(seed),
                            int(shuffle))
    if rc != 0:
        raise RuntimeError(f"build_ray_pool returned {rc}")
    build_ray_pool_native.calls += 1
    return rays, ids


build_ray_pool_native.calls = 0


def colmap_visibility_native(points3d_bin, image_rank: np.ndarray,
                             n_train: int):
    """points3D.bin + dense image_id -> train-rank map (-1: not a train
    view) -> [n_train, P] 0/1 float32. None when the library is unavailable
    or the file cannot be read."""
    lib = _load()
    if lib is None:
        return None
    image_rank = np.ascontiguousarray(image_rank, np.int32)
    path = str(points3d_bin).encode()
    n_points = lib.colmap_points3d_visibility(
        path, _ptr(image_rank), len(image_rank) - 1, n_train, None, 0)
    if n_points < 0:
        return None
    vis = np.zeros((n_train, n_points), np.float32)
    rc = lib.colmap_points3d_visibility(
        path, _ptr(image_rank), len(image_rank) - 1, n_train, _ptr(vis),
        n_points)
    if rc < 0:
        return None
    colmap_visibility_native.calls += 1
    return vis


colmap_visibility_native.calls = 0


def greedy_cover_native(vis: np.ndarray, n_pick: int):
    """Rows of ``vis`` [n_train, P] picked greedily by uncovered points
    (``vis`` itself is left as it is). None when the library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    vis = np.array(vis, np.float32, order="C")  # the C loop clobbers it
    n_train, n_points = vis.shape
    if not 0 < n_pick <= n_train:
        raise ValueError(f"greedy_cover_native: n_pick {n_pick} of "
                         f"{n_train} rows")
    picks = np.empty((n_pick,), np.int32)
    lib.greedy_cover(_ptr(vis), n_train, n_points, n_pick, _ptr(picks))
    greedy_cover_native.calls += 1
    return picks


greedy_cover_native.calls = 0


def decode_jpeg_native(data: bytes):
    """A JPEG file's bytes -> uint8 [H, W, 3] (YCbCr) or [H, W] (one
    component), equal to ``utils/jpeg.py:decode_jpeg_plain`` and to PIL's
    decode bit for bit. None when the library is unavailable; raises
    ``UnsupportedJPEG`` with the decoder's message for a file it does not
    read."""
    from pronerf_tpu_torch.utils.jpeg import UnsupportedJPEG

    lib = _load()
    if lib is None:
        return None
    data = bytes(data)
    err = ctypes.create_string_buffer(256)
    dims = np.zeros(3, np.int32)
    if lib.jpeg_header(data, len(data), _ptr(dims), err, len(err)):
        raise UnsupportedJPEG(err.value.decode())
    h, w, nc = (int(x) for x in dims)
    out = np.empty((h, w, 3) if nc == 3 else (h, w), np.uint8)
    if lib.jpeg_decode(data, len(data), _ptr(out), out.size, err, len(err)):
        raise UnsupportedJPEG(err.value.decode())
    decode_jpeg_native.calls += 1
    return out


decode_jpeg_native.calls = 0
