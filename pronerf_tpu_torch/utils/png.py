"""A minimal PNG writer (8-bit gray or RGB) on the standard library, so the
render entry points can dump frames on a machine without an imaging package."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF
    )


def write_png(path, img) -> None:
    """Write a uint8 [H, W] (gray) or [H, W, 3] (RGB) array as a PNG."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
        img.ndim == 3 and img.shape[2] != 3
    ):
        raise ValueError(f"write_png takes uint8 [H,W] or [H,W,3], got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    color_type = 0 if img.ndim == 2 else 2
    rows = img.reshape(h, -1)
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rows], axis=1  # filter type 0 per row
    ).tobytes()
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                             0, 0, 0)))
        fh.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        fh.write(_chunk(b"IEND", b""))
