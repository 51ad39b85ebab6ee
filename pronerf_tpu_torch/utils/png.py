"""A minimal PNG writer (8-bit gray or RGB) and reader (8-bit gray, gray
and alpha, RGB or RGBA) on the standard library and numpy, so that the
render entry points dump frames and the LLFF loader reads a capture on a
machine without an imaging package."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


class UnsupportedPNG(ValueError):
    """A PNG that :func:`read_png` does not decode: a bit depth other than 8,
    a palette, or interlacing."""


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
        fh.write(_SIGNATURE)
        fh.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                             0, 0, 0)))
        fh.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        fh.write(_chunk(b"IEND", b""))


def _unfilter(ftype: np.ndarray, filtered: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters: ``filtered`` [H, W, bpp] uint8 with one
    filter type (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) per row.

    A pixel's predictor reads its left, upper and upper-left neighbours
    after they are decoded, so Sub, Average and Paeth are a recurrence along
    the row. The pixels of one anti-diagonal (row + column constant) depend
    only on earlier anti-diagonals, so the decode runs H + W - 1 vectorised
    steps, each over every row at once, whatever the rows' filters."""
    h, w, bpp = filtered.shape
    if not ftype.any():
        return filtered.copy()
    out = np.zeros((h + 1, w + 1, bpp), np.int32)  # row 0 and column 0 pad
    f = filtered.astype(np.int32)
    ft = ftype.astype(np.int32)[:, None]
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        c = d - r
        a = out[r + 1, c]          # left
        b = out[r, c + 1]          # up
        ul = out[r, c]             # upper left
        pa = np.abs(b - ul)
        pb = np.abs(a - ul)
        pc = np.abs(a + b - 2 * ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, ul))
        t = ft[r]
        pred = np.where(t == 1, a, np.where(
            t == 2, b, np.where(t == 3, (a + b) >> 1,
                                np.where(t == 4, paeth, 0))))
        out[r + 1, c + 1] = (f[r, c] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def read_png(path) -> np.ndarray:
    """An 8-bit PNG, not interlaced, as imageio returns it: uint8 [H, W]
    (gray), [H, W, 2] (gray and alpha), [H, W, 3] (RGB) or [H, W, 4]
    (RGBA).

    Any other PNG raises :class:`UnsupportedPNG`; a file that is not a
    whole PNG raises ``ValueError``."""
    data = Path(path).read_bytes()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        n, tag = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    w, h, depth, color, method, filt, interlace = header
    channels = {0: 1, 4: 2, 2: 3, 6: 4}
    if depth != 8 or color not in channels or interlace or method or filt:
        raise UnsupportedPNG(
            f"{path}: bit depth {depth}, colour type {color}, interlace "
            f"{interlace}; read_png takes 8-bit gray, gray and alpha, RGB or "
            "RGBA, not interlaced")
    bpp = channels[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for "
                         f"{w}x{h}x{bpp}")
    raw = raw.reshape(h, w * bpp + 1)
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: row filter type {ftype.max()}")
    img = _unfilter(ftype, raw[:, 1:].reshape(h, w, bpp))
    return img[..., 0] if bpp == 1 else img
