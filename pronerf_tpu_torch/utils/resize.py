"""Lanczos resizing of 8-bit RGB images in numpy, equal bit for bit to
PIL's ``Image.resize(size, Image.LANCZOS)`` on an ``RGB`` image.

The LLFF loader makes a capture's ``images_{factor}`` with it
(``data/llff.py:_minify``), so a raw capture loads on a machine without an
imaging package. The arithmetic is PIL's (``libImaging/Resample.c``):

- separable: a horizontal pass, then a vertical one (a pass whose size does
  not change is skipped);
- Lanczos with a = 3, its support scaled by the reduction (``in / out``,
  never below 1); each output pixel's window starts at
  ``int(center - support + 0.5)``, clipped to the image;
- the weights of a window are normalised by their sum (taken in order),
  then made fixed point with 22 fraction bits, rounded half away from zero;
- each pass sums ``pixel * weight`` in integers from ``2 ** 21`` (one half)
  and keeps ``sum >> 22`` clipped to 0..255, so the image is clipped to 8
  bits between the two passes.

The weights are computed with the platform's ``sin`` (``math.sin``, the C
library's, as PIL's). A pass sums over the window's taps, one numpy
operation a tap over the whole image.
"""

from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2
LANCZOS_SUPPORT = 3.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def _fixed(w: float) -> int:
    """PIL's fixed-point weight: half away from zero, then truncated."""
    v = w * (1 << PRECISION_BITS)
    return int(v - 0.5) if w < 0 else int(v + 0.5)


def coefficients(in_size: int, out_size: int):
    """PIL's window of each output pixel: ``(start [out_size] int64,
    weights [out_size, ksize] int32)``, the fixed-point weights of input
    pixels ``start + j`` (zero past the window's end)."""
    scale = filterscale = in_size / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = LANCZOS_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    start = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = 0.0
        for w in ws:  # in order, as PIL sums them (not math.fsum)
            total += w
        if total != 0.0:
            ws = [w / total for w in ws]
        start[xx] = xmin
        weights[xx, :xmax] = [_fixed(w) for w in ws]
    return start, weights


def _pass(img: np.ndarray, in_size: int, out_size: int) -> np.ndarray:
    """PIL's 8-bit pass over the last axis of ``img`` [..., in_size]
    (uint8): [..., out_size] uint8. int32 sums, as PIL's (they stay below
    2 ** 31: 255 times the weights' absolute sum)."""
    start, weights = coefficients(in_size, out_size)
    acc = np.full(img.shape[:-1] + (out_size,), 1 << (PRECISION_BITS - 1),
                  np.int32)
    for j in range(weights.shape[1]):
        k = weights[:, j]
        if not k.any():
            continue
        idx = np.minimum(start + j, in_size - 1)  # past the end: weight 0
        acc += img[..., idx].astype(np.int32) * k
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_lanczos(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``img`` uint8 [H, W, 3] resized to [height, width, 3] uint8, equal to
    PIL's ``Image.fromarray(img).resize((width, height), Image.LANCZOS)``."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"resize_lanczos takes uint8 [H, W, 3], got "
                         f"{img.dtype} {img.shape}")
    if width < 1 or height < 1:
        raise ValueError(f"target size {width}x{height}")
    h, w = img.shape[:2]
    x = np.moveaxis(img, 2, 0)  # [3, H, W]
    if width != w:
        x = _pass(x, w, width)
    if height != h:
        x = np.swapaxes(_pass(np.swapaxes(x, 1, 2), h, height), 1, 2)
    return np.ascontiguousarray(np.moveaxis(x, 0, 2))
