"""A GIF89a writer and reader in numpy and the standard library, for the
spiral video (``render.renderer.save_video``) where neither imageio nor
PIL is installed.

The writer maps every frame onto one fixed global palette, a uniform cube
of 6 x 7 x 6 levels (r, g, b; 252 colours), each channel to its nearest
level, so the largest difference per channel between a written pixel and
its 8-bit value is ``PALETTE_MAX_ERR`` (25 steps of 255 on red and blue, 21
on green), the same for every frame. Codes are variable-width LZW (8-bit
symbols, codes of 9 to 12 bits, a clear code when the table is full), in
sub-blocks of at most 255 bytes. A NETSCAPE2.0 block makes the file loop;
each frame's graphic-control block carries the delay ``round(100 / fps)``
in hundredths of a second.

The reader decodes what the writer writes and what common encoders write
(global and local colour tables, sub-rectangles on a canvas, transparency,
disposal 0 to 2, interlaced rows): ``read_gif`` -> uint8 [N, H, W, 3] and
the delays.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

LEVELS = (6, 7, 6)  # palette levels of r, g, b


def _channel_levels(n: int) -> np.ndarray:
    return np.array([int(k * 255 / (n - 1) + 0.5) for k in range(n)],
                    np.int32)


def _nearest_level_lut(levels: np.ndarray) -> np.ndarray:
    """[256] index of the nearest level of each 8-bit value (ties to the
    lower level)."""
    return np.argmin(np.abs(np.arange(256)[:, None] - levels[None, :]),
                     axis=1).astype(np.int32)


_LEVELS = [_channel_levels(n) for n in LEVELS]
_LUTS = [_nearest_level_lut(lv) for lv in _LEVELS]
PALETTE_MAX_ERR = tuple(
    int(np.abs(np.arange(256) - lv[lut]).max())
    for lv, lut in zip(_LEVELS, _LUTS))


def palette() -> np.ndarray:
    """uint8 [256, 3]: the cube's 252 colours, index (ri * 7 + gi) * 6 +
    bi, then black."""
    r, g, b = np.meshgrid(*_LEVELS, indexing="ij")
    cube = np.stack([r, g, b], axis=-1).reshape(-1, 3)
    out = np.zeros((256, 3), np.uint8)
    out[: len(cube)] = cube
    return out


def quantize(frame8) -> np.ndarray:
    """uint8 [H, W, 3] -> uint8 [H, W] palette indices."""
    f = np.asarray(frame8, np.uint8)
    ri, gi, bi = (_LUTS[c][f[..., c]] for c in range(3))
    return ((ri * LEVELS[1] + gi) * LEVELS[2] + bi).astype(np.uint8)


# ------------------------------------------------------------ LZW codes --

def _lzw_encode(indices: bytes, min_code_size: int = 8) -> bytes:
    """GIF LZW: the code stream of ``indices``, packed LSB first."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    first = eoi + 1
    width, nxt = min_code_size + 1, first
    codes, widths = [clear], [width]
    table = {}
    w = indices[0]
    for c in indices[1:]:
        key = (w << 8) | c
        hit = table.get(key)
        if hit is not None:
            w = hit
            continue
        codes.append(w)
        widths.append(width)
        table[key] = nxt
        nxt += 1
        if nxt > (1 << width) and width < 12:
            width += 1
        if nxt == 4096:
            codes.append(clear)
            widths.append(width)
            table.clear()
            width, nxt = min_code_size + 1, first
        w = c
    codes.append(w)
    widths.append(width)
    # the reader adds an entry on the last code and widens when the table
    # then fills the code width
    if nxt == (1 << width) and width < 12 and nxt > first:
        width += 1
    codes.append(eoi)
    widths.append(width)
    return _pack_codes(np.asarray(codes, np.int64),
                       np.asarray(widths, np.int64))


def _pack_codes(codes: np.ndarray, widths: np.ndarray) -> bytes:
    offsets = np.cumsum(widths) - widths
    bits = np.zeros(int(widths.sum()), np.uint8)
    for b in range(12):
        m = widths > b
        bits[offsets[m] + b] = (codes[m] >> b) & 1
    return np.packbits(bits, bitorder="little").tobytes()


def _lzw_decode(data: bytes, min_code_size: int, n_pixels: int) -> bytes:
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    pos, n_bits = 0, len(bits)
    weights = 1 << np.arange(12)
    width, prev = min_code_size + 1, None

    def reset():
        return [bytes([i]) for i in range(clear)] + [b"", b""]

    table = reset()
    while pos + width <= n_bits and len(out) < n_pixels:
        code = int(bits[pos:pos + width] @ weights[:width])
        pos += width
        if code == clear:
            table, width, prev = reset(), min_code_size + 1, None
            continue
        if code == eoi:
            break
        if prev is None:
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
                added = prev + entry[:1]
            elif code == len(table):
                entry = added = prev + prev[:1]
            else:
                raise ValueError(f"GIF: LZW code {code} past the table "
                                 f"({len(table)} entries)")
            if len(table) < 4096:
                table.append(added)
                if len(table) == (1 << width) and width < 12:
                    width += 1
        out += entry
        prev = entry
    if len(out) < n_pixels:
        raise ValueError(f"GIF: {len(out)} pixels decoded, {n_pixels} "
                         "expected")
    return bytes(out[:n_pixels])


def _sub_blocks(data: bytes) -> bytes:
    parts = [bytes([len(data[i:i + 255])]) + data[i:i + 255]
             for i in range(0, len(data), 255)]
    return b"".join(parts) + b"\x00"


# --------------------------------------------------------------- files --

def write_gif(path, frames8, fps: int = 30) -> str:
    """Write uint8 [N, H, W, 3] frames as a looping GIF89a; returns the
    path."""
    frames8 = [np.asarray(f, np.uint8) for f in frames8]
    H, W = frames8[0].shape[:2]
    delay = max(1, round(100 / fps))
    out = [b"GIF89a", struct.pack("<HHBBB", W, H, 0xF7, 0, 0),
           palette().tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for f in frames8:
        if f.shape != (H, W, 3):
            raise ValueError(f"GIF frame of shape {f.shape}, first "
                             f"{(H, W, 3)}")
        out.append(struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 0x04, delay, 0, 0))
        out.append(struct.pack("<BHHHHB", 0x2C, 0, 0, W, H, 0))
        out.append(b"\x08" + _sub_blocks(_lzw_encode(quantize(f).tobytes())))
    out.append(b"\x3b")
    Path(path).write_bytes(b"".join(out))
    return str(path)


def _read_blocks(buf: bytes, pos: int):
    parts = []
    while True:
        n = buf[pos]
        pos += 1
        if n == 0:
            return b"".join(parts), pos
        parts.append(buf[pos:pos + n])
        pos += n


def read_gif(path):
    """Decode a GIF into (uint8 [N, H, W, 3] frames, delays in hundredths
    of a second)."""
    buf = Path(path).read_bytes()
    if buf[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path}: not a GIF")
    W, H, flags = struct.unpack("<HHB", buf[6:11])
    pos = 13
    gct = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        gct = np.frombuffer(buf[pos:pos + 3 * n], np.uint8).reshape(n, 3)
        pos += 3 * n
    canvas = np.zeros((H, W, 3), np.uint8)
    frames, delays = [], []
    delay, transparent, disposal = 0, None, 0
    while pos < len(buf):
        tag = buf[pos]
        pos += 1
        if tag == 0x3B:
            break
        if tag == 0x21:
            label = buf[pos]
            body, pos = _read_blocks(buf, pos + 1)
            if label == 0xF9:
                packed, delay, tidx = struct.unpack("<BHB", body[:4])
                transparent = tidx if packed & 1 else None
                disposal = (packed >> 2) & 7
            continue
        if tag != 0x2C:
            raise ValueError(f"{path}: unknown block 0x{tag:02x}")
        x, y, w, h, iflags = struct.unpack("<HHHHB", buf[pos:pos + 9])
        pos += 9
        table = gct
        if iflags & 0x80:
            n = 2 << (iflags & 7)
            table = np.frombuffer(buf[pos:pos + 3 * n],
                                  np.uint8).reshape(n, 3)
            pos += 3 * n
        min_code = buf[pos]
        data, pos = _read_blocks(buf, pos + 1)
        idx = np.frombuffer(_lzw_decode(data, min_code, w * h),
                            np.uint8).reshape(h, w)
        if iflags & 0x40:  # rows stored in four passes
            order = np.concatenate([np.arange(start, h, step) for start, step
                                    in ((0, 8), (4, 8), (2, 4), (1, 2))])
            rows = np.empty_like(idx)
            rows[order] = idx
            idx = rows
        # an index past a short table (a transparent index appended by some
        # encoders) reads black
        table = np.concatenate([table, np.zeros((256 - len(table), 3),
                                                np.uint8)])
        region = canvas[y:y + h, x:x + w]
        if transparent is None:
            region[...] = table[idx]
        else:
            keep = idx == transparent
            region[...] = np.where(keep[..., None], region, table[idx])
        frames.append(canvas.copy())
        delays.append(delay)
        if disposal == 2:
            canvas[y:y + h, x:x + w] = 0
        delay, transparent, disposal = 0, None, 0
    return np.stack(frames), delays
