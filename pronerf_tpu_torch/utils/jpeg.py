"""JPEG files read as libjpeg-turbo decodes them for PIL, and a baseline
writer for fixtures, on the standard library and numpy.

:func:`read_jpeg` returns what ``imageio.v2.imread`` returns for a JPEG
(imageio reads it through PIL, which calls libjpeg-turbo with its
defaults): uint8 [H, W, 3] for a 3-component (YCbCr) file and [H, W] for a
1-component one, bit for bit. It takes the host runtime's C++ decoder
(``native.decode_jpeg_native``, ``native/csrc/jpeg_decode.cpp``);
:func:`decode_jpeg_plain`, its numpy twin, is the reference that the tests
hold it to. Both follow libjpeg-turbo's default path:

- Huffman entropy decoding of baseline (SOF0), extended sequential (SOF1,
  8-bit) and progressive (SOF2) files: the four progressive procedures of
  ``jdphuff.c`` (DC first and refinement, AC first with end-of-band runs,
  AC refinement with its correction bits), restart intervals (the
  predictors and the end-of-band run reset at each RSTn), tables redefined
  between scans, 0xFF00 stuffing and 0xFF fill bytes;
- dequantisation by the table each component latched at its first scan,
  then the islow inverse DCT (``jidctint.c``: 13-bit constants, 2 bits kept
  between the column and the row pass, the +128 centre and the
  range-limit table);
- fancy upsampling (``jdsample.c``) of 4:2:2 (h2v1) and 4:2:0 (h2v2)
  chroma, with the box filter for a chroma plane of 2 columns or fewer,
  and the edge rows and columns repeated as ``jdmainct.c`` repeats them
  (the last real column is at ``ceil(W * h / hmax)``, not at the MCU's
  edge);
- ``jdcolor.c``'s fixed-point YCbCr -> RGB tables (16 fractional bits).

APPn and COM segments are skipped, so an EXIF orientation is ignored, as
imageio ignores it. Block smoothing (``jdcoefct.c``) applies only to a
progressive file whose first coefficients are incomplete, and such a file
raises. Anything else raises :class:`UnsupportedJPEG`, naming what it met.

:func:`write_jpeg` writes baseline 4:2:0 JPEGs with the Annex K tables
(scaled as libjpeg's ``jpeg_quality_scaling`` scales them) and the
standard Huffman tables, vectorised, so that a capture of JPEGs can be
written on a machine without an imaging package. It is for fixtures: its
bytes are not PIL's, but PIL decodes them to the pixels :func:`read_jpeg`
gives.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


# PIL.Image.open's limit (2 * MAX_IMAGE_PIXELS): imageio raises past it
_MAX_PIXELS = 178956970


class UnsupportedJPEG(ValueError):
    """A file that :func:`read_jpeg` does not decode to libjpeg-turbo's
    pixels: arithmetic coding, 12-bit samples, lossless or hierarchical
    files, 2 or 4 components (CMYK, YCCK), RGB-coded files, sampling
    factors other than 4:4:4, 4:2:2 and 4:2:0, DNL, a progressive file
    left incomplete, and truncated or corrupt data."""


def _natural_order() -> list:
    """``jpeg_natural_order``: the natural (row-major) index of the k-th
    coefficient in zigzag order."""
    cells = [(r + c, r if (r + c) % 2 else c, r * 8 + c)
             for r in range(8) for c in range(8)]
    return [n for _, _, n in sorted(cells)]


_NATURAL = _natural_order()

# ---------------------------------------------------------------- markers

_SOF_NAMES = {
    0xC3: "lossless (SOF3)", 0xC5: "hierarchical (SOF5)",
    0xC6: "hierarchical (SOF6)", 0xC7: "hierarchical lossless (SOF7)",
    0xC9: "arithmetic coding (SOF9)", 0xCA: "arithmetic coding (SOF10)",
    0xCB: "arithmetic coding (SOF11)", 0xCD: "arithmetic coding (SOF13)",
    0xCE: "arithmetic coding (SOF14)", 0xCF: "arithmetic coding (SOF15)",
    0xCC: "arithmetic conditioning (DAC)", 0xDC: "a DNL marker",
    0xDE: "hierarchical (DHP)", 0xDF: "hierarchical (EXP)",
}


def _huffman_lut(bits, vals, is_dc: bool, what: str) -> list:
    """For each 16-bit window of the bit stream, ``(code length << 8) |
    symbol`` of the code it starts with, 0 where none does
    (``jpeg_make_d_derived_tbl``'s checks: no all-ones code, DC symbols
    up to 15)."""
    lut = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        if code + bits[length - 1] >= 1 << length:
            raise UnsupportedJPEG(f"bad Huffman table ({what})")
        for _ in range(bits[length - 1]):
            sym = vals[k]
            if is_dc and sym > 15:
                raise UnsupportedJPEG(f"bad Huffman table ({what})")
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | sym
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "bw", "bh", "wb", "hb", "dw", "dh",
                 "coefs", "q", "bits")


class _Frame:
    """What the markers before and between the scans set: the frame
    header, the tables, the restart interval, the colour markers."""

    def __init__(self):
        self.sof = None
        self.comps = []
        self.qt = {}
        self.huff = {}
        self.restart = 0
        self.jfif = False
        self.adobe = None

    def setup(self, marker, seg, n_bytes: int):
        if self.sof is not None:
            raise UnsupportedJPEG("a second frame header")
        if len(seg) < 6:
            raise UnsupportedJPEG("short frame header")
        prec, height, width, nf = struct.unpack(">BHHB", seg[:6])
        if prec != 8:
            raise UnsupportedJPEG(f"{prec}-bit samples")
        if height == 0:
            raise UnsupportedJPEG("a height of 0 (the height in a DNL "
                                  "marker)")
        if width == 0:
            raise UnsupportedJPEG("a width of 0")
        if max(width, height) > 65500:  # jdinput.c: JPEG_MAX_DIMENSION
            raise UnsupportedJPEG(f"an image of {width}x{height} (more than "
                                  "65500 a side)")
        if width * height > _MAX_PIXELS:  # PIL's decompression bomb
            raise UnsupportedJPEG(f"an image of {width}x{height} (PIL "
                                  f"refuses more than {_MAX_PIXELS} pixels)")
        if nf not in (1, 3):
            raise UnsupportedJPEG(
                f"{nf} components" + (" (CMYK or YCCK)" if nf == 4 else ""))
        if len(seg) < 6 + 3 * nf:
            raise UnsupportedJPEG("short frame header")
        self.sof, self.height, self.width = marker, height, width
        for i in range(nf):
            c = _Component()
            c.cid, hv, c.tq = seg[6 + 3 * i:9 + 3 * i]
            c.h, c.v = hv >> 4, hv & 15
            if not (1 <= c.h <= 4 and 1 <= c.v <= 4) or c.tq > 3:
                raise UnsupportedJPEG(f"component {c.cid}: sampling "
                                      f"{c.h}x{c.v}, table {c.tq}")
            self.comps.append(c)
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        for c in self.comps:
            he, ve = self.hmax // c.h, self.vmax // c.v
            if (self.hmax % c.h or self.vmax % c.v
                    or (he, ve) not in ((1, 1), (2, 1), (2, 2))):
                raise UnsupportedJPEG(
                    "sampling factors " + ", ".join(
                        f"{d.h}x{d.v}" for d in self.comps)
                    + " (4:4:4, 4:2:2 and 4:2:0 are read)")
        mcux = -(-width // (8 * self.hmax))
        mcuy = -(-height // (8 * self.vmax))
        self.mcux, self.mcuy = mcux, mcuy
        for c in self.comps:
            c.bw, c.bh = mcux * c.h, mcuy * c.v
            c.dw = -(-width * c.h // self.hmax)
            c.dh = -(-height * c.v // self.vmax)
            c.wb, c.hb = -(-c.dw // 8), -(-c.dh // 8)
            c.q = None
            c.bits = [-1] * 64
        # every block's DC is a Huffman code of at least one bit
        if sum(c.wb * c.hb for c in self.comps) > 8 * n_bytes:
            raise UnsupportedJPEG("truncated file (fewer bytes than the "
                                  "frame's blocks need)")

    def check_colour(self):
        """``jdapimin.c:default_decompress_parms``, which runs when the
        first scan is reached: 3 components are YCbCr unless an Adobe
        marker without JFIF says transform 0, or the component ids spell
        R, G, B."""
        if len(self.comps) != 3 or self.jfif:
            return
        if self.adobe is not None:
            if self.adobe == 0:
                raise UnsupportedJPEG("RGB coding (Adobe transform 0)")
            return
        if [c.cid for c in self.comps] == [82, 71, 66]:
            raise UnsupportedJPEG("RGB coding (component ids R, G, B)")

    def dqt(self, seg):
        pos = 0
        while pos < len(seg):
            pq, tq = seg[pos] >> 4, seg[pos] & 15
            if tq > 3 or pq > 1:
                raise UnsupportedJPEG(f"quantisation table {tq} of "
                                      f"precision {pq}")
            n = 128 if pq else 64
            if pos + 1 + n > len(seg):
                raise UnsupportedJPEG("short DQT segment")
            raw = seg[pos + 1:pos + 1 + n]
            vals = (struct.unpack(">64H", raw) if pq else tuple(raw))
            table = [0] * 64
            for k in range(64):
                table[_NATURAL[k]] = vals[k]
            self.qt[tq] = table
            pos += 1 + n

    def dht(self, seg):
        pos = 0
        while pos < len(seg):
            if pos + 17 > len(seg):
                raise UnsupportedJPEG("short DHT segment")
            tc, th = seg[pos] >> 4, seg[pos] & 15
            bits = list(seg[pos + 1:pos + 17])
            n = sum(bits)
            if tc > 1 or th > 3 or n > 256 or pos + 17 + n > len(seg):
                raise UnsupportedJPEG(f"bad DHT segment (class {tc}, "
                                      f"table {th}, {n} codes)")
            self.huff[tc, th] = (bits, list(seg[pos + 17:pos + 17 + n]))
            pos += 17 + n

    def app(self, marker, seg):
        if marker == 0xE0 and seg[:5] == b"JFIF\0":
            self.jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            self.adobe = seg[11]

    def lut(self, cls, th, what):
        if th > 3:
            raise UnsupportedJPEG(f"Huffman table {th} (tables 0 to 3 "
                                  "exist)")
        if (cls, th) not in self.huff:
            raise UnsupportedJPEG(f"no Huffman table {th} for {what}")
        bits, vals = self.huff[cls, th]
        return _huffman_lut(bits, vals, cls == 0, what)


def _next_segment(data: bytes, pos: int):
    """The marker segment at or after ``pos``: (marker, payload start,
    payload end); extraneous and fill bytes before the marker are skipped
    as libjpeg skips them, and RSTn / TEM, which carry no length, passed
    over. For SOS the payload end is where the scan's data begins; for EOI
    both are the position after it."""
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise UnsupportedJPEG("truncated file (no EOI marker)")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            return marker, pos, pos
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        length = int.from_bytes(data[pos:pos + 2], "big")
        if pos + 2 > len(data) or length < 2 or pos + length > len(data):
            raise UnsupportedJPEG("truncated file")
        return marker, pos + 2, pos + length


def _scan_data(data: bytes, pos: int):
    """The entropy-coded data from ``pos``: the restart intervals' bytes
    with the 0xFF00 stuffing undone, the RSTn numbers between them, and
    the position of the marker that ends the scan."""
    segs, rsts, cur = [], [], bytearray()
    n = len(data)
    while True:
        i = data.find(b"\xff", pos)
        if i < 0:
            raise UnsupportedJPEG("truncated file (scan data without an "
                                  "ending marker)")
        cur += data[pos:i]
        j = i + 1
        while j < n and data[j] == 0xFF:
            j += 1  # libjpeg reads FF FF .. 00 as one stuffed 0xFF
        if j >= n:
            raise UnsupportedJPEG("truncated file")
        if data[j] == 0:
            cur.append(0xFF)
            pos = j + 1
        elif 0xD0 <= data[j] <= 0xD7:
            segs.append(bytes(cur))
            rsts.append(data[j] - 0xD0)
            cur = bytearray()
            pos = j + 1
        else:
            segs.append(bytes(cur))
            return segs, rsts, i


def _windows(seg: bytes) -> list:
    """32-bit big-endian windows of ``seg`` at every byte (zeros past its
    end): bits [p, p + n) are ``(w[p >> 3] >> (32 - (p & 7) - n)) & mask``
    for n <= 25."""
    b = np.frombuffer(seg + b"\0\0\0\0", np.uint8).astype(np.uint32)
    return ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8)
            | b[3:]).tolist()


def _corrupt():
    raise UnsupportedJPEG("corrupt entropy-coded data")


def _wrap16(x: int) -> int:
    return ((x + 32768) & 0xFFFF) - 32768  # the cast to JCOEF (int16)


# The entropy decoders of one restart interval. ``blocks`` holds, for each
# block of the interval in coding order, its component's index in the scan
# and the offset of its 64 coefficients in that component's list; each
# returns the number of bits it read.

def _seq_interval(w, blocks, dcl, acl, coefs):
    """Sequential (``jdhuff.c:decode_mcu``): a DC difference, then AC
    (run, size) symbols up to EOB."""
    pos, pred = 0, [0] * len(dcl)
    nat = _NATURAL
    for ci, off in blocks:
        e = dcl[ci][(w[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
        if not e:
            _corrupt()
        pos += e >> 8
        s = e & 255
        if s:
            r = (w[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
            pos += s
            if r < 1 << (s - 1):
                r += (-1 << s) + 1
            pred[ci] += r
        blk = coefs[ci]
        blk[off] = _wrap16(pred[ci])
        lut = acl[ci]
        k = 1
        while k < 64:
            e = lut[(w[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not e:
                _corrupt()
            pos += e >> 8
            rs = e & 255
            s = rs & 15
            if s:
                k += rs >> 4
                if k > 63:
                    _corrupt()
                r = (w[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                if r < 1 << (s - 1):
                    r += (-1 << s) + 1
                blk[off + nat[k]] = r
            elif rs == 0xF0:
                k += 15
            else:
                break
            k += 1
    return pos


def _dc_first_interval(w, blocks, dcl, al, coefs):
    pos, pred = 0, [0] * len(dcl)
    for ci, off in blocks:
        e = dcl[ci][(w[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
        if not e:
            _corrupt()
        pos += e >> 8
        s = e & 255
        if s:
            r = (w[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
            pos += s
            if r < 1 << (s - 1):
                r += (-1 << s) + 1
            pred[ci] += r
        coefs[ci][off] = _wrap16(pred[ci] << al)
    return pos


def _dc_refine_interval(w, blocks, al, coefs):
    p1 = 1 << al
    pos = 0
    for ci, off in blocks:
        if (w[pos >> 3] >> (31 - (pos & 7))) & 1:
            coefs[ci][off] |= p1
        pos += 1
    return pos


def _ac_first_interval(w, offs, lut, ss, se, al, blk):
    """``jdphuff.c:decode_mcu_AC_first``: one component, a band of
    coefficients, end-of-band runs over blocks."""
    pos, eobrun = 0, 0
    nat = _NATURAL
    for off in offs:
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            e = lut[(w[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not e:
                _corrupt()
            pos += e >> 8
            rs = e & 255
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                if k > se:
                    _corrupt()
                v = (w[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                if v < 1 << (s - 1):
                    v += (-1 << s) + 1
                blk[off + nat[k]] = _wrap16(v << al)
            elif r == 15:
                k += 15
            else:
                eobrun = 1 << r
                if r:
                    eobrun += (w[pos >> 3] >> (32 - (pos & 7) - r)) & (
                        (1 << r) - 1)
                    pos += r
                eobrun -= 1
                break
            k += 1
    return pos


def _ac_refine_interval(w, offs, lut, ss, se, al, blk):
    """``jdphuff.c:decode_mcu_AC_refine``: a new coefficient is +-1 << al,
    and each coefficient already nonzero that the run passes over (or that
    lies past the end of band) takes one correction bit."""
    pos, eobrun = 0, 0
    p1, m1 = 1 << al, -1 << al
    nat = _NATURAL
    for off in offs:
        k = ss
        if not eobrun:
            while k <= se:
                e = lut[(w[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                if not e:
                    _corrupt()
                pos += e >> 8
                rs = e & 255
                r, s = rs >> 4, rs & 15
                if s:
                    s = p1 if (w[pos >> 3] >> (31 - (pos & 7))) & 1 else m1
                    pos += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (w[pos >> 3] >> (32 - (pos & 7) - r)) & (
                            (1 << r) - 1)
                        pos += r
                    break
                while k <= se:
                    i = off + nat[k]
                    c = blk[i]
                    if c:
                        if (w[pos >> 3] >> (31 - (pos & 7))) & 1 and \
                                not c & p1:
                            blk[i] = c + p1 if c >= 0 else c + m1
                        pos += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    if k > se:
                        _corrupt()
                    blk[off + nat[k]] = s
                k += 1
        if eobrun:
            while k <= se:
                i = off + nat[k]
                c = blk[i]
                if c:
                    if (w[pos >> 3] >> (31 - (pos & 7))) & 1 and not c & p1:
                        blk[i] = c + p1 if c >= 0 else c + m1
                    pos += 1
                k += 1
            eobrun -= 1
    return pos


def _scan_blocks(frame, scomps):
    """The blocks of a scan in coding order, MCU by MCU: (index in the
    scan, offset) pairs, and the blocks an MCU holds. An interleaved scan
    codes the MCU's padding blocks too; a scan of one component codes its
    ``ceil(dw / 8) x ceil(dh / 8)`` blocks."""
    if len(scomps) == 1:
        c = scomps[0]
        offs = ((np.arange(c.hb)[:, None] * c.bw + np.arange(c.wb)) * 64)
        return [(0, o) for o in offs.ravel().tolist()], 1
    per_mcu = []
    for si, c in enumerate(scomps):
        for yy in range(c.v):
            for xx in range(c.h):
                per_mcu.append((si, c, yy, xx))
    my, mx = np.meshgrid(np.arange(frame.mcuy), np.arange(frame.mcux),
                         indexing="ij")
    cols = []
    for si, c, yy, xx in per_mcu:
        cols.append(((my * c.v + yy) * c.bw + mx * c.h + xx).ravel() * 64)
    offs = np.stack(cols, 1).ravel().tolist()
    sis = [p[0] for p in per_mcu] * (frame.mcux * frame.mcuy)
    return list(zip(sis, offs)), len(per_mcu)


def _decode_scan(frame, seg, data, pos, progressive):
    """One scan: its header, its data and its coefficients. Returns the
    position of the marker after its data."""
    if frame.sof is None:
        raise UnsupportedJPEG("a scan before the frame header")
    ns = seg[0] if seg else 0
    if not 1 <= ns <= 4 or len(seg) < 4 + 2 * ns:
        raise UnsupportedJPEG("bad scan header")
    by_id = {c.cid: c for c in frame.comps}
    scomps, tds, tas = [], [], []
    for i in range(ns):
        cid, t = seg[1 + 2 * i:3 + 2 * i]
        if cid not in by_id or by_id[cid] in scomps:
            raise UnsupportedJPEG(f"scan names component {cid}")
        scomps.append(by_id[cid])
        tds.append(t >> 4)
        tas.append(t & 15)
    ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    if sum(c.h * c.v for c in scomps) > 10 and ns > 1:
        raise UnsupportedJPEG("more than 10 blocks an MCU")
    for c in scomps:  # latch_quant_tables: at the component's first scan
        if c.q is None:
            if c.tq not in frame.qt:
                raise UnsupportedJPEG(f"no quantisation table {c.tq}")
            c.q = list(frame.qt[c.tq])
    if progressive:
        if (ss == 0 and se != 0) or (ss and (ss > se or se > 63 or ns != 1))\
                or (ah and al != ah - 1) or al > 13:
            raise UnsupportedJPEG(f"bad progression Ss={ss} Se={se} "
                                  f"Ah={ah} Al={al}")
        for c in scomps:
            for k in range(ss, se + 1):
                if ah != max(c.bits[k], 0) or (ss and c.bits[0] < 0):
                    raise UnsupportedJPEG("bad progression order")
                c.bits[k] = al
    else:
        ss, se = 0, 63
        for c in scomps:
            c.bits = [0] * 64

    segs, rsts, end = _scan_data(data, pos)
    blocks, per_mcu = _scan_blocks(frame, scomps)
    n_mcu = len(blocks) // per_mcu
    ri = frame.restart or n_mcu
    n_int = -(-n_mcu // ri)
    if len(segs) < n_int or any(r != i % 8 for i, r in
                                enumerate(rsts[:n_int - 1])):
        raise UnsupportedJPEG("missing or misplaced restart marker")
    coefs = [c.coefs for c in scomps]
    if not progressive:
        dcl = [frame.lut(0, t, "DC") for t in tds]
        acl = [frame.lut(1, t, "AC") for t in tas]
    elif ss == 0:
        dcl = [frame.lut(0, t, "DC") for t in tds] if ah == 0 else None
    else:
        lut = frame.lut(1, tas[0], "AC")
    for i in range(n_int):
        part = blocks[i * ri * per_mcu:(i + 1) * ri * per_mcu]
        w = _windows(segs[i])
        try:
            if not progressive:
                used = _seq_interval(w, part, dcl, acl, coefs)
            elif ss == 0 and ah == 0:
                used = _dc_first_interval(w, part, dcl, al, coefs)
            elif ss == 0:
                used = _dc_refine_interval(w, part, al, coefs)
            else:
                offs = [o for _, o in part]
                fn = _ac_first_interval if ah == 0 else _ac_refine_interval
                used = fn(w, offs, lut, ss, se, al, coefs[0])
        except IndexError:  # read on past the windows: far past the data
            used = 8 * len(segs[i]) + 1
        if used > 8 * len(segs[i]):
            raise UnsupportedJPEG("truncated or corrupt entropy-coded data")
    return end


def decode_jpeg_plain(data: bytes) -> np.ndarray:
    """The numpy decoder: uint8 [H, W, 3] (YCbCr files) or [H, W] (one
    component). Its entropy decoding is a Python loop over the bits, for
    test sizes; the rest is vectorised. Raises :class:`UnsupportedJPEG`."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise UnsupportedJPEG("not a JPEG file (no SOI marker)")
    frame = _Frame()
    progressive = None
    pos, scans = 2, 0
    while True:
        marker, start, pos = _next_segment(data, pos)
        seg = data[start:pos]
        if marker == 0xD9:
            break
        if marker in (0xC0, 0xC1, 0xC2):
            frame.setup(marker, seg, len(data))
            progressive = marker == 0xC2
            for c in frame.comps:
                c.coefs = [0] * (c.bw * c.bh * 64)
        elif marker in _SOF_NAMES:
            raise UnsupportedJPEG(_SOF_NAMES[marker])
        elif marker == 0xDB:
            frame.dqt(seg)
        elif marker == 0xC4:
            frame.dht(seg)
        elif marker == 0xDD:
            if len(seg) != 2:
                raise UnsupportedJPEG("bad DRI segment")
            frame.restart = int.from_bytes(seg, "big")
        elif marker == 0xDA:
            if not scans:
                frame.check_colour()
            pos = _decode_scan(frame, seg, data, pos, progressive)
            scans += 1
        elif 0xE0 <= marker <= 0xEF:
            frame.app(marker, seg)
        elif marker == 0xFE:
            pass
        else:
            raise UnsupportedJPEG(f"marker 0x{marker:02X}")
    if not scans:
        raise UnsupportedJPEG("no scan")
    for c in frame.comps:
        if any(b != 0 for b in c.bits[:10]):
            raise UnsupportedJPEG(
                "a progressive file whose first coefficients are incomplete "
                "(libjpeg smooths its blocks)")
    planes = []
    for c in frame.comps:
        coef = np.array(c.coefs, np.int64).astype(np.int16).astype(np.int64)
        q = np.array(c.q, np.int64).reshape(8, 8)
        samples = _idct_islow(coef.reshape(c.bh, c.bw, 8, 8) * q)
        plane = samples.transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        planes.append(_upsample(plane[:c.dh, :c.dw], frame.hmax // c.h,
                               frame.vmax // c.v)[:frame.height,
                                                  :frame.width])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    return _ycc_to_rgb(*planes)


# ------------------------------------------------- reconstruction (numpy)

def _check16(*values):
    """libjpeg-turbo's SIMD islow IDCT keeps these values in 16 bits, where
    its C code (this decoder's model) does not: past them the two differ,
    and no encoder's coefficients get there."""
    for v in values:
        if v.size and (v.min() < -32768 or v.max() > 32767):
            raise UnsupportedJPEG("dequantised coefficients past 16 bits "
                                  "(libjpeg-turbo's SIMD IDCT saturates "
                                  "them)")


def _idct_pass(x, shift):
    """One 1-D pass of ``jidctint.c:jpeg_idct_islow`` over axis 0 of ``x``
    (int64), descaled by ``shift`` bits with rounding."""
    _check16(x, x[0] + x[4], x[0] - x[4], x[2] + x[6], x[7] + x[3],
             x[5] + x[1], x[7] + x[1], x[5] + x[3])
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * 4433
    tmp2 = z1 + z3 * -15137
    tmp3 = z1 + z2 * 6270
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    half = 1 << (shift - 1)
    return np.stack([(v + half) >> shift for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)])


# jdmaster.c's post-IDCT range limit, indexed by the sample & 1023: the
# +128 centre, a clamp to 255 above and 0 below, and a wrap past +-512
_RANGE_LIMIT = np.concatenate([
    np.arange(128, 256), np.full(384, 255), np.zeros(384),
    np.arange(0, 128)]).astype(np.uint8)


def _idct_islow(coef) -> np.ndarray:
    """Dequantised coefficients int64 [..., 8, 8] (row = vertical
    frequency) -> uint8 samples [..., 8, 8]: the column pass (descale by
    11 bits), then the row pass (by 18), then the range limit."""
    ws = _idct_pass(np.moveaxis(coef, -2, 0), 11)       # [8 rows, ..., 8]
    out = _idct_pass(np.moveaxis(ws, -1, 0), 18)        # [8 cols, 8 rows, ...]
    out = np.moveaxis(out, (0, 1), (-1, -2))
    if out.size and (out.min() < -512 or out.max() > 511):
        # the range-limit table wraps there, where the SIMD code saturates
        raise UnsupportedJPEG("an IDCT output past the range limit's "
                              "+-512")
    return _RANGE_LIMIT[out & 1023]


def _upsample(plane, he: int, ve: int) -> np.ndarray:
    """A component's samples [dh, dw] (uint8) to the image's grid:
    ``jdsample.c``'s fancy upsampling for 2x1 and 2x2, the box filter
    where the plane has 2 columns or fewer; edges repeated."""
    x = plane.astype(np.int32)
    if (he, ve) == (1, 1):
        return plane
    dw = x.shape[1]
    if dw <= 2:
        out = np.repeat(x, 2, axis=1)
        return (np.repeat(out, 2, axis=0) if ve == 2 else out).astype(
            np.uint8)
    if ve == 2:  # h2v2: column sums with the nearer row x3, then x3 / x1
        up = np.concatenate([x[:1], x[:-1]])
        down = np.concatenate([x[1:], x[-1:]])
        sums = np.empty((2 * x.shape[0], dw), np.int32)
        sums[0::2] = 3 * x + up
        sums[1::2] = 3 * x + down
        left = np.concatenate([sums[:, :1], sums[:, :-1]], 1)
        right = np.concatenate([sums[:, 1:], sums[:, -1:]], 1)
        out = np.empty((sums.shape[0], 2 * dw), np.int32)
        out[:, 0::2] = (3 * sums + left + 8) >> 4
        out[:, 1::2] = (3 * sums + right + 7) >> 4
        return out.astype(np.uint8)
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    out = np.empty((x.shape[0], 2 * dw), np.int32)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    return out.astype(np.uint8)


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


_CENTRED = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _CENTRED + 32768) >> 16
_CB_B = (_fix(1.77200) * _CENTRED + 32768) >> 16
_CR_G = -_fix(0.71414) * _CENTRED
_CB_G = -_fix(0.34414) * _CENTRED + 32768


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """``jdcolor.c:ycc_rgb_convert`` on uint8 planes -> uint8 [H, W, 3]."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# ------------------------------------------------------------- the reader

def read_jpeg(path) -> np.ndarray:
    """A JPEG as ``imageio.v2.imread`` (PIL, libjpeg-turbo) reads it: uint8
    [H, W, 3] for a YCbCr file, [H, W] for a grayscale one, by the host
    runtime's decoder. :class:`UnsupportedJPEG`, naming the file, for what
    it does not read, and when its library does not load: the plain decoder
    takes minutes for a camera view, so it is the reference, not a
    fallback."""
    from pronerf_tpu_torch import native

    data = Path(path).read_bytes()
    try:
        img = native.decode_jpeg_native(data)
    except UnsupportedJPEG as e:
        raise UnsupportedJPEG(f"{path}: {e}") from None
    if img is None:
        raise UnsupportedJPEG(f"{path}: the host runtime's JPEG decoder did "
                              "not build (it needs g++)")
    return img


# ------------------------------------------------------------- the writer

# Annex K's tables in zigzag order, as libjpeg's jcparam.c holds them
_STD_QUANT = (
    (16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17, 16, 19, 24, 40, 26, 24,
     22, 22, 24, 49, 35, 37, 29, 40, 58, 51, 61, 60, 57, 51, 56, 55, 64, 72,
     92, 78, 64, 68, 87, 69, 55, 56, 80, 109, 81, 87, 95, 98, 103, 104, 103,
     62, 77, 113, 121, 112, 100, 120, 92, 101, 103, 99),
    (17, 18, 18, 24, 21, 24, 47, 26, 26, 47, 99, 66, 56, 66) + (99,) * 50,
)
_AC_VALS_LUMA = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433"
    "627282090a161718191a25262728292a3435363738393a434445464748494a535455"
    "565758595a636465666768696a737475767778797a838485868788898a9293949596"
    "9798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4"
    "d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_VALS_CHROMA = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f01562"
    "72d10a162434e125f11718191a262728292a35363738393a434445464748494a5354"
    "55565758595a636465666768696a737475767778797a82838485868788898a929394"
    "95969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2"
    "d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
# (class, table): (code counts by length 1..16, symbols)
_STD_HUFF = {
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
             bytes(range(12))),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
             bytes(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125),
             _AC_VALS_LUMA),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119),
             _AC_VALS_CHROMA),
}


def _quant_tables(quality: int):
    """libjpeg's ``jpeg_set_quality``: the Annex K tables (zigzag order)
    scaled by ``jpeg_quality_scaling(quality)``, clamped to 1..255."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return [np.clip((np.array(t) * scale + 50) // 100, 1, 255)
            for t in _STD_QUANT]


def _huffman_codes(bits, vals):
    """Canonical codes: (code [256], length [256]) by symbol."""
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    c, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code[vals[k]], size[vals[k]] = c, length
            c += 1
            k += 1
        c <<= 1
    return code, size


def _dct_matrix():
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    m = np.cos((2 * x + 1) * u * np.pi / 16) * np.sqrt(2 / 8)
    m[0] /= np.sqrt(2)
    return m


def _magnitude(v):
    """(size category, the size's low bits of v or v - 1) of ints."""
    a = np.abs(v)
    s = np.zeros(v.shape, np.int64)
    while (a >> s).any():
        s += (a >> s) > 0
    extra = np.where(v < 0, v - 1, v) & ((np.int64(1) << s) - 1)
    return s, extra


def _pack_bits(vals, lens) -> bytes:
    """Concatenate codes (``lens`` <= 32 bits each), MSB first, pad the
    last byte with 1s and stuff a 0x00 after every 0xFF."""
    lens = lens.astype(np.int64)
    total = int(lens.sum())
    pos = np.cumsum(lens) - lens
    word, off = pos >> 5, pos & 31
    shifted = vals.astype(np.uint64) << (64 - off - lens).astype(np.uint64)
    n_words = (total >> 5) + 2
    words = (np.bincount(word, (shifted >> np.uint64(32)).astype(np.float64),
                         n_words)
             + np.bincount(word + 1,
                           (shifted & np.uint64(0xFFFFFFFF)).astype(
                               np.float64), n_words))
    raw = words.astype(np.uint64).astype(">u4").tobytes()
    out = np.frombuffer(raw[:-(-total // 8)], np.uint8).copy()
    if total % 8:
        out[-1] |= (1 << (8 - total % 8)) - 1
    return np.insert(out, np.nonzero(out == 0xFF)[0] + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def write_jpeg(path, img, quality: int = 90) -> None:
    """Write uint8 [H, W, 3] RGB as a baseline 4:2:0 JFIF JPEG: JFIF's
    YCbCr, 2x2 means of the chroma, an orthonormal float DCT, the Annex K
    tables scaled as libjpeg scales them, the standard Huffman tables.
    Vectorised: the symbols, their codes and the bit packing are array
    operations."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_jpeg takes uint8 [H, W, 3], got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"write_jpeg: {w}x{h} is out of range")
    rgb = img.astype(np.float64)
    ycc = rgb @ np.array([[0.299, -0.168736, 0.5],
                          [0.587, -0.331264, -0.418688],
                          [0.114, 0.5, -0.081312]]) + [0, 128, 128]
    my, mx = -(-h // 16), -(-w // 16)
    ycc = np.pad(ycc, ((0, 16 * my - h), (0, 16 * mx - w), (0, 0)),
                 mode="edge")
    luma = ycc[..., 0]
    chroma = ycc[..., 1:].reshape(8 * my, 2, 8 * mx, 2, 2).mean((1, 3))
    qtabs = _quant_tables(quality)
    nat = np.array(_NATURAL)
    m = _dct_matrix()

    def zigzag_blocks(plane, q):
        """[by, bx] blocks of ``plane`` -> quantised coefficients in
        zigzag order [by, bx, 64]."""
        by, bx = plane.shape[0] // 8, plane.shape[1] // 8
        b = (plane - 128.0).reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)
        f = (m @ b @ m.T).reshape(by, bx, 64)[..., nat]
        return np.round(f / q).astype(np.int64)

    yb = zigzag_blocks(luma, qtabs[0])                       # [2my, 2mx, 64]
    yb = yb.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(
        my * mx, 4, 64)
    cb = zigzag_blocks(chroma[..., 0], qtabs[1]).reshape(my * mx, 1, 64)
    cr = zigzag_blocks(chroma[..., 1], qtabs[1]).reshape(my * mx, 1, 64)
    blocks = np.concatenate([yb, cb, cr], 1)                 # [n_mcu, 6, 64]
    table = np.tile([0, 0, 0, 0, 1, 1], my * mx)
    dc = blocks[..., 0]
    diff = np.empty_like(dc)
    for sl in (slice(0, 4), slice(4, 5), slice(5, 6)):
        seq = dc[:, sl].ravel()
        diff[:, sl] = np.diff(seq, prepend=0).reshape(-1, sl.stop - sl.start)
    blocks = blocks.reshape(-1, 64)
    diff = diff.ravel()
    n_blocks = len(blocks)
    codes = {key: _huffman_codes(*val) for key, val in _STD_HUFF.items()}

    def code_of(cls, tab, sym):
        c0, l0 = codes[cls, 0]
        c1, l1 = codes[cls, 1]
        return (np.where(tab == 0, c0[sym], c1[sym]),
                np.where(tab == 0, l0[sym], l1[sym]))

    keys, vals, lens = [], [], []
    # DC: the size category's code, then its bits
    s, extra = _magnitude(diff)
    c, ln = code_of(0, table, s)
    keys.append(np.arange(n_blocks) * 260)
    vals.append((c << s) | extra)
    lens.append(ln + s)
    # AC: ZRLs, then (run, size) and the bits, for each nonzero coefficient
    b_idx, k_idx = np.nonzero(blocks[:, 1:])
    k_idx = k_idx + 1
    v = blocks[b_idx, k_idx]
    first = np.r_[True, b_idx[1:] != b_idx[:-1]] if len(b_idx) else \
        np.zeros(0, bool)
    prev = np.where(first, 0, np.r_[0, k_idx[:-1]])
    run = k_idx - prev - 1
    n_zrl = run >> 4
    s, extra = _magnitude(v)
    tab = table[b_idx]
    c, ln = code_of(1, tab, ((run & 15) << 4) | s)
    keys.append(b_idx * 260 + k_idx * 4 + n_zrl)
    vals.append((c << s) | extra)
    lens.append(ln + s)
    z_item = np.repeat(np.arange(len(b_idx)), n_zrl)
    if len(z_item):
        j = np.arange(len(z_item)) - np.repeat(np.cumsum(n_zrl) - n_zrl,
                                               n_zrl)
        c, ln = code_of(1, tab[z_item], np.full(len(z_item), 0xF0))
        keys.append(b_idx[z_item] * 260 + k_idx[z_item] * 4 + j)
        vals.append(c)
        lens.append(ln)
    # EOB where the last nonzero coefficient is not the 63rd
    last = np.zeros(n_blocks, np.int64)
    ends = np.r_[b_idx[1:] != b_idx[:-1], True] if len(b_idx) else \
        np.zeros(0, bool)
    last[b_idx[ends]] = k_idx[ends]
    eob = np.nonzero(last < 63)[0]
    c, ln = code_of(1, table[eob], np.zeros(len(eob), np.int64))
    keys.append(eob * 260 + 256)
    vals.append(c)
    lens.append(ln)
    order = np.argsort(np.concatenate(keys), kind="stable")
    data = _pack_bits(np.concatenate(vals)[order],
                      np.concatenate(lens)[order])

    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i, q in enumerate(qtabs):
        out.append(_segment(0xDB, bytes([i]) + bytes(q.astype(np.uint8))))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                        + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for (cls, tab), (bits, syms) in _STD_HUFF.items():
        out.append(_segment(0xC4, bytes([cls << 4 | tab, *bits]) + syms))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63,
                                     0])))
    out += [data, b"\xff\xd9"]
    Path(path).write_bytes(b"".join(out))
