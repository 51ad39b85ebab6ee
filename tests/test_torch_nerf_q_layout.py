"""The layouts and the arithmetic that the int8 NeRF kernel
(``csrc/fused_nerf_q.cu``, ``nerf_q_wg_kernel``) relies on, checked on the
CPU with numpy models and integer arithmetic; no card, no ``nvcc``.

* The blob is the sequence of shared-memory images the kernel copies in
  bulk: slabs of 128 bytes a row (128 int8 or 64 bf16 k) with the 128-byte
  swizzle, in the order the chain consumes them, the panels that read a
  requantised activation with their K columns permuted (pi, ``k_perm``). A
  numpy model of the swizzle, pi and the stage table reads every panel back
  out of the blob, and the stage table agrees with the constants of the
  ``.cu``.
* The s8 fragment identity: under pi, a thread's s32 accumulators are its A
  codes of the next ``wgmma``; without pi they are not. The maps the kernel
  indexes by (the requant packing, the per-channel columns, ``vcon``, the
  heads) are stated as the integer arithmetic of its source.
* The epilogue without the floor's and clamp's conversion instructions: the
  floor as an add rounded down on t / 256 saturated to [0, 1], modelled in
  numpy against ``_requant``; and the s32 -> f32 of the ``magic_s32`` copy
  of the variants script (the bits of 1.5 * 2^23 + acc less 1.5 * 2^23)
  against exact conversion.
* A CPU emulation of the kernel's order (panels and columns read out of the
  blob, codes in permuted order, the numpy models of the epilogue) is bit for
  bit the plain version.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pronerf_tpu_torch.kernels import fused_nerf_q as fq
from pronerf_tpu_torch.models.mlp import NeRFMLP

torch.set_num_threads(2)

CSRC = Path(fq.__file__).resolve().parent / "csrc"
SLAB_BYTES_A_ROW = 128
ACC_MAX = 256 * 127 * 127   # the largest |s32 sum| of an int8 product here


@pytest.fixture(scope="module")
def packed_and_blob():
    net = NeRFMLP(generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for lin in net.modules():  # biases are zero at init: make them count
            if isinstance(lin, torch.nn.Linear):
                lin.bias.uniform_(-0.3, 0.3, generator=torch.Generator(
                ).manual_seed(lin.bias.numel()))
    packed = fq.pack_nerf_params_int8(net, ranges=fq.calibrate_nerf_ranges(
        net, n=2048))
    blob = fq._blob(packed)
    return net, packed, blob.numpy()


# ------------------------------------------------------------ numpy models --

def swizzled_offset(r, k, esize):
    """Byte offset of element (row r, k) of a slab of ``esize``-byte values:
    rows of 128 bytes, the 16-byte chunk of row r that holds k stored at
    chunk (k // (16 / esize)) ^ (r % 8)."""
    per_chunk = 16 // esize
    return (r * SLAB_BYTES_A_ROW + (((k // per_chunk) ^ (r % 8)) << 4)
            + (k % per_chunk) * esize)


def slab_reads(blob, byte_off, rows, dtype):
    """The [rows, 128 / itemsize] values of the slab whose image starts at
    ``byte_off``, un-swizzled by the model."""
    esize = np.dtype(dtype).itemsize
    r, k = np.meshgrid(np.arange(rows), np.arange(SLAB_BYTES_A_ROW // esize),
                       indexing="ij")
    at = byte_off + swizzled_offset(r, k, esize)
    raw = blob[at[..., None] + np.arange(esize)]          # [rows, k, esize]
    return np.ascontiguousarray(raw).view(dtype)[..., 0]


def np_panel(packed, name):
    """A panel as the blob holds it (before pi): ``fq.SCALED`` ones times
    2^-8, bf16 as its bits."""
    a = packed[name] * fq.T_SCALE if name in fq.SCALED else packed[name]
    if a.dtype == torch.bfloat16:
        return a.view(torch.int16).numpy(), np.int16
    return a.numpy(), np.int8


def all_slabs():
    """(panel, row0, rows, ks, byte offset in the blob) of every slab: the
    ring stages by the stage table, then the resident heads."""
    out = []
    for (off, nbytes), stage in zip(fq.stage_table(), fq.RING_STAGES):
        at = off
        for name, row0, rows, ks in stage:
            out.append((name, row0, rows, ks, at))
            at += rows * SLAB_BYTES_A_ROW
        assert at == off + nbytes
    at = sum(b for _, b in fq.stage_table())
    for name, row0, rows, ks in fq.HEAD_SLABS:
        out.append((name, row0, rows, ks, at))
        at += rows * SLAB_BYTES_A_ROW
    return out, at


def stored_panel(blob, name, shape, dtype):
    """A panel as the kernel sees it, [rows, K in the order of the blob],
    assembled from its slabs by the model (K padded to whole slabs)."""
    n = SLAB_BYTES_A_ROW // np.dtype(dtype).itemsize
    out = np.zeros((shape[0], -(-shape[1] // n) * n), dtype)
    for pname, row0, rows, ks, off in all_slabs()[0]:
        if pname == name:
            out[row0:row0 + rows, ks * n:(ks + 1) * n] = slab_reads(
                blob, off, rows, dtype)
    return out


def columns(packed, blob):
    """The f32 columns read out of the blob: {name: [C]}, from the pairs
    {A(2p), A(2p+1), B(2p), B(2p+1)} (those of ``fq.SCALED`` times
    2^-8)."""
    at = sum(b for _, b in fq.stage_table()) + 3 * 1024
    cols = blob[at:].view(np.float32)
    out, i = {}, 0
    for a, b in fq.COLUMN_PAIRS:
        n = packed[a].numel()
        pairs = cols[i:i + 2 * n].reshape(n // 2, 2, 2)
        out[a], out[b] = pairs[:, 0].reshape(-1), pairs[:, 1].reshape(-1)
        i += 2 * n
    for name in ("vcon_scale",) + fq.HEAD_COLUMNS:
        n = packed[name].numel()
        out[name] = cols[i:i + n]
        i += n
    assert i == cols.size
    return out


def s32_f32(acc):
    """s32 -> f32 without a conversion instruction (the ``magic_s32`` copy of
    ``scripts/torch_nerf_q_variants.py``): the bits of 0x4B400000 + acc as
    f32, less 12582912 (1.5 * 2^23), in f32. The kernel takes one I2FP, which
    is exact for these sums."""
    bits = (np.asarray(acc, np.int64) + 0x4B400000).astype(np.int32)
    return bits.view(np.float32) - np.float32(12582912.0)


def fadd_rd(x, y):
    """x + y rounded down to f32 (CUDA's __fadd_rd): the sum in f64, which is
    exact, or rounds by far less than a unit of f32 here, taken down to the
    next f32 at or below it."""
    s = x.astype(np.float64) + np.float64(y)
    f = s.astype(np.float32)
    return np.where(f.astype(np.float64) > s,
                    np.nextafter(f, np.float32(-np.inf)), f)


def requant_code(t_scaled):
    """The kernel's requantisation (``requant_byte``) of t' = t / 256 (f32):
    y = t' + 2^-9 saturated to [0, 1] (add.rn.sat: a NaN goes to 0), then
    fminf(y, 254 / 256), then the low byte of that plus 2^15 + 129 / 256
    rounded down, as an int8 code."""
    y = (np.asarray(t_scaled, np.float32) + np.float32(2.0 ** -9)).astype(
        np.float32)
    y = np.where(np.isnan(y), np.float32(0.0), np.clip(y, 0.0, 1.0))
    y = np.fmin(y.astype(np.float32), np.float32(254 / 256))
    bits = fadd_rd(y.astype(np.float32), 32768.50390625).view(np.uint32)
    return (bits & 0xFF).astype(np.uint8).view(np.int8)


# -------------------------------------------------------------- the blob --

def test_int8_blob_reads_back_every_panel_bit_for_bit(packed_and_blob):
    _, packed, blob = packed_and_blob
    slabs, _ = all_slabs()
    for name, row0, rows, ks, off in slabs:
        panel, dtype = np_panel(packed, name)
        if name in fq.PERMUTED:
            panel = panel[:, fq.k_perm(panel.shape[1])]
        n = SLAB_BYTES_A_ROW // np.dtype(dtype).itemsize
        want = np.zeros((rows, n), dtype)   # PE panels: zero column 63
        k1 = min(n * (ks + 1), panel.shape[1])
        want[:, : k1 - n * ks] = panel[row0:row0 + rows, n * ks:k1]
        np.testing.assert_array_equal(
            slab_reads(blob, off, rows, dtype), want,
            err_msg=f"{name} {row0} {ks}")


def test_every_panel_element_is_in_the_blob_exactly_once(packed_and_blob):
    _, packed, blob = packed_and_blob
    slabs, end_of_slabs = all_slabs()
    seen = {}
    for name, row0, rows, ks, _ in slabs:
        n = SLAB_BYTES_A_ROW // packed[name].element_size()
        cover = seen.setdefault(
            name, np.zeros((packed[name].shape[0],
                            -(-packed[name].shape[1] // n) * n), np.int32))
        cover[row0:row0 + rows, n * ks:n * (ks + 1)] += 1
    weights = {k for k in packed if k.startswith("w")}
    assert set(seen) == weights
    assert all((c == 1).all() for c in seen.values())
    assert set(fq.PERMUTED) == weights - {"w0p_t", "w5p_t"}
    # ... the columns follow the heads, and nothing else
    assert end_of_slabs + 4 * sum(
        packed[k].numel() for k in packed
        if k[0] in "AB" or k == "vcon_scale") == blob.size


def test_pad_columns_and_head_pad_rows_are_zero(packed_and_blob):
    """... and the PE panels are there whole, w5p times 2^-8."""
    _, packed, blob = packed_and_blob
    for name in ("w0p_t", "w5p_t"):
        assert packed[name].shape[1] == 63
        stored = stored_panel(blob, name, (256, 63), np.int16)
        assert stored.shape == (256, 64) and not stored[:, 63].any()
        np.testing.assert_array_equal(stored[:, :63],
                                      np_panel(packed, name)[0])
    alpha = stored_panel(blob, "waq", (8, 256), np.int8)
    rgb = stored_panel(blob, "wrq", (8, 128), np.int8)
    assert alpha[0].any() and not alpha[1:].any()
    assert rgb[:3].any() and not rgb[3:].any()


def test_columns_read_back_from_the_blob(packed_and_blob):
    _, packed, blob = packed_and_blob
    got = columns(packed, blob)
    names = [n for pair in fq.COLUMN_PAIRS for n in pair] + [
        "vcon_scale", *fq.HEAD_COLUMNS]
    assert sorted(names) == sorted(
        k for k in packed if k[0] in "AB" or k == "vcon_scale")
    for name in names:
        want = packed[name].reshape(-1).numpy()
        if name in fq.SCALED:
            want = want * np.float32(fq.T_SCALE)
        np.testing.assert_array_equal(got[name], want, name)
    assert set(fq.SCALED) == set(names) - set(fq.HEAD_COLUMNS) | {"w5p_t"}


def test_stage_table_tiles_the_ring_region():
    table = fq.stage_table()
    assert len(table) == len(fq.RING_STAGES) == 21
    at = 0
    for off, nbytes in table:
        assert off == at and off % 1024 == 0
        assert nbytes in (16384, 24576, 32768)
        at += nbytes
    # all weights but the two heads, once: 2 PE panels (bf16, K 64), 8 square
    # int8 panels, the view panel
    assert at == 2 * 256 * 64 * 2 + 8 * 256 * 256 + 128 * 256
    # a slab image keeps the swizzle's period, and a slab of a stage starts
    # on a 1,024-byte line of its slot (the descriptor's base)
    for stage in fq.RING_STAGES + (fq.HEAD_SLABS,):
        rows_before = 0
        for _, _, rows, _ in stage:
            assert rows % 8 == 0 and (rows_before * 128) % 1024 == 0
            rows_before += rows


def test_stage_table_agrees_with_the_cuda_source(packed_and_blob):
    _, _, blob = packed_and_blob
    src = (CSRC / "fused_nerf_q.cu").read_text()

    def const(name):
        return int(re.search(rf"{name} = (\d+)", src).group(1))

    table = fq.stage_table()
    n, q5, view = (const("kStagesPerSample"), const("kFirstQuarter5"),
                   const("kFirstView"))
    assert n == len(table)
    m = re.search(r"return i >= kFirstView \? (\d+)\s*: \(i >= kFirstQuarter5 "
                  r"&& i < kFirstQuarter5 \+ 4\) \? (\d+)\s*: (\d+);", src)
    view_b, quarter_b, other_b = (int(x) for x in m.groups())

    def stage_bytes(i):   # QBlob::stage_bytes, as the source computes it
        return view_b if i >= view else quarter_b if q5 <= i < q5 + 4 \
            else other_b

    assert [stage_bytes(i) for i in range(n)] == [b for _, b in table]
    # ... and the stages are what the source's comment says they are
    assert [len(st) for st in fq.RING_STAGES[q5:q5 + 4]] == [3] * 4
    assert all(st[0][0] == "w5p_t" for st in fq.RING_STAGES[q5:q5 + 4])
    assert all(st[0][0] == "wvq" for st in fq.RING_STAGES[view:])
    ring = int(re.search(r"kRingBytes = (\d+) \* 1024", src).group(1)) * 1024
    assert ring == sum(b for _, b in table)
    heads = 3 * 1024
    assert "kAlphaBytes = 2 * 1024, kRgbBytes = 1024;" in src
    cols = 8 * 2048 + 2048 + 1024 + 512 + 128   # QBlob::kColBytes
    assert blob.size == ring + heads + cols
    # the consumer's pointers into the columns: a layer's pairs are 128 float4
    # apart, the view pairs after the feature layer's, then vcon_scale
    assert "cols + 128 * 5 + 16 * e" in src and "cols + 128 * 9 + 16 * e" in src
    assert (8 * 2048 + 2048) // 16 == 128 * 9


def test_shared_memory_fits_at_every_sample_count():
    """QSmem as the source lays it out: nothing depends on S (the results go
    straight to device memory), and the PE rows, the resident part, the
    barriers, the tile's vcon (64 KB) and three ring slots fit the 227 KB of
    a block; a fourth slot would not."""
    src = (CSRC / "fused_nerf_q.cu").read_text()
    hop = (CSRC / "hopper.cuh").read_text()
    body = re.search(r"struct QSmem \{(.*?)\};", src, re.S).group(1)
    assert not re.search(r"\bS\b", body)
    assert "kBytes = 1024 + ring + kStages * kRingStageBytes" in body
    assert "kVvBytes = 2 * 64 * 128 * 4" in body
    stages = int(re.search(r"kStages = (\d+);", body).group(1))
    assert stages <= int(re.search(r"kMaxStages = (\d+);", hop).group(1))
    slot = int(re.search(r"kRingStageBytes = (\d+);", hop).group(1))
    pe = 4 * 64 * 64 * 2
    bars = pe + 3 * 1024 + (8 * 2048 + 2048 + 1024 + 512 + 128)
    ring = (bars + 128 + 2 * 64 * 128 * 4 + 1023) & ~1023

    def total(n):
        return 1024 + ring + n * slot

    assert total(stages) <= 232448 < total(stages + 1)
    assert max(b for _, b in fq.stage_table()) <= slot
    assert pe % 1024 == 0 and (bars + 128) % 16 == 0


# ------------------------------------------------------ fragment maps ----

def acc_element(t, i):
    """(row, column) of accumulator register i of thread t of a warpgroup,
    for a wgmma m64nN product (hopper.cuh): bf16 k16 and int8 k32 alike."""
    w, lane = t // 32, t % 32
    g, q = lane // 4, lane % 4
    return 16 * w + g + 8 * ((i // 2) % 2), 8 * (i // 4) + 2 * q + i % 2


def a8_element(t, j, reg, e):
    """(row, k) of byte e of A register ``reg`` (0..3) of k-step j of thread
    t: the fragment an int8 m64nNk32 ``wgmma`` reads from registers (the
    PTX ISA's register fragment layout for A, .k32: row g for registers 0
    and 2, row g + 8 for 1 and 3; k 4 q + e, then 16 further)."""
    w, lane = t // 32, t % 32
    g, q = lane // 4, lane % 4
    return 16 * w + g + 8 * (reg % 2), 32 * j + 16 * (reg // 2) + 4 * q + e


def requant_sources(m, r):
    """The accumulators whose codes A register 2 m + r holds, byte 0 first:
    ``wg_requant``'s i, i + 1, i + 4, i + 5 with i = 8 m + 2 r."""
    i = 8 * m + 2 * r
    return (i, i + 1, i + 4, i + 5)


def test_k_perm_permutes_inside_chunks_of_16():
    for k in (128, 256):
        p = fq.k_perm(k)
        assert sorted(p) == list(range(k))
        assert (p // 16 == np.arange(k) // 16).all()
    assert list(fq.k_perm(16)) == [0, 1, 8, 9, 2, 3, 10, 11,
                                   4, 5, 12, 13, 6, 7, 14, 15]


@pytest.mark.parametrize("nacc", [64, 32])   # a half, a quarter
def test_accumulators_are_the_next_products_a_codes_under_pi(nacc):
    """Byte e of A register 2 m + r (k-step m // 2, register 2 (m % 2) + r)
    is the code of accumulator requant_sources(m, r)[e]: the same row, and
    the accumulator's column is pi of the byte's k."""
    pi = fq.k_perm(256)
    for t in range(128):
        for m in range(nacc // 8):
            for r in range(2):
                j, reg = m // 2, 2 * (m % 2) + r
                for e, i in enumerate(requant_sources(m, r)):
                    row, k = a8_element(t, j, reg, e)
                    assert acc_element(t, i) == (row, pi[k]), (t, m, r, e)
    # every (row, k) of an A tile is one thread's byte, once
    seen = np.zeros((64, 32), np.int32)
    for t in range(128):
        for reg in range(4):
            for e in range(4):
                r, k = a8_element(t, 0, reg, e)
                seen[r, k] += 1
    assert (seen == 1).all()


def test_without_pi_the_accumulators_are_not_the_a_codes():
    bad = 0
    for t in range(128):
        for m in range(8):
            for r in range(2):
                for e, i in enumerate(requant_sources(m, r)):
                    row, k = a8_element(t, m // 2, 2 * (m % 2) + r, e)
                    bad += acc_element(t, i) != (row, k)
    # only bytes 0, 1 of the lanes q = 0 and bytes 2, 3 of q = 3 land on
    # their own column: three bytes of four do not
    assert bad == 3 * (128 * 8 * 2 * 4) // 4


def test_requant_reads_each_accumulators_own_column_pair():
    """``wg_requant`` takes A, B of accumulator i from cols[8 m] (i in n-tile
    2 m) or cols[8 m + 4] (n-tile 2 m + 1), with ``cols`` offset by q and a
    pair's x / z (y / w) for even (odd) i: that is the pair index of the
    accumulator's column (pair p = columns 2 p, 2 p + 1), and its half."""
    for t in range(128):
        q = t % 4
        for m in range(8):
            for r in range(2):
                for slot, i in enumerate(requant_sources(m, r)):
                    pair = q + (8 * m if slot < 2 else 8 * m + 4)
                    _, col = acc_element(t, i)
                    assert (col // 2, col % 2) == (pair, slot % 2)


def test_view_and_head_maps_of_the_kernel():
    """The view layer runs in eighths e of 32 outputs (m64n32). The helpers
    write vcon * vcon_scale of ray r (of the tile's 128) and column c to
    thread wt of warpgroup r >> 6, element 16 e + i, by the formulas of
    ``q_write_vcon``; that is the (row, column) of that thread's accumulator
    i of eighth e, each exactly once. The eighth writes A registers 4 e ..
    4 e + 3 of the rgb head (k-step e); the sigma head's column 0 is
    accumulators 0 and 2 of the lanes q = 0; the rgb head's v[i] is column
    2 q + (i & 1), and the lane below takes column 2 from the lane of q = 1
    (shfl_down by 1)."""
    src = (CSRC / "fused_nerf_q.cu").read_text()
    assert "const int w = r >> 6, row = r & 63;" in src
    assert ("const int wt = 32 * (row >> 4) + 4 * (row & 7) + ((c >> 1) & 3);"
            in src)
    assert ("const int i = 16 * (c >> 5) + 4 * ((c >> 3) & 3) + "
            "2 * ((row >> 3) & 1) +\n                  (c & 1);") in src
    assert "vv[(w * 64 + i) * 128 + wt]" in src and "hv + 4 * e" in src
    seen = np.zeros((2, 64, 128), np.int32)
    for r in range(128):
        for c in range(128):
            w, row = r >> 6, r & 63
            wt = 32 * (row >> 4) + 4 * (row & 7) + ((c >> 1) & 3)
            ie = (16 * (c >> 5) + 4 * ((c >> 3) & 3) + 2 * ((row >> 3) & 1)
                  + (c & 1))
            seen[w, ie, wt] += 1
            e, i = ie // 16, ie % 16
            got_row, got_col = acc_element(wt, i)
            assert (got_row, 32 * e + got_col) == (row, c), (r, c)
    assert (seen == 1).all()
    pi = fq.k_perm(128)
    for t in range(128):
        w, lane = t // 32, t % 32
        g, q = lane // 4, lane % 4
        row0 = 16 * w + g
        for e in range(4):
            # the eighth's four A registers are k-step e of the rgb head
            for m in range(2):
                for rr in range(2):
                    for byte, i in enumerate(requant_sources(m, rr)):
                        row, k = a8_element(t, e, 2 * m + rr, byte)
                        assert (row, pi[k]) == (acc_element(t, i)[0],
                                                32 * e + acc_element(t, i)[1])
        heads = [acc_element(t, i) for i in range(4)]
        assert [c for _, c in heads] == [2 * q, 2 * q + 1] * 2
        assert [r for r, _ in heads] == [row0] * 2 + [row0 + 8] * 2
        if q == 0:   # column 2 of the same rows sits in lane + 1 (q = 1)
            assert acc_element(t + 1, 0) == (row0, 2)
            assert acc_element(t + 1, 2) == (row0 + 8, 2)


# ------------------------------------------------- epilogue arithmetic ----

@pytest.mark.parametrize("acc", [
    np.arange(-ACC_MAX, -ACC_MAX + 4096),
    np.arange(ACC_MAX - 4095, ACC_MAX + 1),
    np.arange(-4096, 4097),
    np.random.default_rng(0).integers(-ACC_MAX, ACC_MAX + 1, 200_000),
], ids=["near_-max", "near_+max", "near_0", "random"])
def test_s32_to_f32_without_conversion_is_exact(acc):
    got = s32_f32(acc)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, acc.astype(np.float32))
    np.testing.assert_array_equal(got.astype(np.int64), acc)


def test_s32_to_f32_bound():
    """256 * 127 * 127 is inside the bound |acc| <= 2^22; one past it, the
    trick is off."""
    assert ACC_MAX < 2 ** 22
    assert s32_f32(np.array([2 ** 22]))[0] == 2.0 ** 22
    assert s32_f32(np.array([2 ** 22 + 1]))[0] != 2.0 ** 22 + 1


def boundary_values():
    """t on and next to every .5 boundary in [-2, 256] (and the integers
    between), a few ulps each way."""
    k = np.arange(-2, 257, dtype=np.float32)
    centres = np.concatenate([k + np.float32(0.5), k]).astype(np.float32)
    out = [centres]
    up, down = centres.copy(), centres.copy()
    for _ in range(3):
        up = np.nextafter(up, np.float32(np.inf))
        down = np.nextafter(down, np.float32(-np.inf))
        out += [up, down]
    return np.concatenate(out)


@pytest.mark.parametrize("t", [
    boundary_values(),
    np.random.default_rng(1).uniform(-10, 300, 500_000).astype(np.float32),
    np.array([0.0, -0.0, 1e-38, -1e-38, 1e-45, 254.49998, 254.5, 255.0, 1e9,
              -1e9, 3.4e38, -3.4e38, np.inf, -np.inf], np.float32),
], ids=["boundaries", "random", "extremes"])
def test_requant_without_conversion_matches_the_plain_requant(t):
    scaled = (t * np.float32(fq.T_SCALE)).astype(np.float32)
    # exact wherever t / 256 is a normal f32 (the subnormal t here code 0
    # either way, as the kernel's t' would)
    normal = ~(np.abs(t) < 2.0 ** -118)
    assert np.array_equal((scaled * np.float32(256.0))[normal], t[normal])
    got = requant_code(scaled)
    want = fq._requant(torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= -127


def test_requant_model_is_floor_and_clamp_exactly():
    """The model against exact rational arithmetic on the boundaries: code =
    clamp(floor(rn(t + .5)), 0, 254) - 127, t' = t / 256 in and out of the
    saturating add (scaling by 2^-8 commutes with the rounding)."""
    t = boundary_values()
    y = (t + np.float32(0.5)).astype(np.float32).astype(np.float64)
    want = np.clip(np.floor(y), 0, 254) - 127
    got = requant_code((t * np.float32(fq.T_SCALE)).astype(np.float32))
    np.testing.assert_array_equal(got.astype(np.float64), want)


# ---------------------------------------------------- kernel-order chain --

def emulate_kernel_order(packed, blob, pts24_t, vcon_t, S=8):
    """The int8 chain in the kernel's order: every int8 panel and every
    per-channel column read out of the blob, the activation's codes carried
    in the permuted order the A registers hold them (codes[:, pi]), the
    requantisation by the numpy model above, on t / 256 as the
    kernel computes it. The two PE products are the plain version's own f32
    sums (the kernel's f32 sums on the tensor cores run in another order,
    which no CPU model repeats)."""
    N = pts24_t.shape[1]
    pi = fq.k_perm(256)
    cols = columns(packed, blob)
    f32 = np.float32

    def panel(name, shape):
        return stored_panel(blob, name, shape, np.int8).astype(np.int64)

    x = torch.from_numpy(pts24_t).T.reshape(N, S, 3).to(torch.bfloat16)
    xb = fq._mmf(x, packed["bx_t"])
    pe = torch.cat([x, torch.sin(xb).to(torch.bfloat16),
                    torch.cos(xb).to(torch.bfloat16)], dim=-1)
    pe0 = fq._mmf(pe, packed["w0p_t"]).numpy().reshape(N * S, 256)
    # the blob's w5p is times 2^-8, and so is every partial sum of pe5
    pe5 = fq._mmf(pe, packed["w5p_t"]).numpy().reshape(N * S, 256) * f32(
        fq.T_SCALE)

    def layer(codes, name, a, b, mid=None):
        """acc of the permuted codes against the stored panel, then t."""
        w = panel(name, packed[name].shape)
        k = w.shape[1]
        acc = codes[:, fq.k_perm(k)].astype(np.int64) @ w.T
        assert np.abs(acc).max() <= ACC_MAX
        t = acc.astype(f32) * cols[a]   # I2FP: exact for these sums
        if mid is not None:
            t = (t + mid).astype(f32)
        return (t + cols[b]).astype(f32)

    h = requant_code((pe0 * cols["A0"]).astype(f32) + cols["B0"])
    for i in (1, 2, 3, 4):
        h = requant_code(layer(h, f"w{i}q", f"A{i}", f"B{i}"))
    h = requant_code(layer(h, "w5q", "A5", "B5", mid=pe5))
    for i in (6, 7):
        h = requant_code(layer(h, f"w{i}q", f"A{i}", f"B{i}"))
    sigma = layer(h, "waq", "Aa", "Ba")[:, 0]   # the heads are not scaled
    fq_codes = requant_code(layer(h, "wfq", "Af", "Bf"))
    vcon = (vcon_t.T[:, None, :] * cols["vcon_scale"]).astype(f32)
    vcon = np.broadcast_to(vcon, (N, S, 128)).reshape(N * S, 128)
    hv = requant_code(layer(fq_codes, "wvq", "Av", "Bv", mid=vcon))
    rgb = layer(hv, "wrq", "Ar", "Br")[:, :3]
    assert pi.shape == (256,)
    return np.concatenate([rgb, sigma[:, None]], axis=1).reshape(N, S, 4)


@pytest.mark.parametrize("n", [37, 128])
def test_kernel_order_emulation_is_bit_identical_to_the_plain_version(
        packed_and_blob, n):
    net, packed, blob = packed_and_blob
    rng = np.random.default_rng(n)
    pts24_t = rng.uniform(-1, 1, (24, n)).astype(np.float32)
    vcon_t = rng.normal(0, 0.5, (128, n)).astype(np.float32)
    got = emulate_kernel_order(packed, blob, pts24_t, vcon_t)
    want = fq.fused_nerf_raw_q_plain(packed, torch.from_numpy(pts24_t),
                                     torch.from_numpy(vcon_t)).numpy()
    assert np.isfinite(want).all() and want.std() > 0
    np.testing.assert_array_equal(got, want)


def test_emulation_without_pi_in_the_panels_is_wrong(packed_and_blob):
    """The same emulation on a blob whose int8 panels were NOT permuted:
    the codes then meet the wrong weights, and the output moves far."""
    _, packed, _ = packed_and_blob
    plain = {k: v for k, v in packed.items() if not k.startswith("_")}
    saved = fq.PERMUTED
    try:
        fq.PERMUTED = ()
        blob = fq._blob(plain).numpy()
    finally:
        fq.PERMUTED = saved
    rng = np.random.default_rng(3)
    pts24_t = rng.uniform(-1, 1, (24, 64)).astype(np.float32)
    vcon_t = rng.normal(0, 0.5, (128, 64)).astype(np.float32)
    got = emulate_kernel_order(packed, blob, pts24_t, vcon_t)
    want = fq.fused_nerf_raw_q_plain(packed, torch.from_numpy(pts24_t),
                                     torch.from_numpy(vcon_t)).numpy()
    assert np.abs(got - want).max() > 0.1 * want.std()
