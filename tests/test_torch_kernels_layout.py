"""The layouts the bf16 NeRF kernel (``csrc/fused_nerf.cu``) relies on, checked
on the CPU with numpy models and integer arithmetic; no card, no ``nvcc``.

* The bf16 weight blob is the sequence of shared-memory images the kernel
  copies in bulk: k-slabs of 64 with the 128-byte swizzle, in the order the
  chain consumes them. A numpy model of the swizzle and of the stage table
  reads every element (out, k) of every panel back out of the blob, bit for
  bit.
* The stage table tiles the ring region of the blob exactly once, and agrees
  with the constants in the CUDA source.
* The fragment maps of ``wgmma`` (``csrc/hopper.cuh``): accumulator register i
  of thread t <-> (row, column), and the identity that keeps activations in
  registers: the accumulator columns [16 j, 16 j + 16) of a thread are that
  thread's A registers of k-step j.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pronerf_tpu_torch.kernels import fused_nerf as fn
from pronerf_tpu_torch.models.mlp import NeRFMLP

torch.set_num_threads(2)

CSRC = Path(fn.__file__).resolve().parent / "csrc"


@pytest.fixture(scope="module")
def packed_and_blob():
    net = NeRFMLP(generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for lin in net.modules():  # biases are zero at init: make them count
            if isinstance(lin, torch.nn.Linear):
                lin.bias.uniform_(-1, 1, generator=torch.Generator().manual_seed(
                    lin.bias.numel()))
    packed = fn.pack_nerf_params(net, torch.bfloat16)
    blob = fn._blob(packed)
    return packed, blob.view(torch.int16).numpy()


def bits(t):
    return t.contiguous().view(torch.int16).numpy()


def swizzled_offset(r, k):
    """Byte offset of element (row r, k in 0..63) inside a slab: rows of 128
    bytes, the 16-byte chunk k // 8 of row r stored at chunk (k // 8) ^
    (r % 8)."""
    return r * 128 + (((k >> 3) ^ (r & 7)) << 4) + ((k & 7) << 1)


def slab_reads(blob16, byte_off, rows):
    """The [rows, 64] values of the slab whose image starts at ``byte_off``,
    un-swizzled by the model."""
    r, k = np.meshgrid(np.arange(rows), np.arange(64), indexing="ij")
    return blob16[(byte_off + swizzled_offset(r, k)) // 2]


def all_slabs():
    """(panel, row0, rows, ks, byte offset in the blob) of every slab: the
    ring stages by the stage table, then the resident heads."""
    out = []
    for (off, nbytes), stage in zip(fn.stage_table(), fn.RING_STAGES):
        at = off
        for name, row0, rows, ks in stage:
            out.append((name, row0, rows, ks, at))
            at += rows * fn.SLAB_ROW_BYTES
        assert at == off + nbytes
    at = sum(b for _, b in fn.stage_table())
    for name, row0, rows, ks in fn.HEAD_SLABS:
        out.append((name, row0, rows, ks, at))
        at += rows * fn.SLAB_ROW_BYTES
    return out, at


def test_bf16_blob_reads_back_every_panel_bit_for_bit(packed_and_blob):
    packed, blob16 = packed_and_blob
    slabs, _ = all_slabs()
    for name, row0, rows, ks, off in slabs:
        panel = bits(packed[name])
        k_total = panel.shape[1]
        want = np.zeros((rows, 64), np.int16)  # PE panels: zero column 63
        k1 = min(64 * (ks + 1), k_total)
        want[:, : k1 - 64 * ks] = panel[row0:row0 + rows, 64 * ks:k1]
        np.testing.assert_array_equal(
            slab_reads(blob16, off, rows), want, err_msg=f"{name} {row0} {ks}")


def test_every_panel_element_is_in_the_blob_exactly_once(packed_and_blob):
    packed, blob16 = packed_and_blob
    slabs, end_of_slabs = all_slabs()
    seen = {}
    for name, row0, rows, ks, _ in slabs:
        cover = seen.setdefault(
            name, np.zeros((packed[name].shape[0],
                            -(-packed[name].shape[1] // 64) * 64), np.int32))
        cover[row0:row0 + rows, 64 * ks:64 * (ks + 1)] += 1
    weights = {k for k in packed if k.startswith("w")}
    assert set(seen) == weights
    assert all((c == 1).all() for c in seen.values())
    # ... and the biases follow the slabs, whole and in the kernel's order
    at = end_of_slabs // 2
    for name in fn.BIAS_ORDER:
        b = bits(packed[name]).reshape(-1)
        np.testing.assert_array_equal(blob16[at:at + b.size], b, err_msg=name)
        at += b.size
    assert at == blob16.size
    assert set(fn.BIAS_ORDER) == {k for k in packed if k.startswith("b")
                                  and k != "bx_t"}


def test_pe_panels_are_padded_with_one_zero_column(packed_and_blob):
    packed, blob16 = packed_and_blob
    slabs, _ = all_slabs()
    pe_slabs = [s for s in slabs if s[0] in ("w0p_t", "w5p_t")]
    assert sum(rows for _, _, rows, _, _ in pe_slabs) == 2 * 256
    for name, row0, rows, ks, off in pe_slabs:
        assert packed[name].shape[1] == 63 and ks == 0
        assert not slab_reads(blob16, off, rows)[:, 63].any()


def test_stage_table_tiles_the_ring_region():
    table = fn.stage_table()
    assert len(table) == len(fn.RING_STAGES) == 37
    at = 0
    for off, nbytes in table:
        assert off == at and off % 1024 == 0
        assert nbytes in (16384, 32768) and nbytes <= fn.STAGE_BYTES
        at += nbytes
    # all weights but the two heads, once: 2 PE panels, 8 square, the view
    assert at == 2 * (2 * 256 * 64 + 8 * 256 * 256 + 128 * 256)
    # a slab image keeps the swizzle's period: whole groups of 8 rows
    assert all(rows % 8 == 0 for st in fn.RING_STAGES + (fn.HEAD_SLABS,)
               for _, _, rows, _ in st)


def test_stage_table_agrees_with_the_cuda_source(packed_and_blob):
    _, blob16 = packed_and_blob
    src = (CSRC / "fused_nerf.cu").read_text()

    def const(name):
        return int(re.search(rf"{name} = (\d+)", src).group(1))

    table = fn.stage_table()
    assert const("kStageBytes") == fn.STAGE_BYTES
    assert const("kStagesPerSample") == len(table)
    halves = {int(i) for i in re.search(
        r"return i == (\d+) \|\| i == (\d+) \? kStageBytes / 2", src).groups()}
    assert halves == {i for i, (_, b) in enumerate(table)
                      if b == fn.STAGE_BYTES // 2}
    # stage_off(i) as the source computes it
    for i, (off, _) in enumerate(table):
        assert off == (i * fn.STAGE_BYTES
                       - sum(fn.STAGE_BYTES // 2 for h in halves if i > h))
    n_full = int(re.search(r"kRingBytes = (\d+) \* kStageBytes", src).group(1))
    ring_bytes = sum(b for _, b in table)
    assert n_full * fn.STAGE_BYTES == ring_bytes
    # kBlobElems = (ring + heads + 2 * biases) / 2
    heads = sum(rows * fn.SLAB_ROW_BYTES for _, _, rows, _ in fn.HEAD_SLABS)
    assert heads == 4 * 1024 + 2 * 1024
    n_bias = 8 * 256 + 256 + 128 + 8 + 8
    assert blob16.size == (ring_bytes + heads + 2 * n_bias) // 2
    # the bias order the kernel indexes: b0..b7, b_feat, bv, b_alpha, b_rgb
    assert fn.BIAS_ORDER == tuple(f"b{i}" for i in range(8)) + (
        "b_feat", "bv", "b_alpha", "b_rgb")


@pytest.fixture(scope="module")
def donerf_packed_and_blob():
    from pronerf_tpu_torch.models.donerf import init_donerf

    net = init_donerf(torch.Generator().manual_seed(6))
    with torch.no_grad():
        for i, lin in enumerate(net.layers):  # zero at init: make them count
            lin.bias.uniform_(-1, 1, generator=torch.Generator().manual_seed(i))
    packed = fn.pack_donerf_params(net, torch.bfloat16)
    return packed, fn._donerf_blob(packed).view(torch.int16).numpy()


def test_donerf_blob_reads_back_every_panel_bit_for_bit(
        donerf_packed_and_blob):
    """The DoNeRF blob (``DoWgBlob``): every ring stage and the head, read
    back through the swizzle model, each weight element exactly once, then
    the biases in the kernel's order, and nothing else."""
    packed, blob16 = donerf_packed_and_blob
    cover, at = {}, 0
    stages = [(off, st) for (off, _), st in zip(fn.donerf_stage_table(),
                                                 fn.DONERF_RING_STAGES)]
    ring = sum(b for _, b in fn.donerf_stage_table())
    stages.append((ring, fn.DONERF_HEAD_SLABS))
    for off, stage in stages:
        assert off == at
        for name, row0, rows, ks in stage:
            panel = bits(packed[name])
            want = np.zeros((rows, 64), np.int16)
            k1 = min(64 * (ks + 1), panel.shape[1])
            want[:, : k1 - 64 * ks] = panel[row0:row0 + rows, 64 * ks:k1]
            np.testing.assert_array_equal(slab_reads(blob16, at, rows), want,
                                          err_msg=f"{name} {row0} {ks}")
            c = cover.setdefault(name, np.zeros(
                (panel.shape[0], -(-panel.shape[1] // 64) * 64), np.int32))
            c[row0:row0 + rows, 64 * ks:64 * (ks + 1)] += 1
            at += rows * fn.SLAB_ROW_BYTES
    assert set(cover) == {k for k in packed if k.startswith("w")}
    assert all((c == 1).all() for c in cover.values())
    at //= 2
    for name in fn.DONERF_BIAS_ORDER:
        b = bits(packed[name]).reshape(-1)
        np.testing.assert_array_equal(blob16[at:at + b.size], b, err_msg=name)
        at += b.size
    assert at == blob16.size
    assert set(fn.DONERF_BIAS_ORDER) == {
        k for k in packed if k.startswith("b") and k != "bx_t"}


def test_donerf_stage_table_agrees_with_the_cuda_source(
        donerf_packed_and_blob):
    _, blob16 = donerf_packed_and_blob
    src = (CSRC / "fused_nerf.cu").read_text()
    body = re.search(r"struct DoWgBlob \{(.*?)\n\};", src, re.S).group(1)

    def const(name):  # the constant's expression, over kW = 256
        expr = re.search(rf"{name} = ([0-9 *+]+(?:kW)?)[;,]", body).group(1)
        return eval(expr.replace("kW", "256"))

    table = fn.donerf_stage_table()
    assert const("kStagesPerSample") == len(table) == 25
    assert all(b == fn.STAGE_BYTES and off == i * fn.STAGE_BYTES
               for i, (off, b) in enumerate(table))
    heads = sum(rows * fn.SLAB_ROW_BYTES
                for _, _, rows, _ in fn.DONERF_HEAD_SLABS)
    assert const("kHeadBytes") == heads
    n_bias = const("b_out") + 8
    assert n_bias == 7 * 256 + 8
    assert blob16.size == (len(table) * fn.STAGE_BYTES + heads
                           + 2 * n_bias) // 2
    # the head's rows: [rgb, sigma] of the module's last layer, then zeros
    packed = donerf_packed_and_blob[0]
    assert not packed["w_out_t"][fn.DONERF_OUT:].any()
    assert not packed["b_out"][fn.DONERF_OUT:].any()


def test_f32_blob_keeps_the_panel_order():
    net = NeRFMLP(generator=torch.Generator().manual_seed(6))
    packed = fn.pack_nerf_params(net, torch.float32)
    blob = fn._blob(packed)
    at = 0
    for name, k in fn._BLOB_ORDER:
        a = packed[name]
        got = blob[at:at + a.shape[0] * k].reshape(a.shape[0], k)
        assert torch.equal(got[:, : a.shape[1]], a), name
        assert not got[:, a.shape[1]:].any()
        at += a.shape[0] * k
    assert at == blob.numel()


# ------------------------------------------------------ fragment maps ----

def acc_element(t, i):
    """(row, column) of accumulator register i of thread t of a warpgroup,
    for a wgmma m64nNk16 product (hopper.cuh)."""
    w, lane = t // 32, t % 32
    g, q = lane // 4, lane % 4
    return 16 * w + g + 8 * ((i // 2) % 2), 8 * (i // 4) + 2 * q + i % 2


def a_element(t, j, reg, e):
    """(row, k) of half e of A register ``reg`` (0..3) of k-step j of thread
    t: the fragment wgmma reads when A comes from registers."""
    w, lane = t // 32, t % 32
    g, q = lane // 4, lane % 4
    return 16 * w + g + 8 * (reg % 2), 16 * j + 8 * (reg // 2) + 2 * q + e


@pytest.mark.parametrize("n", [128, 8])
def test_accumulator_registers_cover_the_tile_exactly_once(n):
    seen = np.zeros((64, n), np.int32)
    for t in range(128):
        for i in range(n // 2):
            r, c = acc_element(t, i)
            seen[r, c] += 1
    assert (seen == 1).all()


def test_accumulator_columns_are_the_next_products_a_fragment():
    """Accumulator pair p = (2 p, 2 p + 1) of a thread, packed low half
    first, is that thread's A register p % 4 of k-step p // 4: same row,
    and column = k."""
    for t in range(128):
        for p in range(64):  # 128 outputs = 8 k-steps of 4 registers
            j, reg = p // 4, p % 4
            for e in (0, 1):
                assert acc_element(t, 2 * p + e) == a_element(t, j, reg, e)
    # every (row, k) of the A tile is some thread's register half, once
    seen = np.zeros((64, 16), np.int32)
    for t in range(128):
        for reg in range(4):
            for e in (0, 1):
                r, k = a_element(t, 0, reg, e)
                seen[r, k] += 1
    assert (seen == 1).all()


def test_epilogue_maps_of_the_kernel():
    """What the epilogues index by: pair p of a thread sits at columns
    8 (p // 2) + 2 q + {0, 1} (the bias and ``vcon`` pairs) and row
    16 w + g + 8 (p % 2); the heads' column 0..3 live in the threads q = 0
    (columns 0, 1) and q = 1 (columns 2, 3)."""
    for t in range(128):
        w, lane = t // 32, t % 32
        g, q = lane // 4, lane % 4
        for p in range(32):
            for e in (0, 1):
                assert acc_element(t, 2 * p + e) == (
                    16 * w + g + 8 * (p % 2), 8 * (p // 2) + 2 * q + e)
        head = [acc_element(t, i) for i in range(4)]
        assert [c for _, c in head] == [2 * q, 2 * q + 1] * 2
        assert [r for r, _ in head] == [16 * w + g] * 2 + [16 * w + g + 8] * 2


def test_pe_rows_use_the_slab_swizzle():
    """The kernels write the PE rows with the formula of their shared source
    (``hopper.cuh``'s ``wg_write_pe``, which the bf16 and the int8 NeRF kernel
    call); it is the slab swizzle, so the rows can be read through the same
    descriptor as a weight slab."""
    src = (CSRC / "hopper.cuh").read_text()
    assert "((((col >> 3) ^ (r & 7)) << 4) | ((col & 7) << 1))" in src
    for name in ("fused_nerf.cu", "fused_nerf_q.cu"):
        assert "wg_write_pe(a.pts, N, tile * kWgTile, s," in (
            CSRC / name).read_text(), name
    for r in range(128):
        for col in range(64):
            assert (r % 64) * 128 + ((((col >> 3) ^ (r & 7)) << 4)
                                     | ((col & 7) << 1)) \
                == swizzled_offset(r % 64, col)
