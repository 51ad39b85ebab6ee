"""The layouts the bf16 MinMax kernel (``csrc/fused_minmax.cu:
minmax_wg_kernel``) relies on, for the sampler (C = 6, head 27 -> 32), the
refine net (C = 102, head 35 -> 40) and three wider refine nets whose
layer 0 runs in passes of 128 input rows (16 samples of 4 views, C = 198,
and of 8 views, C = 390; head 67 -> 72; 128 samples of 4 views, C = 1542,
head 515 -> 520), checked on the CPU with numpy models and integer
arithmetic; no card, no ``nvcc``.

* The bf16 blob is the ring stages of one tile (layer 0 one stage a half and
  pass, each hidden layer four), the head slabs, the biases: every panel
  element is in it once and reads back bit for bit through a model of the
  slab swizzle; the pad columns of layer 0 and the pad rows of the head are
  zero.
* The stage table agrees with the constants and formulas of the CUDA source.
* The helper warps' write map of the layer-0 A rows of each pass, (ray, k)
  -> swizzled byte, covers each warpgroup's slabs once, where the descriptor
  reads them.
* The head's result map (accumulator -> result row) and the store map
  (result row -> ``out``) cover ``[N, out_pad]`` and ``[out_pad, N]`` once,
  the ragged last tile included.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pronerf_tpu_torch.kernels import fused_minmax as fm
from pronerf_tpu_torch.kernels import stages
from pronerf_tpu_torch.models.mlp import MinMaxMLP

torch.set_num_threads(2)

CSRC = Path(fm.__file__).resolve().parent / "csrc"
# name: (reps, trailing rows, head width): the folded input is 6 + trailing
SHAPES = {"sampler": (48, 0, 27), "refine": (8, 96, 35),
          "refine_16x4": (16, 192, 67), "refine_16x8": (16, 384, 67),
          "refine_128x4": (128, 1536, 515)}
TILE, RAYS_WG, A_SLAB = 128, 64, 64 * 128


def bits(t):
    return t.contiguous().view(torch.int16).numpy()


@pytest.fixture(scope="module", params=sorted(SHAPES))
def case(request):
    reps, rest, out_w = SHAPES[request.param]
    net = MinMaxMLP(input_ch=6 * reps + rest, output_ch=out_w,
                    generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        for lin in net.modules():  # make the biases count
            if isinstance(lin, torch.nn.Linear):
                lin.bias.uniform_(-1, 1, generator=torch.Generator().manual_seed(
                    lin.bias.numel()))
    packed = fm.pack_minmax_params(net, reps, torch.bfloat16)
    return request.param, packed, fm._blob(packed).view(torch.int16).numpy()


def swizzled_offset(r, k):
    """Byte offset of element (row r, k in 0..63) inside a slab."""
    return r * 128 + (((k >> 3) ^ (r & 7)) << 4) + ((k & 7) << 1)


def all_slabs(packed):
    """(panel, row0, rows, ks, byte offset) of every slab, and the end."""
    out = []
    ring = fm.ring_stages(packed)
    for (off, _), stage in zip(stages.stage_table(ring), ring):
        for name, row0, rows, ks in stage:
            out.append((name, row0, rows, ks, off))
            off += rows * stages.SLAB_ROW_BYTES
    at = sum(b for _, b in stages.stage_table(ring))
    for name, row0, rows, ks in fm.head_slabs(packed):
        out.append((name, row0, rows, ks, at))
        at += rows * stages.SLAB_ROW_BYTES
    return out, at


def test_every_panel_element_reads_back_once_bit_for_bit(case):
    _, packed, blob16 = case
    slabs, end = all_slabs(packed)
    seen = {}
    for name, row0, rows, ks, off in slabs:
        panel = bits(packed[name])
        r, k = np.meshgrid(np.arange(rows), np.arange(64), indexing="ij")
        got = blob16[(off + swizzled_offset(r, k)) // 2]
        want = np.zeros((rows, 64), np.int16)
        k1 = min(64 * (ks + 1), panel.shape[1])
        want[:, : k1 - 64 * ks] = panel[row0:row0 + rows, 64 * ks:k1]
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {row0} {ks}")
        cover = seen.setdefault(name, np.zeros(
            (panel.shape[0], -(-panel.shape[1] // 64) * 64), np.int32))
        cover[row0:row0 + rows, 64 * ks:64 * (ks + 1)] += 1
    assert set(seen) == {k for k in packed if k.startswith("w")}
    assert all((c == 1).all() for c in seen.values())
    # the biases follow, whole and in the kernel's order, and end the blob
    at = end // 2
    for name in fm.bias_order(packed):
        b = bits(packed[name]).reshape(-1)
        np.testing.assert_array_equal(blob16[at:at + b.size], b, err_msg=name)
        at += b.size
    assert at == blob16.size
    assert set(fm.bias_order(packed)) == {k for k in packed
                                         if k.startswith("b")}


def test_pad_columns_of_layer_0_and_pad_rows_of_the_head_are_zero(case):
    name, packed, blob16 = case
    reps, rest, out_w = SHAPES[name]
    C, out_pad = 6 + rest, -(-out_w // 8) * 8
    assert packed["w0_t"].shape == (256, C)
    assert packed["wout_t"].shape == (out_pad, 256)
    slabs, _ = all_slabs(packed)
    r, k = np.meshgrid(np.arange(128), np.arange(64), indexing="ij")
    for pname, row0, rows, ks, off in slabs:
        img = blob16[(off + swizzled_offset(
            r[:rows], k[:rows])) // 2]
        if pname == "w0_t":
            # columns C.. of the last slab, the k-pad up to 16 included
            kk = 64 * ks + np.arange(64)
            assert not img[:, kk >= C].any()
            assert img[:, kk < min(C, 64 * ks + 64)].any()
        if pname == "wout_t":
            assert rows == out_pad and not img[out_w:].any()
    bout = bits(packed["bout"]).reshape(-1)
    assert not bout[out_w:].any() and bout[:out_w].any()


def test_stage_table_agrees_with_the_cuda_source(case):
    _, packed, blob16 = case
    src = (CSRC / "fused_minmax.cu").read_text()
    hop = (CSRC / "hopper.cuh").read_text()

    def const(text, name):
        return int(re.search(rf"{name} = (\d+);", text).group(1))

    assert const(src, "kStageBytes") == stages.STAGE_BYTES
    assert const(hop, "kRingStageBytes") == stages.STAGE_BYTES
    half = const(hop, "kHalf")
    assert "kSlab128Bytes = kHalf * 128;" in hop
    slab128 = half * stages.SLAB_ROW_BYTES
    per_layer = const(src, "kStagesPerLayer")
    max_slabs = const(src, "kMaxK0Slabs")
    assert max_slabs == fm.PASS_SLABS
    assert "int layer0_stages() const { return 2 * passes; }" in src
    depth = 1 + max(int(k[1:-2]) for k in packed
                    if k.startswith("w") and k[1].isdigit())
    C, out_pad = packed["w0_t"].shape[1], packed["wout_t"].shape[0]
    k0 = -(-C // 16) * 16                   # MmArgs::k0
    n0 = -(-k0 // 64)                       # MmArgs::n0
    passes = -(-n0 // max_slabs)            # MmArgs::passes
    assert (passes > 1) == (C > 64 * max_slabs)
    l0 = 2 * passes                         # layer0_stages()
    table = stages.stage_table(fm.ring_stages(packed))
    assert len(table) == l0 + per_layer * (depth - 1)   # stages_per_tile()
    for i, (off, nbytes) in enumerate(table):           # stage_bytes, _off
        if i < l0:
            hf, pss = divmod(i, passes)
            assert (off, nbytes) == (
                (hf * n0 + max_slabs * pss) * slab128,
                min(max_slabs, n0 - max_slabs * pss) * slab128)
        else:
            assert (off, nbytes) == (
                2 * n0 * slab128 + (i - l0) * stages.STAGE_BYTES,
                stages.STAGE_BYTES)
        assert off % 1024 == 0 and nbytes <= stages.STAGE_BYTES
    heads = sum(b for _, b in table)                    # heads()
    assert "return out_pad * 512;" in src               # head_bytes()
    biases = heads + out_pad * 512                      # biases()
    n_biases = depth * 256 + out_pad                    # n_biases()
    assert blob16.size == biases // 2 + n_biases        # elems()
    assert "return biases() / 2 + n_biases();" in src


def a_write_map(C, pss):
    """Byte offset of every (warpgroup, row, k) the helper threads write into
    the A buffer in layer-0 pass ``pss``, following ``mm_write_a``: thread
    item idx -> ray r = idx % 128, columns k = 128 pss + c0 .. + 7 with
    c0 = 8 (idx / 128), one 16-byte store."""
    k0 = -(-C // 16) * 16
    n0 = -(-k0 // 64)
    n_p = min(n0, fm.PASS_SLABS)            # MmArgs::np
    k_lo = 64 * fm.PASS_SLABS * pss
    writes = {}
    for idx in range(TILE * (min(64 * fm.PASS_SLABS, k0 - k_lo) // 8)):
        r, c0 = idx % TILE, 8 * (idx // TILE)
        row = r % RAYS_WG
        base = ((r // RAYS_WG) * n_p * A_SLAB + (c0 // 64) * A_SLAB
                + row * 128 + ((((c0 % 64) >> 3) ^ (row & 7)) << 4))
        assert base % 16 == 0
        for e in range(8):
            writes.setdefault(base + 2 * e, []).append(
                (r // RAYS_WG, row, k_lo + c0 + e))
    return writes, k0, n0, n_p


@pytest.mark.parametrize("C", [6, 102, 198, 390, 1542])
def test_layer_0_a_rows_are_written_once_where_the_descriptor_reads(C):
    src = (CSRC / "fused_minmax.cu").read_text()
    assert "row * 128 + ((((c0 % 64) >> 3) ^ (row & 7)) << 4)) =" in src
    assert "const int r = idx % kWgTile, c0 = 8 * (idx / kWgTile)" in src
    assert "const int ray = base + r, k = k_lo + c0;" in src
    assert "abuf + (r / kWgRays) * a.np * kASlabBytes" in src
    passes = -(-(-(-C // 16) * 16) // (64 * fm.PASS_SLABS))
    seen = set()
    for pss in range(passes):
        writes, k0, n0, n_p = a_write_map(C, pss)
        assert (k0, n0) == {6: (16, 1), 102: (112, 2), 198: (208, 4),
                            390: (400, 7), 1542: (1552, 25)}[C]
        # every byte pair once in the pass
        assert all(len(v) == 1 for v in writes.values())
        got = {v[0]: off for off, v in writes.items()}
        k_lo = 64 * fm.PASS_SLABS * pss
        k_hi = min(k0, k_lo + 64 * fm.PASS_SLABS)
        want = {(w, row, k) for w in (0, 1) for row in range(RAYS_WG)
                for k in range(k_lo, k_hi)}
        assert set(got) == want
        seen |= want
        # the k-steps a warpgroup's descriptor reads in the pass: slab
        # (k - k_lo) // 64 at + that * A_SLAB from its base, the slab
        # swizzle inside
        for (w, row, k), off in got.items():
            assert off == (w * n_p * A_SLAB + ((k - k_lo) // 64) * A_SLAB
                           + swizzled_offset(row, k % 64))
        # the two warpgroups' regions do not overlap and fit the buffer
        assert max(writes) < 2 * n_p * A_SLAB
    # the passes together cover every (warpgroup, row, k) of the input
    assert seen == {(w, row, k) for w in (0, 1) for row in range(RAYS_WG)
                    for k in range(-(-C // 16) * 16)}


def acc_element(t, i):
    """(row, column) of accumulator register i of thread t, wgmma m64nNk16."""
    w, lane = t // 32, t % 32
    g, q = lane // 4, lane % 4
    return 16 * w + g + 8 * ((i // 2) % 2), 8 * (i // 4) + 2 * q + i % 2


@pytest.mark.parametrize("out_pad", [32, 40])
def test_head_results_cover_the_tile_once(out_pad):
    """``mm_head_store``: chunks of 32 columns, then of 8; pair p of a thread
    goes to result row wg * 64 + 16 w + g + 8 (p % 2), column c0 + 8 (p / 2)
    + 2 q, as the accumulator map says."""
    src = (CSRC / "fused_minmax.cu").read_text()
    assert "r = row0 + 8 * (p % 2), c = c0 + 8 * (p / 2) + 2 * q;" in src
    seen = np.zeros((TILE, out_pad), np.int32)
    chunks = [(c0, 32) for c0 in range(0, out_pad - 31, 32)]
    chunks += [(c0, 8) for c0 in range(32 * (out_pad // 32), out_pad, 8)]
    assert sum(n for _, n in chunks) == out_pad
    for wg in (0, 1):
        for t in range(128):
            w, lane = t // 32, t % 32
            g, q = lane // 4, lane % 4
            row0 = wg * RAYS_WG + 16 * w + g
            for c0, n in chunks:
                for p in range(n // 4):
                    r, c = row0 + 8 * (p % 2), c0 + 8 * (p // 2) + 2 * q
                    assert (r - wg * RAYS_WG, c - c0) == acc_element(t, 2 * p)
                    assert (c - c0 + 1) == acc_element(t, 2 * p + 1)[1]
                    seen[r, c] += 1
                    seen[r, c + 1] += 1
    assert (seen == 1).all()


def store_map(N, out_pad, sr, sc):
    """Indices of ``out`` the helper threads write for every tile of N rays,
    following the output lambda of ``minmax_wg_kernel``, with the result
    element each one comes from."""
    written = {}
    for tile in range(-(-N // TILE)):
        base = tile * TILE
        live = min(TILE, N - base)
        if sc == 1 and sr == out_pad:
            for idx in range(live * out_pad // 4):   # float4 from 4 bf16
                for e in range(4):
                    el = 4 * idx + e
                    written.setdefault(base * out_pad + el, []).append(
                        (base + el // out_pad, el % out_pad))
        else:
            for idx in range(out_pad * TILE):
                n, r = idx // TILE, idx % TILE
                if r < live:
                    written.setdefault((base + r) * sr + n * sc, []).append(
                        (base + r, n))
    return written


@pytest.mark.parametrize("N", [100, 300, 256])
@pytest.mark.parametrize("out_pad", [32, 40])
@pytest.mark.parametrize("transpose_out", [True, False])
def test_head_store_covers_the_output_once(N, out_pad, transpose_out):
    src = (CSRC / "fused_minmax.cu").read_text()
    assert "if (a.sc == 1 && a.sr == out_pad) {" in src
    assert "a.out[(long long)(base + r) * a.sr + n * a.sc] =" in src
    sr, sc = (out_pad, 1) if transpose_out else (1, N)
    written = store_map(N, out_pad, sr, sc)
    assert all(len(v) == 1 for v in written.values())
    assert sorted(written) == list(range(N * out_pad))
    # each element of out comes from its own (ray, column) of the results
    for off, [(ray, col)] in written.items():
        assert off == ray * sr + col * sc
