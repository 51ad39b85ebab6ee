"""Stage images of the weight blobs that the ``wgmma`` kernels copy into
shared memory in bulk (``csrc/hopper.cuh``'s warpgroup frame), shared by
``fused_nerf.py``, ``fused_minmax.py`` and ``fused_nerf_q.py``.

A SLAB is rows [row0, row0 + rows) of a panel w_t [out, K] at k in
[n ks, n ks + n), n = 128 bytes of k (64 bf16 or 128 int8 values): ``rows x
128`` bytes, the 16-byte chunk c of row r stored at chunk c ^ (r % 8) (the
128-byte swizzle ``wgmma`` reads), K padded with zero columns to a multiple
of n. A STAGE is one bulk copy: a list of slabs, at most ``STAGE_BYTES``. A
kernel computes a 256-wide bf16 layer as two halves of 128 outputs, so a
[256, 256] panel comes as outputs 0..127 (four slabs, two to a stage), then
outputs 128..255 (:func:`halves`).
"""

from __future__ import annotations

import torch

SLAB_K = 64
SLAB_ROW_BYTES = 128
STAGE_BYTES = 32768
W = 256
W_HALF = 128


def slabs(panel, rows=W, row0=0, per_stage=1, n=W // SLAB_K):
    """Stages of ``per_stage`` slabs each over the first ``n`` k-slabs of
    rows [row0, row0 + rows) of ``panel`` (a key of the packed dict); the
    last stage holds what is left."""
    return [[(panel, row0, rows, ks + i)
             for i in range(min(per_stage, n - ks))]
            for ks in range(0, n, per_stage)]


def halves(panel):
    """A [256, 256] panel as the kernels take it: outputs 0..127 over all of
    k (four slabs [128 x 64], two to a stage), then outputs 128..255."""
    return [st for half in (0, 1)
            for st in slabs(panel, W_HALF, half * W_HALF, per_stage=2)]


def stage_table(stages):
    """(byte offset in the blob, bytes) of every stage of ``stages``, in
    order, the first at 0."""
    table, off = [], 0
    for stage in stages:
        nbytes = sum(rows * SLAB_ROW_BYTES for _, _, rows, _ in stage)
        table.append((off, nbytes))
        off += nbytes
    return table


def pad_k(a, k):
    """Panel ``a`` [out, K] with zero columns up to K = k."""
    if a.shape[1] == k:
        return a
    padded = a.new_zeros(a.shape[0], k)
    padded[:, : a.shape[1]] = a
    return padded


def slab_image(a, row0, rows, ks):
    """The swizzled image of one slab of panel ``a`` (K padded with zero
    columns to a multiple of the slab's k), flat, in ``a``'s dtype."""
    n = SLAB_ROW_BYTES // a.element_size()
    a = pad_k(a, -(-a.shape[1] // n) * n)
    chunks = a[row0:row0 + rows, ks * n:(ks + 1) * n].reshape(rows, 8, n // 8)
    r = torch.arange(rows, device=a.device)
    src = torch.arange(8, device=a.device)[None, :] ^ (r % 8)[:, None]
    return chunks[r[:, None], src].reshape(-1)


def images(packed, stages):
    """The flat images of every slab of ``stages``, in order, as a list."""
    return [slab_image(packed[name], row0, rows, ks)
            for stage in stages for name, row0, rows, ks in stage]
