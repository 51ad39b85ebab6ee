"""The JAX package's NeRF Pallas kernels with the one rounding point the port
departs from: the positional encoding taken from the f32 query points.

``pronerf_tpu/kernels/fused_nerf.py:_forward`` and
``fused_nerf_q.py:_forward_q`` cast the points to the pack dtype before
``bx_t . x``; at the top octave (2^9) a bf16 point's phase is wrong by
radians, and a trained scene renders 3.6 dB below the XLA serving path, which
encodes the f32 points (``models/mlp.py:nerf_mlp_apply``). The port's kernels
take the arguments from the f32 points. The copies below differ from the JAX
functions in that line alone, so the port's kernel tests can hold it to JAX's
Pallas kernels at their own tolerances.

``f32_pe()`` swaps the copies in for the length of a ``with`` block and
clears JAX's compilation caches on entry and on exit, so a function traced
inside never serves a call outside (the JAX package's own tests in the same
worker see the kernels as they are). ``jax_kernels_with_f32_pe`` is the same
as a module-scoped autouse fixture: a test module imports it by name.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import pytest

from pronerf_tpu.kernels import fused_nerf as j_fn
from pronerf_tpu.kernels import fused_nerf_q as j_fq


def pe_args(pts3):
    """[3, R] f32 points -> [30, R] sin/cos arguments, row 3k + j = 2^k x_j,
    exactly (what ``bx_t . x`` gives on unrounded points)."""
    pts3 = pts3.astype(jnp.float32)
    return jnp.concatenate([pts3 * 2.0**k for k in range(j_fn.L_PTS)], axis=0)


def _forward(pts3, vcon_ref, ws):
    """``fused_nerf._forward`` with ``xb = pe_args(pts3)``."""
    _mm = j_fn._mm
    (bx_t,
     w0p_t, b0,
     w1_t, b1, w2_t, b2, w3_t, b3, w4_t, b4,
     w5p_t, w5h_t, b5,
     w6_t, b6, w7_t, b7,
     w_alpha_t, b_alpha, w_feat_t, b_feat,
     wvf_t, bv,
     w_rgb_t, b_rgb) = ws

    cdt = w1_t.dtype

    x = pts3.astype(cdt)                             # [3, R]
    xb = pe_args(pts3)                               # [30, R]
    sx = jnp.sin(xb.astype(jnp.float32)).astype(cdt)
    cx = jnp.cos(xb.astype(jnp.float32)).astype(cdt)
    pe = jnp.concatenate([x, sx, cx], axis=0)        # [63, R]

    h = jnp.maximum(_mm(w0p_t[:], pe) + b0[:], 0.0)  # [256, R]
    h = jnp.maximum(_mm(w1_t[:], h) + b1[:], 0.0)
    h = jnp.maximum(_mm(w2_t[:], h) + b2[:], 0.0)
    h = jnp.maximum(_mm(w3_t[:], h) + b3[:], 0.0)
    h = jnp.maximum(_mm(w4_t[:], h) + b4[:], 0.0)
    h = jnp.maximum(
        _mm(w5p_t[:], pe) + _mm(w5h_t[:], h) + b5[:], 0.0
    )
    h = jnp.maximum(_mm(w6_t[:], h) + b6[:], 0.0)
    h = jnp.maximum(_mm(w7_t[:], h) + b7[:], 0.0)

    sigma = _mm(w_alpha_t[:], h) + b_alpha[:]        # [8, R] (row 0)
    feat = _mm(w_feat_t[:], h) + b_feat[:]           # [256, R]

    vcon = vcon_ref[:].astype(cdt)                   # [128, R]
    hv = jnp.maximum(_mm(wvf_t[:], feat) + vcon + bv[:], 0.0)
    rgb = _mm(w_rgb_t[:], hv) + b_rgb[:]             # [8, R] (rows 0:3)
    return rgb, sigma


def _forward_q(pts3, vcon_ref, ws):
    """``fused_nerf_q._forward_q`` with ``xb = pe_args(pts3)``."""
    _mmf, _mmi, _requant = j_fq._mmf, j_fq._mmi, j_fq._requant
    (bx_t, w0p_t, A0, B0,
     w1q, A1, B1, w2q, A2, B2, w3q, A3, B3, w4q, A4, B4,
     w5p_t, w5q, A5, B5,
     w6q, A6, B6, w7q, A7, B7,
     waq, Aa, Ba, wfq, Af, Bf,
     wvq, Av, Bv,
     wrq, Ar, Br) = ws

    pdt = w0p_t.dtype
    x = pts3.astype(pdt)
    xb = pe_args(pts3)
    sx = jnp.sin(xb).astype(pdt)
    cx = jnp.cos(xb).astype(pdt)
    pe = jnp.concatenate([x, sx, cx], axis=0)          # [63, R]

    h = _requant(_mmf(w0p_t[:], pe) * A0[:] + B0[:])   # int8 [256, R]
    h = _requant(_mmi(w1q[:], h).astype(jnp.float32) * A1[:] + B1[:])
    h = _requant(_mmi(w2q[:], h).astype(jnp.float32) * A2[:] + B2[:])
    h = _requant(_mmi(w3q[:], h).astype(jnp.float32) * A3[:] + B3[:])
    h = _requant(_mmi(w4q[:], h).astype(jnp.float32) * A4[:] + B4[:])
    h = _requant(
        _mmi(w5q[:], h).astype(jnp.float32) * A5[:]
        + _mmf(w5p_t[:], pe) + B5[:]
    )
    h = _requant(_mmi(w6q[:], h).astype(jnp.float32) * A6[:] + B6[:])
    h = _requant(_mmi(w7q[:], h).astype(jnp.float32) * A7[:] + B7[:])

    sigma = _mmi(waq[:], h).astype(jnp.float32) * Aa[:] + Ba[:]  # [8, R]
    fq = _requant(_mmi(wfq[:], h).astype(jnp.float32) * Af[:] + Bf[:])
    hv = _requant(
        _mmi(wvq[:], fq).astype(jnp.float32) * Av[:]
        + vcon_ref[:].astype(jnp.float32) + Bv[:]
    )
    rgb = _mmi(wrq[:], hv).astype(jnp.float32) * Ar[:] + Br[:]   # [8, R]
    return rgb, sigma


@contextlib.contextmanager
def f32_pe():
    """The JAX kernels' chains with the f32 encoding, inside the block."""
    saved = j_fn._forward, j_fq._forward_q
    jax.clear_caches()
    j_fn._forward, j_fq._forward_q = _forward, _forward_q
    try:
        yield
    finally:
        j_fn._forward, j_fq._forward_q = saved
        jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def jax_kernels_with_f32_pe():
    with f32_pe():
        yield
