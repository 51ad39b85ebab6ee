"""The port's kernel modules against the JAX package's Pallas kernels.

Here, on the CPU, the port's wrappers take their plain PyTorch versions (the
tensors lie on the CPU) and the JAX kernels run in interpret mode with a
small ``rays_per_block``, as the JAX package's own tests run them. The CUDA
kernels themselves are held against the same plain versions on the card by
``chip_smoke.py``.

Tolerances. Packed panels: equal bit for bit (f32 and bf16), except the six
folded columns of the MinMax ``w0_t``: each is a sum of 48 (or 8) f32 terms
of size ~0.06, which XLA's reduce and PyTorch's take in another order, so
they agree within a few units in the last place (``5e-7``; in bf16 within one
bf16 unit, 2^-8 relative). f32 outputs:
the JAX tests' own bounds (``2e-5`` MinMax head and composite outputs,
``3e-5`` raw, ``1e-3`` on ``disp``, which divides by depth/acc). bf16
outputs: both sides round at the same points, but XLA's CPU dot and
PyTorch's sum in another order and a sum can fall on the other side of a
bfloat16 rounding boundary (2^-8 relative), which later layers carry on:
``0.03`` on heads and raw logits (the JAX test allows 0.15 against f32),
``0.01`` on composited values.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pronerf_tpu.kernels import fused_minmax as j_fm
from pronerf_tpu.kernels import fused_nerf as j_fn
from pronerf_tpu.models import mlp as j_mlp
from pronerf_tpu.models.pronerf_t import refine_rest_row_perm
from pronerf_tpu.ops.composite import composite as j_composite
from pronerf_tpu.ops.encoding import positional_encoding as j_posenc
from pronerf_tpu_torch import convert
from pronerf_tpu_torch.kernels import fused_minmax as t_fm
from pronerf_tpu_torch.kernels import fused_nerf as t_fn
from pronerf_tpu_torch.models.pronerf import view_contribution
from pronerf_tpu_torch.ops.encoding import positional_encoding as t_posenc

# The suite runs several workers side by side; two threads a worker keep
# PyTorch's CPU kernels from crowding the other workers' tests.
torch.set_num_threads(2)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_LOGITS, BF16_COMP = 0.03, 0.01


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def T(a):
    return torch.from_numpy(np.array(a))


def bits(a):
    """A jax or torch array as numpy, bf16 widened exactly to f32."""
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(a.astype(jnp.float32))


def assert_panels_equal(got, want, folded_cols=0):
    keys = [k for k in got if not k.startswith("_")]
    assert sorted(keys) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        g, w = bits(got[k]), bits(want[k])
        if k == "w0_t" and folded_cols:
            bf16 = got[k].dtype == torch.bfloat16
            np.testing.assert_allclose(
                g[:, :folded_cols], w[:, :folded_cols],
                atol=0 if bf16 else 5e-7, rtol=2.0**-7 if bf16 else 0)
            g, w = g[:, folded_cols:], w[:, folded_cols:]
        np.testing.assert_array_equal(g, w, err_msg=k)


# ------------------------------------------------------------- MinMax ----

MINMAX_SHAPES = {"sampler": (48, 0, 27), "refine": (8, 96, 35)}


def minmax_nets(which):
    reps, rest, out_w = MINMAX_SHAPES[which]
    jp = j_mlp.init_minmax_mlp(jax.random.PRNGKey(0), 6, 256, 6 * reps + rest,
                               out_w)
    return jp, convert.minmax_from_numpy(as_numpy(jp)), reps, rest, out_w


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("which,perm", [("sampler", False), ("refine", False),
                                        ("refine", True)])
def test_pack_minmax_params_bit_equal(which, perm, dtype):
    jp, net, reps, rest, _ = minmax_nets(which)
    jdt, tdt = DTYPES[dtype]
    row_perm = refine_rest_row_perm(4, 8) if perm else None
    want = j_fm.pack_minmax_params(jp, reps, jdt, rest_row_perm=row_perm)
    got = t_fm.pack_minmax_params(net, reps, tdt, rest_row_perm=row_perm)
    assert got["w0_t"].dtype == tdt
    assert_panels_equal(got, want, folded_cols=6)
    if perm:
        plain = t_fm.pack_minmax_params(net, reps, tdt)
        assert not torch.equal(got["w0_t"], plain["w0_t"])


@pytest.mark.parametrize("n", [64, 70])  # 70: ragged against the block of 32
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("which,perm", [("sampler", False), ("refine", False),
                                        ("refine", True)])
def test_fused_minmax_against_jax_kernel(which, perm, dtype, n):
    jp, net, reps, rest, out_w = minmax_nets(which)
    jdt, tdt = DTYPES[dtype]
    row_perm = refine_rest_row_perm(4, 8) if perm else None
    rng = np.random.default_rng(1)
    x_t = np.concatenate([rng.normal(size=(6, n)), rng.random((rest, n))]
                         ).astype(np.float32)
    want = j_fm.fused_minmax_t(
        j_fm.pack_minmax_params(jp, reps, jdt, rest_row_perm=row_perm),
        jnp.asarray(x_t), rays_per_block=32, interpret=True)
    packed = t_fm.pack_minmax_params(net, reps, tdt, rest_row_perm=row_perm)
    before = t_fm.fused_minmax_t.launches
    by_width = dict(t_fm.fused_minmax_t.launches_by_width)
    got = t_fm.fused_minmax_t(packed, T(x_t))
    assert t_fm.fused_minmax_t.launches == before  # CPU: the plain version
    assert t_fm.fused_minmax_t.launches_by_width == by_width
    assert got.dtype == torch.float32 and got.shape == (n, -(-out_w // 8) * 8)
    atol = 2e-5 if dtype == "f32" else BF16_LOGITS
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
    # pad columns are exact zero-weight products
    assert np.all(got.numpy()[:, out_w:] == 0)
    got_t = t_fm.fused_minmax_t(packed, T(x_t), transpose_out=False)
    np.testing.assert_array_equal(got_t.numpy(), got.numpy().T)


def test_fused_minmax_f32_equals_the_folded_module():
    """The plain version with the permuted refine rows equals the folded
    forward on the un-permuted features (what the permutation is for)."""
    from pronerf_tpu_torch.models.mlp import minmax_mlp_apply_folded

    _, net, reps, rest, out_w = minmax_nets("refine")
    rng = np.random.default_rng(2)
    sig = rng.normal(size=(40, 6)).astype(np.float32)
    epi = rng.random((40, rest)).astype(np.float32)
    perm = refine_rest_row_perm(4, 8)
    packed = t_fm.pack_minmax_params(net, reps, torch.float32,
                                     rest_row_perm=perm)
    x_t = np.concatenate([sig.T, epi[:, perm].T])
    with torch.no_grad():
        want = minmax_mlp_apply_folded(net, T(sig), reps, T(epi), torch.float32)
    got = t_fm.fused_minmax_t(packed, T(x_t))[:, :out_w]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


# --------------------------------------------------------------- NeRF ----

def nerf_nets(seed=1):
    jp = j_mlp.init_nerf_mlp(jax.random.PRNGKey(seed))
    return jp, convert.nerf_from_numpy(as_numpy(jp))


def nerf_inputs(n, seed=0, S=8):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return {
        "pts24_t": rng.uniform(-1, 1, (S * 3, n)).astype(np.float32),
        "dirs": dirs,
        "z": np.sort(rng.random((n, S)).astype(np.float32), axis=-1),
        "mm_add": rng.normal(size=(n, S)).astype(np.float32),
        "mm_mul": (rng.normal(size=(n, S)) + 0.5).astype(np.float32),
        "rays_d": (dirs * 1.3).astype(np.float32),
    }


def j_vcon_t(jp, dirs, jdt):
    d_pe = j_posenc(jnp.asarray(dirs), 4)
    wv = jnp.asarray(jp["views"]["w"])[256:]
    return jax.lax.dot_general(
        wv.astype(jdt), d_pe.astype(jdt),
        dimension_numbers=(((0,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pack_nerf_params_bit_equal(dtype):
    jp, net = nerf_nets()
    jdt, tdt = DTYPES[dtype]
    got = t_fn.pack_nerf_params(net, tdt)
    assert_panels_equal(got, j_fn.pack_nerf_params(jp, jdt))
    assert set(t_fn._WEIGHT_ORDER) == set(j_fn._WEIGHT_ORDER) == {
        k for k in got if not k.startswith("_")}
    np.testing.assert_array_equal(
        t_fn._freq_matrix(10).numpy(), np.asarray(j_fn._freq_matrix(10)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_view_contribution_matches_jax(dtype):
    jp, net = nerf_nets()
    jdt, tdt = DTYPES[dtype]
    dirs = nerf_inputs(33)["dirs"]
    got = view_contribution(net, t_posenc(T(dirs), 4), tdt)
    assert got.dtype == torch.float32 and got.shape == (128, 33)
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(j_vcon_t(jp, dirs, jdt)), atol=2e-6)


@pytest.mark.parametrize("n", [64, 50])  # 50: ragged against the block of 32
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_nerf_raw_against_jax_kernel(dtype, n):
    jp, net = nerf_nets()
    jdt, tdt = DTYPES[dtype]
    inp = nerf_inputs(n)
    vcon = np.asarray(j_vcon_t(jp, inp["dirs"], jdt))
    want = j_fn.fused_nerf_raw_t(
        j_fn.pack_nerf_params(jp, jdt), jnp.asarray(inp["pts24_t"]),
        jnp.asarray(vcon), rays_per_block=32, interpret=True)
    before = t_fn.fused_nerf_raw_t.launches
    got = t_fn.fused_nerf_raw_t(
        t_fn.pack_nerf_params(net, tdt), T(inp["pts24_t"]), T(vcon))
    assert t_fn.fused_nerf_raw_t.launches == before
    assert got.dtype == torch.float32 and got.shape == (n, 8, 4)
    atol = 3e-5 if dtype == "f32" else BF16_LOGITS
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


def test_fused_nerf_raw_f32_equals_the_module():
    """Kernel contract (transposed points, per-ray vcon) against the plain
    module on the same points: the JAX test's own bound, 3e-5."""
    _, net = nerf_nets()
    inp = nerf_inputs(48, seed=3)
    pts = inp["pts24_t"].T.reshape(48, 8, 3)
    d_pe = t_posenc(T(inp["dirs"]), 4)
    with torch.no_grad():
        want = net(t_posenc(T(pts), 10), d_pe[:, None, :].expand(-1, 8, -1))
        got = t_fn.fused_nerf_raw_t(
            t_fn.pack_nerf_params(net, torch.float32), T(inp["pts24_t"]),
            view_contribution(net, d_pe, torch.float32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5)


@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("n", [64, 50])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_nerf_composite_against_jax_kernel(dtype, n, white_bkgd):
    jp, net = nerf_nets(seed=4)
    jdt, tdt = DTYPES[dtype]
    inp = nerf_inputs(n, seed=5)
    vcon = np.asarray(j_vcon_t(jp, inp["dirs"], jdt))
    dnorm = np.linalg.norm(inp["rays_d"], axis=-1)[None, :].astype(np.float32)
    aux = [np.ascontiguousarray(inp[k].T) for k in ("z", "mm_add", "mm_mul")]
    want = j_fn.fused_nerf_composite_t(
        j_fn.pack_nerf_params(jp, jdt), jnp.asarray(inp["pts24_t"]),
        jnp.asarray(vcon), *(jnp.asarray(a) for a in aux), jnp.asarray(dnorm),
        white_bkgd=white_bkgd, rays_per_block=32, interpret=True)
    before = t_fn.fused_nerf_composite_t.launches
    got = t_fn.fused_nerf_composite_t(
        t_fn.pack_nerf_params(net, tdt), T(inp["pts24_t"]), T(vcon),
        *(T(a) for a in aux), T(dnorm), white_bkgd=white_bkgd)
    assert t_fn.fused_nerf_composite_t.launches == before
    assert set(got) == set(want)
    f32 = dtype == "f32"
    for k in ("rgb", "depth", "acc", "weights"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(want[k]),
            atol=2e-5 if f32 else BF16_COMP, err_msg=k)
    np.testing.assert_allclose(got["sigma"].numpy(), np.asarray(want["sigma"]),
                               atol=2e-5 if f32 else BF16_LOGITS)
    # disp = 1 / (depth / acc): absolute 1e-3 in f32 as in the JAX test;
    # in bf16 relative to its size, which follows acc down to ~1e-3
    if f32:
        np.testing.assert_allclose(got["disp"].numpy(),
                                   np.asarray(want["disp"]), atol=1e-3)
    else:
        np.testing.assert_allclose(got["disp"].numpy(),
                                   np.asarray(want["disp"]), rtol=0.05)


def test_fused_nerf_composite_f32_equals_raw_plus_composite_op():
    """The streaming composite equals the raw kernel followed by
    ``ops.composite`` (the A/B of ``fuse_composite``), the JAX test's
    bounds."""
    from pronerf_tpu_torch.ops.composite import composite

    _, net = nerf_nets(seed=4)
    inp = nerf_inputs(40, seed=6)
    packed = t_fn.pack_nerf_params(net, torch.float32)
    with torch.no_grad():
        vcon = view_contribution(net, t_posenc(T(inp["dirs"]), 4), torch.float32)
        raw = t_fn.fused_nerf_raw_t(packed, T(inp["pts24_t"]), vcon)
        want = composite(raw, T(inp["z"]), T(inp["rays_d"]),
                         mm_add=T(inp["mm_add"]), mm_mul=T(inp["mm_mul"]))
        got = t_fn.fused_nerf_composite_t(
            packed, T(inp["pts24_t"]), vcon, T(inp["z"].T.copy()),
            T(inp["mm_add"].T.copy()), T(inp["mm_mul"].T.copy()),
            torch.linalg.norm(T(inp["rays_d"]), dim=-1)[None, :])
    for k, atol in (("rgb", 2e-5), ("depth", 2e-5), ("acc", 2e-5),
                    ("weights", 2e-5), ("disp", 1e-3)):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol,
                                   err_msg=k)
    np.testing.assert_allclose(got["sigma"].numpy(), raw[..., 3].numpy(),
                               atol=2e-5)


# ----------------------------------------------------------- wrappers ----

def test_wrappers_reject_wrong_shapes_before_dispatch():
    _, net = nerf_nets()
    packed = t_fn.pack_nerf_params(net, torch.float32)
    with pytest.raises(ValueError, match="pts24_t"):
        t_fn.fused_nerf_raw_t(packed, torch.zeros(23, 5), torch.zeros(128, 5))
    with pytest.raises(ValueError, match="vcon_t"):
        t_fn.fused_nerf_raw_t(packed, torch.zeros(24, 5), torch.zeros(127, 5))


def test_blob_layout_matches_the_kernel_sources():
    """The contiguous weight buffers the CUDA kernels read: sizes as the
    ``.cu`` files compute them. bf16 NeRF: the stage images of the ring, the
    head slabs, the biases (``tests/test_torch_kernels_layout.py`` reads every
    element back); f32 NeRF: panels in order, PE panels padded to K = 64 with
    a zero column; MinMax: first layer padded to a multiple of 32."""
    _, net = nerf_nets()
    sq, W = 256 * 256, 256
    weights = 2 * (W * 64) + 7 * sq + sq + 128 * W + 8 * W + 8 * 128
    biases = 8 * W + 8 + W + 128 + 8
    packed = t_fn.pack_nerf_params(net, torch.bfloat16)
    blob = t_fn._blob(packed)
    assert blob.dtype == torch.bfloat16 and blob.numel() == weights + biases
    assert t_fn._blob(packed) is blob  # built once
    # stage 0 is w0p [256, 64]: row r, chunk c stored at chunk c ^ (r % 8)
    w0p = blob[: W * 64].reshape(W, 8, 8)
    r = torch.arange(W)[:, None]
    w0p = w0p[r, torch.arange(8)[None, :] ^ (r % 8)].reshape(W, 64)
    assert torch.equal(w0p[:, :63], packed["w0p_t"]) and not w0p[:, 63].any()
    assert torch.equal(blob[-8:], packed["b_rgb"].reshape(-1))

    packed32 = t_fn.pack_nerf_params(net, torch.float32)
    blob32 = t_fn._blob(packed32)
    assert blob32.dtype == torch.float32
    assert blob32.numel() == weights + biases
    w0p = blob32[: W * 64].reshape(W, 64)
    assert torch.equal(w0p[:, :63], packed32["w0p_t"]) and not w0p[:, 63].any()
    broken = dict(t_fn.pack_nerf_params(net, torch.float32))
    broken["bx_t"] = broken["bx_t"] * 3.0
    with pytest.raises(ValueError, match="frequency"):
        t_fn._blob(broken)

    _, mm, reps, _, _ = minmax_nets("refine")
    pm = t_fm.pack_minmax_params(mm, reps, torch.float32)
    bm = t_fm._blob(pm)
    assert bm.numel() == W * 128 + W + 5 * (sq + W) + 40 * W + 40
    first = bm[: W * 128].reshape(W, 128)
    assert torch.equal(first[:, :102], pm["w0_t"]) and not first[:, 102:].any()


def test_modules_import_and_build_nothing_without_a_compiler():
    """Importing the kernel modules needs no nvcc, triton or card; the build
    is reached only by a launch, and without nvcc it says so."""
    import shutil
    import sys

    from pronerf_tpu_torch.kernels import build

    assert "triton" not in sys.modules
    assert build.sources() == ["fused_minmax", "fused_nerf", "fused_nerf_q"]
    assert build.lib_path("fused_nerf").parent.name == "_build"
    if shutil.which("nvcc") is None and not (
            build.Path("/usr/local/cuda/bin/nvcc").exists()):
        with pytest.raises(RuntimeError, match="nvcc"):
            build._nvcc()
