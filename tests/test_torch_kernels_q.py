"""The port's int8 NeRF module (``kernels/fused_nerf_q.py``) against the JAX
package's, on the CPU.

Here the port's wrapper takes its plain PyTorch version (the tensors lie on
the CPU) and the JAX kernel runs in interpret mode with a small
``rays_per_block``, as the JAX package's own tests run it. The CUDA kernel
itself is held against the same plain version on the card by
``chip_smoke.py``.

Tolerances.

- Calibration ranges, same numpy sweep: ``rtol 1e-5`` (f32 sums of up to 319
  terms taken in another order by XLA and PyTorch).
- Pack, with the JAX ranges carried across: the int8 and bf16 panels are
  equal code for code (the divisions and the rounding are IEEE operations on
  equal inputs); the f32 columns ``A*`` are equal, and ``B*`` within ``rtol
  1e-6`` plus ``1e-6`` of the column's largest entry, because ``w @ m_in``
  is a 256-term f32 sum that the two frameworks take in another order.
- Plain version against the JAX kernel on the same panels: everything after
  a given set of codes is exact integer arithmetic, so the two differ only
  where an f32 sum (the two K = 63 products, or sin/cos in the last bit)
  lands on the other side of a ``.5`` requantisation boundary and flips a
  code by one step, which later layers carry on (measured here: 0.1% to
  0.5% of the raw elements, by at most ``0.007 std(raw)``). Besides, XLA's
  CPU compiler may contract the heads' ``acc * A + B`` into a fused
  multiply-add, which moves an output by a unit in its last place; such
  differences (below ``1e-5 std``) are not counted. At most 2% of the raw
  elements may differ by more than that and none by more than ``0.05
  std(raw)``; both are several times tighter than the distance between the
  int8 chain and the f32 net (up to ``0.25 std``), so a wrong rounding point
  or a swapped panel cannot pass.
- Accuracy against the port's own f32 module: the JAX tests' bounds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pronerf_tpu.kernels import fused_nerf_q as j_fq
from pronerf_tpu.models import mlp as j_mlp
from pronerf_tpu.ops.encoding import positional_encoding as j_posenc
from pronerf_tpu_torch import convert
from pronerf_tpu_torch.kernels import fused_nerf as t_fn
from pronerf_tpu_torch.kernels import fused_nerf_q as t_fq
from pronerf_tpu_torch.models.pronerf import view_contribution
from pronerf_tpu_torch.ops.encoding import positional_encoding as t_posenc

# The suite runs several workers side by side; two threads a worker keep
# PyTorch's CPU kernels from crowding the other workers' tests.
torch.set_num_threads(2)

LAST_BIT, SHARE_DIFFERENT, MAX_OVER_STD = 1e-5, 0.02, 0.05


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def T(a):
    return torch.from_numpy(np.array(a))


def nets(seed=1):
    jp = j_mlp.init_nerf_mlp(jax.random.PRNGKey(seed))
    return jp, convert.nerf_from_numpy(as_numpy(jp))


def sweep(n=2048, seed=7):
    rng = np.random.default_rng(seed)
    lo = np.array([-1.25, -1.25, -0.1], np.float32)
    hi = np.array([1.25, 1.25, 1.1], np.float32)
    pts = (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return pts, dirs


def inputs(n, seed=0, S=8):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return rng.uniform(-1, 1, (S * 3, n)).astype(np.float32), dirs


def j_vcon_t(jp, dirs):
    d_pe = j_posenc(jnp.asarray(dirs), 4)
    return np.asarray(jnp.asarray(jp["views"]["w"])[256:].T @ d_pe.T)


@pytest.fixture(scope="module")
def carried():
    """One net, the JAX ranges and pack on a numpy sweep, and both carried
    across as numpy."""
    jp, net = nets()
    pts, dirs = sweep()
    j_ranges = j_fq.calibrate_nerf_ranges(jp, pts=jnp.asarray(pts),
                                          dirs=jnp.asarray(dirs))
    j_packed = j_fq.pack_nerf_params_int8(jp, ranges=j_ranges)
    return {
        "jp": jp, "net": net, "sweep": (pts, dirs),
        "j_ranges": j_ranges, "j_packed": j_packed,
        "ranges": convert.ranges_from_numpy(as_numpy(j_ranges)),
        "packed": convert.packed_q_from_numpy(as_numpy(j_packed)),
    }


# ------------------------------------------------------------ calibration --

def test_calibrate_nerf_ranges_matches_jax_on_the_same_sweep(carried):
    pts, dirs = carried["sweep"]
    got = t_fq.calibrate_nerf_ranges(carried["net"], pts=pts, dirs=dirs)
    want = carried["j_ranges"]
    assert sorted(got) == sorted(want) == sorted(
        [f"h{i}" for i in range(8)] + ["feat", "hv"])
    for name, (mn, mx) in want.items():
        width = 128 if name == "hv" else 256
        assert got[name][0].shape == got[name][1].shape == (width,)
        assert got[name][0].dtype == torch.float32
        scale = float(np.abs(np.asarray(mx)).max())
        for g, w in zip(got[name], (mn, mx)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6 * scale, err_msg=name)
    for i in range(8):  # the minimum after a ReLU is 0
        assert not got[f"h{i}"][0].any()


def test_default_sweep_is_seeded_and_covers_the_same_box():
    """The default sweep comes from a seeded torch.Generator: repeatable, and
    its ranges differ from a numpy sweep of the same box by sampling only
    (same order of magnitude per tensor)."""
    _, net = nets()
    a = t_fq.calibrate_nerf_ranges(net, n=1024)
    b = t_fq.calibrate_nerf_ranges(net, n=1024)
    c = t_fq.calibrate_nerf_ranges(
        net, n=1024, generator=torch.Generator().manual_seed(1))
    pts, dirs = sweep(1024)
    d = t_fq.calibrate_nerf_ranges(net, pts=pts, dirs=dirs)
    for name in a:
        assert torch.equal(a[name][1], b[name][1]), name
        top = float(a[name][1].max())
        assert 0.5 * top < float(d[name][1].max()) < 2.0 * top, name
    assert not torch.equal(a["h7"][1], c["h7"][1])


# ------------------------------------------------------------------- pack --

def test_pack_nerf_params_int8_matches_jax_panel_by_panel(carried):
    got = t_fq.pack_nerf_params_int8(carried["net"], ranges=carried["ranges"])
    want = carried["packed"]  # the JAX pack, carried across
    assert sorted(got) == sorted(want) == sorted(
        t_fq._ORDER + ("vcon_scale",))
    assert t_fq._ORDER == j_fq._ORDER
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and tuple(g.shape) == tuple(w.shape), name
        if g.dtype in (torch.int8, torch.bfloat16):
            assert torch.equal(g, w), (
                name, int((g.float() != w.float()).sum()))
        elif name.startswith("B"):
            np.testing.assert_allclose(
                g.numpy(), w.numpy(), rtol=1e-6,
                atol=1e-6 * float(w.abs().max()), err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
    shapes = {"w1q": (256, 256), "wfq": (256, 256), "wvq": (128, 256),
              "waq": (8, 256), "wrq": (8, 128), "A5": (256, 1),
              "Bv": (128, 1), "Ar": (8, 1), "w0p_t": (256, 63),
              "w5p_t": (256, 63), "bx_t": (30, 3), "vcon_scale": (128, 1)}
    for name, shape in shapes.items():
        assert tuple(got[name].shape) == shape, name
    for name in ("w1q", "w7q", "wfq", "wvq", "waq", "wrq"):
        assert int(got[name].min()) >= -127  # never -128
    # the padded head rows are zero panels
    assert not got["waq"][1:].any() and not got["wrq"][3:].any()


def test_pack_defaults_to_its_own_calibration():
    _, net = nets(seed=3)
    a = t_fq.pack_nerf_params_int8(net)
    b = t_fq.pack_nerf_params_int8(
        net, ranges=t_fq.calibrate_nerf_ranges(net))
    for name in a:
        assert torch.equal(a[name], b[name]), name


# ------------------------------------------------- plain version / kernel --

@pytest.mark.parametrize("n", [50, 128])  # 50: ragged against the block of 32
def test_plain_version_against_the_jax_kernel_on_the_same_panels(carried, n):
    pts24_t, dirs = inputs(n, seed=n)
    vcon = j_vcon_t(carried["jp"], dirs)
    want = np.asarray(j_fq.fused_nerf_raw_tq(
        carried["j_packed"], jnp.asarray(pts24_t), jnp.asarray(vcon),
        rays_per_block=32, interpret=True))
    before = t_fq.fused_nerf_raw_tq.launches
    got = t_fq.fused_nerf_raw_tq(carried["packed"], T(pts24_t), T(vcon))
    assert t_fq.fused_nerf_raw_tq.launches == before  # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (n, 8, 4)
    got = got.numpy()
    assert np.all(np.isfinite(got))
    diff, std = np.abs(got - want), want.std()
    share = (diff > LAST_BIT * std).mean()
    assert share <= SHARE_DIFFERENT, share
    assert diff.max() <= MAX_OVER_STD * std, (diff.max(), std)


def test_plain_version_is_the_wrapper_on_cpu_and_rays_are_independent(carried):
    pts24_t, dirs = inputs(64, seed=9)
    vcon = j_vcon_t(carried["jp"], dirs)
    whole = t_fq.fused_nerf_raw_q_plain(carried["packed"], T(pts24_t), T(vcon))
    assert torch.equal(
        whole, t_fq.fused_nerf_raw_tq(carried["packed"], T(pts24_t), T(vcon)))
    part = t_fq.fused_nerf_raw_q_plain(
        carried["packed"], T(pts24_t[:, 7:50].copy()), T(vcon[:, 7:50].copy()))
    assert torch.equal(part, whole[7:50])


def reference_f32(net, pts24_t, dirs):
    n = pts24_t.shape[1]
    pts = T(pts24_t).T.reshape(n, 8, 3)
    d_pe = t_posenc(T(dirs), 4)
    with torch.no_grad():
        return net(t_posenc(pts, 10),
                   d_pe[:, None, :].expand(-1, 8, -1)).numpy()


def port_raw(net, packed, pts24_t, dirs):
    with torch.no_grad():
        vcon = view_contribution(net, t_posenc(T(dirs), 4), torch.float32)
        return t_fq.fused_nerf_raw_tq(packed, T(pts24_t), vcon).numpy()


def test_int8_chain_tracks_the_f32_module_worst_case():
    _, net = nets(seed=1)
    pts24_t, dirs = inputs(128)
    raw = port_raw(net, t_fq.pack_nerf_params_int8(net), pts24_t, dirs)
    ref = reference_f32(net, pts24_t, dirs)
    assert np.all(np.isfinite(raw))
    err, scale = np.abs(raw - ref), np.std(ref)
    assert err.max() < 0.25 * scale + 0.02, (err.max(), scale)


def test_int8_chain_tracks_the_f32_module_on_average():
    _, net = nets(seed=1)
    pts24_t, dirs = inputs(128)
    raw = port_raw(net, t_fq.pack_nerf_params_int8(net), pts24_t, dirs)
    ref = reference_f32(net, pts24_t, dirs)
    err, scale = np.abs(raw - ref), np.std(ref)
    assert err.mean() < 0.02 * scale + 0.002, (err.mean(), scale)


def test_int8_explicit_wider_ranges_accepted():
    """Packing with caller-supplied ranges works, and wider ranges still
    track the f32 module, only more coarsely."""
    _, net = nets(seed=4)
    pts24_t, dirs = inputs(64, seed=5)
    ranges = t_fq.calibrate_nerf_ranges(net)
    wide = {k: (mn * 1.5, mx * 1.5) for k, (mn, mx) in ranges.items()}
    raw = port_raw(net, t_fq.pack_nerf_params_int8(net, ranges=wide),
                   pts24_t, dirs)
    ref = reference_f32(net, pts24_t, dirs)
    assert np.all(np.isfinite(raw))
    assert np.abs(raw - ref).max() < 0.4 * np.std(ref) + 0.04


def test_int8_chain_is_close_to_the_bf16_chain():
    """The bounds ``chip_smoke.py`` holds between the two kernels on the
    card, here between their plain versions."""
    _, net = nets(seed=1)
    pts24_t, dirs = inputs(128, seed=2)
    with torch.no_grad():
        vcon = view_contribution(net, t_posenc(T(dirs), 4), torch.bfloat16)
        q = t_fq.fused_nerf_raw_tq(
            t_fq.pack_nerf_params_int8(net), T(pts24_t), vcon).numpy()
        b = t_fn.fused_nerf_raw_t(
            t_fn.pack_nerf_params(net, torch.bfloat16), T(pts24_t),
            vcon).numpy()
    err, scale = np.abs(q - b), np.std(b)
    assert err.max() < 0.25 * scale + 0.02, (err.max(), scale)
    assert err.mean() < 0.02 * scale + 0.002, (err.mean(), scale)


def test_plain_version_refuses_tf32_products():
    _, net = nets()
    packed = t_fq.pack_nerf_params_int8(net)
    pts24_t, dirs = inputs(8)
    vcon = torch.zeros(128, 8)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            t_fq.fused_nerf_raw_q_plain(packed, T(pts24_t), vcon)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert t_fq.fused_nerf_raw_q_plain(packed, T(pts24_t), vcon).shape == (
        8, 8, 4)


# --------------------------------------------------------------- wrapper --

def test_wrapper_rejects_wrong_shapes_before_dispatch(carried):
    packed = carried["packed"]
    with pytest.raises(ValueError, match="pts24_t"):
        t_fq.fused_nerf_raw_tq(packed, torch.zeros(23, 5), torch.zeros(128, 5))
    with pytest.raises(ValueError, match="vcon_t"):
        t_fq.fused_nerf_raw_tq(packed, torch.zeros(24, 5), torch.zeros(127, 5))
    with pytest.raises(ValueError, match="pts24_t"):
        t_fq.fused_nerf_raw_tq(packed, torch.zeros(24, 5), torch.zeros(128, 5),
                               n_samples=4)


def test_blob_layout_matches_the_kernel_source(carried):
    """The byte buffer the CUDA kernel reads, section by section, against the
    sizes ``csrc/fused_nerf_q.cu`` computes (``QBlob``): the ring stages of
    one sample, the resident head slabs, the f32 columns. The stage images
    themselves are read back element by element in
    ``tests/test_torch_nerf_q_layout.py``."""
    import re

    from pronerf_tpu_torch.kernels import build

    packed = dict(carried["packed"])
    blob = t_fq._blob(packed)
    ring = sum(nbytes for _, nbytes in t_fq.stage_table())
    # all weights but the two heads, once: 2 PE panels (K padded to 64, bf16),
    # 8 square int8 panels, the view panel
    assert ring == 2 * (256 * 64 * 2) + 8 * 256 * 256 + 128 * 256
    heads = 2 * 8 * 128 + 8 * 128
    n_cols = 16 * 256 + 2 * 256 + 3 * 128 + 4 * 8
    assert blob.dtype == torch.uint8
    assert blob.numel() == ring + heads + 4 * n_cols
    assert t_fq._blob(packed) is blob  # built once

    src = (build.CSRC / "fused_nerf_q.cu").read_text()

    def const(name):
        return int(re.search(rf"{name} = (\d+)", src).group(1))

    assert const("kStagesPerSample") == len(t_fq.stage_table()) == 21
    assert re.search(r"kRingBytes = (\d+) \* 1024", src).group(1) == str(
        ring // 1024)
    assert "kAlphaBytes = 2 * 1024, kRgbBytes = 1024;" in src
    assert "c_feat = 8 * 2048, c_view = c_feat + 2048" in src
    assert "c_vscale = c_view + 1024, c_heads = c_vscale + 512" in src
    assert "kColBytes = c_heads + 128" in src
    assert 8 * 2048 + 2048 + 1024 + 512 + 128 == 4 * n_cols
    assert "__fmul_rn" in src and "__fadd_rn" in src
    assert "nerf_q_wg_kernel" in src and "mma.sync" not in src
    assert "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8" in (
        build.CSRC / "hopper.cuh").read_text()

    # the columns: pairs {A(2p), A(2p+1), B(2p), B(2p+1)} per layer
    # the columns of requantised layers and vcon_scale are stored times
    # 2^-8 (the kernel computes t / 256); the heads' as they are
    cols = blob[ring + heads:].view(torch.float32)
    a5 = packed["A5"].reshape(-1) * t_fq.T_SCALE
    b5 = packed["B5"].reshape(-1) * t_fq.T_SCALE
    layer5 = cols[5 * 512: 6 * 512].reshape(128, 4)
    assert torch.equal(layer5[:, 0], a5[0::2])
    assert torch.equal(layer5[:, 1], a5[1::2])
    assert torch.equal(layer5[:, 2], b5[0::2])
    assert torch.equal(layer5[:, 3], b5[1::2])
    at = 8 * 512 + 512 + 256
    assert torch.equal(cols[at:at + 128],
                       packed["vcon_scale"].reshape(-1) * t_fq.T_SCALE)
    assert torch.equal(cols[-8:], packed["Br"].reshape(-1))

    broken = dict(carried["packed"])
    broken.pop(t_fq._BLOB_KEY, None)
    broken["bx_t"] = broken["bx_t"] * 3.0
    with pytest.raises(ValueError, match="frequency"):
        t_fq._blob(broken)
    f32_pe = t_fq.pack_nerf_params_int8(
        carried["net"], ranges=carried["ranges"], pe_dtype=torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        t_fq._blob(f32_pe)


def test_pack_serving_params_packs_the_int8_panels_once():
    from pronerf_tpu_torch.kernels.packing import pack_serving_params
    from pronerf_tpu_torch.models.pronerf import (
        RenderStatics,
        init_pronerf_params,
    )

    params = init_pronerf_params(torch.Generator().manual_seed(0),
                                 device="cpu")
    statics = RenderStatics.infer(compute_dtype="bfloat16", use_kernels=True,
                                  quant="int8", transposed=True)
    packed = pack_serving_params(params, statics)
    assert "nerf_packed_q" in packed and "nerf_packed" not in packed
    assert {"sampler_packed", "refine_packed", "refine_packed_t"} <= set(packed)
    assert not torch.equal(packed["refine_packed"]["w0_t"],
                           packed["refine_packed_t"]["w0_t"])
    assert pack_serving_params(packed, statics) is packed
    assert "nerf_packed_q" not in params
    plain = pack_serving_params(
        params, RenderStatics.infer(compute_dtype="bfloat16",
                                    use_kernels=True))
    assert "nerf_packed" in plain and "refine_packed_t" not in plain
