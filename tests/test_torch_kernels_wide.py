"""The kernel modules at the shapes past the CUDA kernels' former limits,
against the JAX package's Pallas kernels, on the CPU: the NeRF kernels at
S = 128 samples a ray (raw, composite, int8) and the MinMax kernel at C = 198
(the refine net of 16 samples and 4 views), C = 390 (16 samples, 8 views),
C = 54 (8 samples, 2 views: the ``num_neighbor = 2`` serving point)
and C = 1542 (128 samples, 4 views; its head of 515 -> 520 rows runs on the
card in parts, one launch each) input rows.

Here the port's wrappers take their plain PyTorch versions (the tensors lie
on the CPU) and the JAX kernels run in interpret mode with a small
``rays_per_block``, as the JAX package's own tests run them, with their
positional encoding taken from the f32 points as the port's
(``torch_jax_pe``). The CUDA kernels are held against the same plain versions at these shapes on the
card by ``chip_smoke.py`` (its kernel rows ``[S=128]``, ``[C=198]``,
``[C=54]`` and ``[C=1542]``, its frames of 16 and 128 samples a ray, and
its 1008x756 frame of 2 neighbours).

Tolerances: those of ``test_torch_kernels.py`` and
``test_torch_kernels_q.py`` for the same comparison at the shipped shapes
(f32: ``2e-5`` MinMax head, ``3e-5`` raw, ``2e-5`` composite outputs,
``1e-3`` disp; bf16: ``0.03`` heads and raw logits, ``0.01`` composited
values, disp relative ``0.05``; int8: the share of differing elements and
the largest difference over std). A sample or an input row more changes the
length of the chains, not the rounding points.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pronerf_tpu.kernels import fused_minmax as j_fm
from pronerf_tpu.kernels import fused_nerf as j_fn
from pronerf_tpu.kernels import fused_nerf_q as j_fq
from pronerf_tpu.models import mlp as j_mlp
from pronerf_tpu.ops.encoding import positional_encoding as j_posenc
from pronerf_tpu_torch import convert
from pronerf_tpu_torch.kernels import fused_minmax as t_fm
from pronerf_tpu_torch.kernels import fused_nerf as t_fn
from pronerf_tpu_torch.kernels import fused_nerf_q as t_fq
from torch_jax_pe import jax_kernels_with_f32_pe  # noqa: F401 (autouse: f32 PE)

torch.set_num_threads(2)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_LOGITS, BF16_COMP = 0.03, 0.01
LAST_BIT, SHARE_DIFFERENT, MAX_OVER_STD = 1e-5, 0.02, 0.05
S_WIDE = 128


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def T(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------- MinMax ----

# views -> (samples a ray, input rows C, padded head): the refine nets of 16
# samples and 4 or 8 views, and the headline bench's num_neighbor = 2 point
# at 8 samples (C = 54: one layer-0 pass of 64 k-rows, half of its second
# k-slab zero padding)
WIDE_REFINE = {4: (16, 198, 72), 8: (16, 390, 72), 2: (8, 54, 40)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("views", [4, 8, 2])
def test_fused_minmax_wide_refine_against_jax_kernel(views, dtype):
    S, C, out_pad = WIDE_REFINE[views]
    rest, out_w = 3 * views * S, 4 * S + 3
    jp = j_mlp.init_minmax_mlp(jax.random.PRNGKey(3), 6, 256, 6 * S + rest,
                               out_w)
    net = convert.minmax_from_numpy(as_numpy(jp))
    jdt, tdt = DTYPES[dtype]
    n = 40
    rng = np.random.default_rng(views)
    x_t = np.concatenate([rng.normal(size=(6, n)), rng.random((rest, n))]
                         ).astype(np.float32)
    assert x_t.shape[0] == C
    want = j_fm.fused_minmax_t(j_fm.pack_minmax_params(jp, S, jdt),
                               jnp.asarray(x_t), rays_per_block=32,
                               interpret=True)
    packed = t_fm.pack_minmax_params(net, S, tdt)
    before = t_fm.fused_minmax_t.launches
    got = t_fm.fused_minmax_t(packed, T(x_t))
    assert t_fm.fused_minmax_t.launches == before  # CPU: the plain version
    assert got.shape == (n, out_pad)
    atol = 2e-5 if dtype == "f32" else BF16_LOGITS
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
    assert np.all(got.numpy()[:, out_w:] == 0)
    # the bf16 blob holds every stage of the passes
    if dtype == "bf16":
        n0 = -(-(-(-x_t.shape[0] // 16) * 16) // 64)
        layer0 = t_fm.ring_stages(packed)[: 2 * -(-n0 // t_fm.PASS_SLABS)]
        assert [len(st) for st in layer0] == 2 * (
            [t_fm.PASS_SLABS] * (n0 // t_fm.PASS_SLABS)
            + [n0 % t_fm.PASS_SLABS] * (n0 % t_fm.PASS_SLABS > 0))
        t_fm._blob(packed)


def test_fused_minmax_refine_of_128_samples_against_jax_kernel():
    S, views = 128, 4
    rest, out_w = 3 * views * S, 4 * S + 3
    jp = j_mlp.init_minmax_mlp(jax.random.PRNGKey(4), 6, 256, 6 * S + rest,
                               out_w)
    net = convert.minmax_from_numpy(as_numpy(jp))
    n = 40
    rng = np.random.default_rng(128)
    x_t = np.concatenate([rng.normal(size=(6, n)), rng.random((rest, n))]
                         ).astype(np.float32)
    assert x_t.shape[0] == 1542
    want = j_fm.fused_minmax_t(j_fm.pack_minmax_params(jp, S, jnp.bfloat16),
                               jnp.asarray(x_t), rays_per_block=32,
                               interpret=True)
    packed = t_fm.pack_minmax_params(net, S, torch.bfloat16)
    got = t_fm.fused_minmax_t(packed, T(x_t))
    assert got.shape == (n, 520)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=BF16_LOGITS)
    assert np.all(got.numpy()[:, out_w:] == 0)
    # on the card this head runs in five parts of 104 rows; each part's pack
    # computes its rows of the same function
    parts = t_fm._parts(packed, 1542)
    assert [(c0, c1) for c0, c1, _ in parts] == [
        (c, c + 104) for c in range(0, 520, 104)]
    for c0, c1, part in parts:
        np.testing.assert_array_equal(
            t_fm.fused_minmax_plain(part, T(x_t)).numpy(),
            got.numpy()[:, c0:c1])


@pytest.mark.parametrize("C, out_pad, n_parts", [
    (6, 32, 1), (102, 40, 1), (198, 72, 1), (390, 72, 1), (102, 120, 1),
    (102, 128, 2), (1542, 520, 5), (6 + 3 * 4 * 256, 4 * 256 + 8, 9)])
def test_head_parts_fit_the_kernels_shared_memory(C, out_pad, n_parts):
    parts = t_fm.head_parts(C, 6, out_pad)
    assert len(parts) == n_parts
    assert parts[0][0] == 0 and parts[-1][1] == out_pad
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    for c0, c1 in parts:
        assert (c1 - c0) % 8 == 0 and t_fm._wg_fits(C, 6, c1 - c0)
    if n_parts > 1:  # the fewest parts: one less would not fit
        size = -(-out_pad // (n_parts - 1))
        assert not t_fm._wg_fits(C, 6, -(-size // 8) * 8)
    # the mirror's terms are those of MmSmem in the CUDA source
    src = (Path(t_fm.__file__).parent / "csrc" / "fused_minmax.cu").read_text()
    for term in ("kLimit = 232448 - 1024;",
                 "head = a + 2 * (b.n0 < kMaxK0Slabs ? b.n0 : kMaxK0Slabs) * "
                 "kASlabBytes;",
                 "ring = head + b.head_bytes();",
                 "res_bytes = kWgTile * b.out_pad * 2;",
                 "const int rest = ((b.n_biases() * 2 + 15) & ~15) + "
                 "2 * res_bytes + 256;",
                 "MmSmem(b).stages >= 2;"):
        assert term in src, term


# --------------------------------------------------------------- NeRF ----

def nerf_inputs(n, seed):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return {
        "pts24_t": rng.uniform(-1, 1, (S_WIDE * 3, n)).astype(np.float32),
        "dirs": dirs,
        # sorted, spread so that the rays stay translucent to the end
        "z": np.sort(rng.random((n, S_WIDE)).astype(np.float32), axis=-1),
        "mm_add": (rng.normal(size=(n, S_WIDE)) - 2.0).astype(np.float32),
        "mm_mul": (rng.normal(size=(n, S_WIDE)) * 0.2 + 0.1).astype(
            np.float32),
        "rays_d": (dirs * 1.3).astype(np.float32),
    }


def j_vcon_t(jp, dirs, jdt):
    d_pe = j_posenc(jnp.asarray(dirs), 4)
    wv = jnp.asarray(jp["views"]["w"])[256:]
    return jax.lax.dot_general(
        wv.astype(jdt), d_pe.astype(jdt),
        dimension_numbers=(((0,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)


@pytest.fixture(scope="module")
def nerf():
    jp = j_mlp.init_nerf_mlp(jax.random.PRNGKey(5))
    return jp, convert.nerf_from_numpy(as_numpy(jp))


def test_fused_nerf_raw_at_128_samples_against_jax_kernel(nerf):
    jp, net = nerf
    inp = nerf_inputs(32, seed=11)
    vcon = np.asarray(j_vcon_t(jp, inp["dirs"], jnp.bfloat16))
    want = j_fn.fused_nerf_raw_t(
        j_fn.pack_nerf_params(jp, jnp.bfloat16), jnp.asarray(inp["pts24_t"]),
        jnp.asarray(vcon), n_samples=S_WIDE, rays_per_block=32,
        interpret=True)
    got = t_fn.fused_nerf_raw_t(
        t_fn.pack_nerf_params(net, torch.bfloat16), T(inp["pts24_t"]),
        T(vcon), S_WIDE)
    assert got.shape == (32, S_WIDE, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=BF16_LOGITS)


def test_fused_nerf_composite_at_128_samples_against_jax_kernel(nerf):
    jp, net = nerf
    inp = nerf_inputs(32, seed=12)
    vcon = np.asarray(j_vcon_t(jp, inp["dirs"], jnp.bfloat16))
    dnorm = np.linalg.norm(inp["rays_d"], axis=-1)[None, :].astype(np.float32)
    aux = [np.ascontiguousarray(inp[k].T) for k in ("z", "mm_add", "mm_mul")]
    want = j_fn.fused_nerf_composite_t(
        j_fn.pack_nerf_params(jp, jnp.bfloat16), jnp.asarray(inp["pts24_t"]),
        jnp.asarray(vcon), *(jnp.asarray(a) for a in aux), jnp.asarray(dnorm),
        n_samples=S_WIDE, rays_per_block=32, interpret=True)
    got = t_fn.fused_nerf_composite_t(
        t_fn.pack_nerf_params(net, torch.bfloat16), T(inp["pts24_t"]),
        T(vcon), *(T(a) for a in aux), T(dnorm), S_WIDE)
    # the transmittance has not run out by the last chunk of samples, so
    # every chunk counts
    assert float(got["weights"][:, -8:].sum()) > 0
    for k in ("rgb", "depth", "acc", "weights"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=BF16_COMP, err_msg=k)
    np.testing.assert_allclose(got["sigma"].numpy(), np.asarray(want["sigma"]),
                               atol=BF16_LOGITS)
    np.testing.assert_allclose(got["disp"].numpy(), np.asarray(want["disp"]),
                               rtol=0.05)


def test_fused_nerf_raw_int8_at_128_samples_against_jax_kernel(nerf):
    jp, net = nerf
    rng = np.random.default_rng(7)
    lo = np.array([-1.25, -1.25, -0.1], np.float32)
    hi = np.array([1.25, 1.25, 1.1], np.float32)
    pts = (lo + (hi - lo) * rng.random((1024, 3))).astype(np.float32)
    dirs = rng.normal(size=(1024, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    j_packed = j_fq.pack_nerf_params_int8(jp, ranges=j_fq.calibrate_nerf_ranges(
        jp, pts=jnp.asarray(pts), dirs=jnp.asarray(dirs)))
    packed = convert.packed_q_from_numpy(as_numpy(j_packed))
    inp = nerf_inputs(32, seed=13)
    vcon = np.asarray(j_posenc(jnp.asarray(inp["dirs"]), 4)
                      @ jnp.asarray(jp["views"]["w"])[256:]).T
    vcon = np.ascontiguousarray(vcon)
    want = np.asarray(j_fq.fused_nerf_raw_tq(
        j_packed, jnp.asarray(inp["pts24_t"]), jnp.asarray(vcon),
        n_samples=S_WIDE, rays_per_block=32, interpret=True))
    got = t_fq.fused_nerf_raw_tq(packed, T(inp["pts24_t"]), T(vcon), S_WIDE)
    assert got.shape == (32, S_WIDE, 4)
    got = got.numpy()
    diff, std = np.abs(got - want), want.std()
    assert (diff > LAST_BIT * std).mean() <= SHARE_DIFFERENT
    assert diff.max() <= MAX_OVER_STD * std, (diff.max(), std)
