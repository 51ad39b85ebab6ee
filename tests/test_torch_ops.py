"""The port's plain ops (``pronerf_tpu_torch.ops``) against the JAX package's,
on the CPU in f32: the same numpy inputs go through both.

Tolerance: ``atol 1e-5`` throughout. Both sides do the same f32 arithmetic;
they differ in the order of small sums and in the last bit of sin/cos/exp,
which stays orders of magnitude below it. Integer results (the u8 corner
words, sort permutations) are compared for equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pronerf_tpu.ops import encoding as j_enc
from pronerf_tpu.ops import metrics as j_metrics
from pronerf_tpu.ops import rays as j_rays
from pronerf_tpu.ops import sampling as j_samp
from pronerf_tpu.ops import warp as j_warp
from pronerf_tpu.ops.composite import composite as j_composite
from pronerf_tpu.utils.synthetic import make_scene
from pronerf_tpu_torch.ops import encoding as t_enc
from pronerf_tpu_torch.ops import metrics as t_metrics
from pronerf_tpu_torch.ops import rays as t_rays
from pronerf_tpu_torch.ops import sampling as t_samp
from pronerf_tpu_torch.ops import warp as t_warp
from pronerf_tpu_torch.ops.composite import composite as t_composite

# The suite runs several workers side by side; two threads a worker keep
# PyTorch's CPU kernels from crowding the other workers' tests.
torch.set_num_threads(2)

ATOL = 1e-5


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol=ATOL, **kw):
    np.testing.assert_allclose(
        got.detach().numpy() if torch.is_tensor(got) else np.asarray(got),
        np.asarray(want), atol=atol, rtol=0, **kw)


@pytest.mark.parametrize("L", [0, 4, 10])
def test_positional_encoding(L):
    x = np.random.default_rng(0).uniform(-1, 1, (7, 5, 3)).astype(np.float32)
    got = t_enc.positional_encoding(T(x), L)
    assert got.shape[-1] == t_enc.posenc_dim(3, L) == j_enc.posenc_dim(3, L)
    # sin(2^9 x): an ulp of the argument's product is ~3e-5 in the sine
    close(got, j_enc.positional_encoding(jnp.asarray(x), L), atol=1e-4)


def test_plucker_and_its_invariance_along_the_ray():
    rng = np.random.default_rng(1)
    p = rng.normal(size=(9, 4, 3)).astype(np.float32)
    d = rng.normal(size=(9, 1, 3)).astype(np.float32)
    close(t_enc.plucker(T(p), T(d)), j_enc.plucker(jnp.asarray(p), jnp.asarray(d)))
    o, dd = T(p[:, 0]), T(d[:, 0])
    close(t_enc.plucker(o + 0.7 * dd, dd), t_enc.plucker(o, dd).numpy())


def test_get_rays_and_ndc_rays():
    sc = make_scene(n_views=3, H=12, W=16, seed=2)
    H, W, focal = sc["hwf"]
    ro, rd = t_rays.get_rays(H, W, sc["K"], sc["poses"][1], device="cpu")
    jro, jrd = j_rays.get_rays(H, W, sc["K"], sc["poses"][1])
    close(ro, jro)
    close(rd, jrd)
    no, nd = t_rays.ndc_rays(H, W, focal, 1.0, ro, rd)
    jno, jnd = j_rays.ndc_rays(H, W, focal, 1.0, jro, jrd)
    close(no, jno)
    close(nd, jnd)
    nro, nrd = t_rays.get_rays_np(H, W, sc["K"], sc["poses"][1])
    close(ro, nro)
    close(rd, nrd)


def test_ray_points_and_linspace_depths():
    rng = np.random.default_rng(3)
    o, d = (rng.normal(size=(6, 3)).astype(np.float32) for _ in range(2))
    z = rng.random((6, 8)).astype(np.float32)
    close(t_rays.ray_points(T(o), T(d), T(z)),
          j_rays.ray_points(jnp.asarray(o), jnp.asarray(d), jnp.asarray(z)))
    close(t_rays.linspace_depths(0.0, 1.0, 48), j_rays.linspace_depths(0.0, 1.0, 48))


def test_sort_with_payloads_is_stable_on_ties():
    """Two equal keys in a row keep their order, and their payloads with
    them, as the JAX package's single-key ``lax.sort`` does."""
    rng = np.random.default_rng(4)
    keys = rng.random((50, 8)).astype(np.float32)
    keys[:, 5] = keys[:, 2]          # a tie in every row
    keys[::3, 7] = keys[::3, 0]      # and a second one in some
    a = rng.normal(size=(50, 8)).astype(np.float32)
    b = np.tile(np.arange(8, dtype=np.float32), (50, 1))  # original slot
    got = t_samp.sort_with_payloads(T(keys), T(a), T(b))
    want = j_samp.sort_with_payloads(*(jnp.asarray(x) for x in (keys, a, b)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    slot = got[2].numpy()
    tied = np.diff(got[0].numpy(), axis=-1) == 0
    assert tied.any() and np.all(np.diff(slot, axis=-1)[tied] > 0)


def test_ndc_to_3d_depth_and_bin_constrain():
    rng = np.random.default_rng(5)
    z = np.sort(rng.random((20, 8)).astype(np.float32) * 0.98, axis=-1)
    sig = rng.random((20, 8)).astype(np.float32)
    close(t_samp.ndc_to_3d_depth(T(z), 1e-5),
          j_samp.ndc_to_3d_depth(jnp.asarray(z), 1e-5), atol=1e-4)
    got = t_samp.bin_constrain(T(z), T(sig), 0.0, 1.0)
    close(got, j_samp.bin_constrain(jnp.asarray(z), jnp.asarray(sig), 0.0, 1.0))
    assert np.all(np.diff(got.numpy(), axis=-1) >= 0)


@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("num_valid", [None, 5])
@pytest.mark.parametrize("clamp_raw", [False, True])
@pytest.mark.parametrize("mm", [False, True])
def test_composite(mm, clamp_raw, num_valid, white_bkgd):
    rng = np.random.default_rng(6)
    raw = (rng.normal(size=(30, 8, 4)) * 6).astype(np.float32)
    z = np.sort(rng.random((30, 8)).astype(np.float32), axis=-1)
    d = rng.normal(size=(30, 3)).astype(np.float32)
    noise = rng.normal(size=(30, 8)).astype(np.float32)
    mm_add = rng.normal(size=(30, 8)).astype(np.float32) if mm else None
    mm_mul = (rng.normal(size=(30, 8)) + 0.5).astype(np.float32) if mm else None

    def opt(x, conv):
        return None if x is None else conv(x)

    got = t_composite(
        T(raw), T(z), T(d), noise=T(noise), mm_add=opt(mm_add, T),
        mm_mul=opt(mm_mul, T), clamp_raw=clamp_raw, num_valid=num_valid,
        white_bkgd=white_bkgd)
    want = j_composite(
        jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d),
        noise=jnp.asarray(noise), mm_add=opt(mm_add, jnp.asarray),
        mm_mul=opt(mm_mul, jnp.asarray), clamp_raw=clamp_raw,
        num_valid=None if num_valid is None else jnp.int32(num_valid),
        white_bkgd=white_bkgd)
    assert set(got) == set(want)
    for k in ("rgb", "depth", "acc", "weights"):
        close(got[k], want[k], err_msg=k)
    # disp = 1 / (depth / acc) magnifies the last bits where acc is small
    np.testing.assert_allclose(got["disp"].numpy(), np.asarray(want["disp"]),
                               rtol=1e-3, atol=1e-5)


def test_fuse_projection_and_project_points():
    sc = make_scene(n_views=4, H=12, W=16, seed=7)
    M = t_warp.fuse_projection(T(sc["poses"]))
    close(M, j_warp.fuse_projection(sc["poses"]))
    pts = np.random.default_rng(7).normal(size=(10, 8, 3)).astype(np.float32)
    pts[..., 2] -= 4.0
    xn, yn = t_warp.project_points(T(pts), M[2], T(sc["K"]), 12, 16)
    jxn, jyn = j_warp.project_points(
        jnp.asarray(pts), j_warp.fuse_projection(sc["poses"])[2],
        jnp.asarray(sc["K"]), 12, 16)
    close(xn, jxn)
    close(yn, jyn)


def test_build_corner_stack_u8_bit_equal_with_high_top_lane():
    """Words whose top byte (corner 3) is 128 or more are negative as int32;
    the port builds them without uint32 and must hold the same bits."""
    rng = np.random.default_rng(8)
    img = rng.random((2, 6, 7, 3)).astype(np.float32)
    img[0, 2:5, 2:6] = 1.0      # corner bytes of 255 in every lane
    img[1, :, :, 1] = 0.75      # 191 in the top lane of word 1
    got = t_warp.build_corner_stack_u8(T(img))
    want = np.asarray(j_warp.build_corner_stack_u8(jnp.asarray(img)))
    assert got.dtype == torch.int32 and (want < 0).any()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        t_warp.build_corner_stack(T(img)).numpy(),
        np.asarray(j_warp.build_corner_stack(jnp.asarray(img))))


@pytest.mark.parametrize("pack", ["u8", "f32", "plain"])
def test_bilinear_samplers(pack):
    """Same coordinates into both packages' samplers, with points out of
    bounds and on the border, and (u8) negative words."""
    rng = np.random.default_rng(9)
    img = rng.random((3, 9, 11, 3)).astype(np.float32)
    img[1] = np.maximum(img[1], 0.6)
    xn = rng.uniform(-1.2, 1.2, (40, 8)).astype(np.float32)
    yn = rng.uniform(-1.2, 1.2, (40, 8)).astype(np.float32)
    xn[0, :4] = [-1.0, 1.0, 0.0, 1.0]
    yn[0, :4] = [-1.0, 1.0, 1.0, -1.0]
    vid = rng.integers(0, 3, (40, 8)).astype(np.int32)
    if pack == "u8":
        got = t_warp.bilinear_sample_packed_u8(
            t_warp.build_corner_stack_u8(T(img)), T(vid), T(xn), T(yn))
        want = j_warp.bilinear_sample_packed_u8(
            j_warp.build_corner_stack_u8(jnp.asarray(img)), jnp.asarray(vid),
            jnp.asarray(xn), jnp.asarray(yn))
    elif pack == "f32":
        got = t_warp.bilinear_sample_packed(
            t_warp.build_corner_stack(T(img)), T(vid), T(xn), T(yn))
        want = j_warp.bilinear_sample_packed(
            j_warp.build_corner_stack(jnp.asarray(img)), jnp.asarray(vid),
            jnp.asarray(xn), jnp.asarray(yn))
    else:
        got = t_warp.bilinear_sample(T(img), T(vid), T(xn), T(yn))
        want = j_warp.bilinear_sample(
            jnp.asarray(img), jnp.asarray(vid), jnp.asarray(xn),
            jnp.asarray(yn))
    close(got, want)
    oob = (np.abs(xn) > 1) | (np.abs(yn) > 1)
    assert oob.any() and np.all(got.numpy()[oob] == 0)


@pytest.mark.parametrize("pack", ["u8", "f32", False])
def test_epipolar_colors_shared_and_mean_fill(pack):
    """Held-out target pose (as served frames are), so that no sample
    projects exactly onto a pixel centre of a source view, where a last-bit
    difference in the projection would flip the out-of-bounds mask."""
    from pronerf_tpu.render.raygen import prepare_scene as j_prepare
    from pronerf_tpu.render.raygen import rays_for_pose as j_rays_for_pose
    from pronerf_tpu_torch.convert import scene_from_numpy

    sc = make_scene(n_views=5, H=16, W=20, seed=0)
    ref = [0, 2, 3, 4]
    js = j_prepare(sc["images"][ref], sc["poses"][ref], sc["K"],
                   pack_corners=pack)
    ts = scene_from_numpy(sc["images"][ref], sc["poses"][ref], sc["K"],
                          pack_corners=pack)
    assert ts["images"].dtype == (torch.int32 if pack == "u8" else torch.float32)
    np.testing.assert_array_equal(ts["images"].numpy(), np.asarray(js["images"]))
    jr = j_rays_for_pose(16, 20, sc["K"], sc["poses"][1])
    z3d = (1.0 / (1.0 - 0.9 * np.random.default_rng(10).random((320, 8)))
           ).astype(np.float32)
    view_ids = np.array([2, 0, 3, 1])
    want = j_warp.epipolar_colors_shared(
        js["images"], js["fused_mats"], js["K"], jnp.asarray(view_ids),
        jr["or_o"], jr["or_d"], jnp.asarray(z3d))
    got = t_warp.epipolar_colors_shared(
        ts["images"], ts["fused_mats"], ts["K"], T(view_ids),
        T(jr["or_o"]), T(jr["or_d"]), T(z3d))
    assert got.shape == (320, 4, 8, 3)
    close(got, want)
    invalid = got.numpy().sum(-1) == 0
    assert invalid.any() and not invalid.all()
    filled = t_warp.mean_fill_invalid(got)
    close(filled, j_warp.mean_fill_invalid(want))
    assert (filled.numpy().sum(-1) > 0).mean() > (~invalid).mean()


def test_metrics():
    rng = np.random.default_rng(11)
    a = rng.random((24, 30, 3)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    mse = t_metrics.img2mse(T(a), T(b))
    close(mse, j_metrics.img2mse(jnp.asarray(a), jnp.asarray(b)), atol=1e-7)
    close(t_metrics.mse2psnr(mse), j_metrics.mse2psnr(jnp.asarray(mse.numpy())),
          atol=1e-4)
    np.testing.assert_array_equal(t_metrics.to8b(a), j_metrics.to8b(a))
    assert abs(t_metrics.img2ssim(a, b) - j_metrics.img2ssim(a, b)) < 1e-7
    assert t_metrics.img2ssim(a, a) == pytest.approx(1.0)
