"""The port's copy of the host runtime (``pronerf_tpu_torch/native``) against
the JAX package's, on the CPU.

The ray pool is the point: the JAX trainer builds it with the C++ library
whenever that loads (an mt19937_64 Fisher-Yates shuffle), and the port must
take the same path and give the same pool from the same Generator, bit for
bit, with no patching of either package. Each test skips, by condition,
where the JAX package's library does not load (no compiler, and so no
library of the port's either).
"""

import numpy as np
import pytest

import pronerf_tpu.native as j_native
import pronerf_tpu_torch.native as t_native
from pronerf_tpu.ops.rays import get_rays_np
from pronerf_tpu.render import raygen as j_raygen
from pronerf_tpu_torch.render import raygen as t_raygen
from pronerf_tpu_torch.utils.synthetic import make_consistent_scene, make_scene


def need_jax_native():
    if not j_native.is_available():
        pytest.skip("the JAX package's native library does not load here")


@pytest.mark.parametrize("i_train,seed", [([0, 2, 3, 5], 11),
                                          ([1, 2, 3, 4, 5], 0)])
def test_build_ray_pool_equals_jax_default_path_bit_for_bit(i_train, seed):
    """The JAX package's default ``build_ray_pool`` (its native path, as its
    trainer runs it) against the port's, from equal Generators."""
    need_jax_native()
    sc = make_consistent_scene(seed=0, W=32, H=24, n_views=6)
    jrng, trng = np.random.default_rng(seed), np.random.default_rng(seed)
    calls = t_native.build_ray_pool_native.calls
    want = j_raygen.build_ray_pool(sc["images"], sc["poses"], sc["K"],
                                   i_train, 4, jrng)
    got = t_raygen.build_ray_pool(sc["images"], sc["poses"], sc["K"],
                                  i_train, 4, trng)
    assert t_native.build_ray_pool_native.calls == calls + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert trng.integers(0, 2**31) == jrng.integers(0, 2**31)
    # the NumPy form shuffles otherwise: the two forms differ in order only
    numpy_pool = t_raygen.build_ray_pool(
        sc["images"], sc["poses"], sc["K"], i_train, 4,
        np.random.default_rng(seed), native=False)
    assert not np.array_equal(numpy_pool[1], got[1])
    assert sorted(numpy_pool[1]) == sorted(got[1])


def test_native_pool_rays_are_the_numpy_rays():
    need_jax_native()
    sc = make_scene(n_views=3, H=12, W=16, seed=0)
    H, W, _ = sc["hwf"]
    rays, ids = t_native.build_ray_pool_native(
        sc["images"], sc["poses"], sc["K"], seed=0, shuffle=False)
    assert rays.shape == (3 * H * W, 3, 3) and ids.shape == (3 * H * W,)
    for t in range(3):
        ro, rd = get_rays_np(H, W, sc["K"], sc["poses"][t])
        seg = rays[t * H * W:(t + 1) * H * W]
        np.testing.assert_allclose(seg[:, 0], ro.reshape(-1, 3), atol=1e-6)
        np.testing.assert_allclose(seg[:, 1], rd.reshape(-1, 3), atol=1e-5)
        np.testing.assert_array_equal(seg[:, 2],
                                      sc["images"][t].reshape(-1, 3))
        assert np.all(ids[t * H * W:(t + 1) * H * W] == t)
    shuf, ids1 = t_native.build_ray_pool_native(
        sc["images"], sc["poses"], sc["K"], seed=0, shuffle=True)
    assert not np.array_equal(shuf, rays)
    order = np.lexsort(rays.reshape(len(rays), -1).T)
    order1 = np.lexsort(shuf.reshape(len(shuf), -1).T)
    np.testing.assert_array_equal(shuf[order1], rays[order])
    np.testing.assert_array_equal(ids1[order1], ids[order])
    with pytest.raises(ValueError, match="poses"):
        t_native.build_ray_pool_native(sc["images"], sc["poses"][:2],
                                       sc["K"], seed=0)


def test_colmap_visibility_and_greedy_cover_equal_jax(tmp_path):
    need_jax_native()
    from pronerf_tpu.utils.fixtures import write_colmap_model

    write_colmap_model(tmp_path, n_images=6, n_points=40)
    rank = np.array([-1, 0, 1, 2, -1, 3, 4], np.int32)  # image id -> rank
    path = tmp_path / "sparse/0/points3D.bin"
    got = t_native.colmap_visibility_native(path, rank, 5)
    want = j_native.colmap_visibility_native(path, rank, 5)
    assert got.dtype == want.dtype == np.float32 and got.sum() > 0
    np.testing.assert_array_equal(got, want)
    assert t_native.colmap_visibility_native(tmp_path / "none.bin", rank,
                                             5) is None
    for n in (1, 3, 5):
        before = got.copy()
        np.testing.assert_array_equal(t_native.greedy_cover_native(got, n),
                                      j_native.greedy_cover_native(want, n))
        np.testing.assert_array_equal(got, before)  # left as it was
    vis = np.zeros((4, 10), np.float32)
    vis[0, :3] = vis[1, :6] = vis[2, 6:9] = vis[3, :2] = 1
    assert t_native.greedy_cover_native(vis, 2).tolist() == [1, 2]
    with pytest.raises(ValueError, match="n_pick"):
        t_native.greedy_cover_native(vis, 5)


def test_library_is_named_by_its_source(tmp_path, monkeypatch):
    need_jax_native()
    assert t_native.is_available()
    path = t_native.lib_path()
    assert path.exists() and path.parent == t_native.BUILD_DIR
    assert t_native.build_info["path"] == str(path)
    # the JAX package's compiler line (native/Makefile)
    assert t_native.CXXFLAGS == ("-O3", "-march=native", "-fPIC",
                                 "-std=c++17", "-Wall", "-pthread", "-shared")
    # an edited source gets another library, so a stale one is never loaded
    edited = tmp_path / "pronerf_native.cpp"
    edited.write_bytes(t_native.SOURCE.read_bytes() + b"\n")
    monkeypatch.setattr(t_native, "SOURCE", edited)
    assert t_native.lib_path() != path
