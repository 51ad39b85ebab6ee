"""The sampler depths' sort op (``pronerf_tpu_torch/kernels/depth_sort.py``,
``pronerf::depth_sort``) on the CPU, where it runs its plain version, the
chain ``ops/sampling.py:sort_sampler_depths``; the kernel itself is held to
the chain on the card by ``tests/test_torch_depth_sort_card.py``.

- the op is registered with its schema and passes ``torch.library.opcheck``;
- its CPU implementation equals the three lines ``render_rays`` ran before
  the op (sigmoid into [near, far], ``sort_with_payloads``,
  ``ndc_to_3d_depth``) bit for bit, on logits with ties, NaN, +-inf and
  large magnitudes;
- ``render_rays`` with ``use_kernels`` takes the op wherever the MinMax
  kernel made the sampler's output and S <= 32, and its frames equal those
  of the chain; S > 32 keeps the chain;
- no training route reaches the op.
"""

import pytest
import torch

from pronerf_tpu_torch.kernels import depth_sort as ds
from pronerf_tpu_torch.models.pronerf import (
    RenderStatics,
    init_pronerf_params,
    render_rays,
)
from pronerf_tpu_torch.ops.sampling import ndc_to_3d_depth, sort_with_payloads
from pronerf_tpu_torch.render.raygen import prepare_scene, rays_for_pose
from pronerf_tpu_torch.render.renderer import make_frame_renderer
from pronerf_tpu_torch.utils.synthetic import make_scene

torch.set_num_threads(2)


def old_chain(mm_out, S, near, far, eps):
    """The lines of ``render_rays``' steps 1 and 2 before the op."""
    depth_values = torch.sigmoid(mm_out[:, :S]) * (far - near) + near
    depth_values, mm_add, mm_mul = sort_with_payloads(
        depth_values, mm_out[:, S: 2 * S], mm_out[:, 2 * S: 3 * S])
    return depth_values, mm_add, mm_mul, ndc_to_3d_depth(depth_values, eps)


def sampler_output(n, S, seed=0):
    """A MinMax-shaped sampler output [N, 8-padded 3 S + 3], sliced to its
    3 S + 3 columns as ``render_rays`` slices it: logits on a coarse grid
    (equal depths in most rays), NaN, +-inf and large magnitudes planted in
    the logits, NaN and inf in the payloads."""
    g = torch.Generator().manual_seed(seed)
    width = 3 * S + 3
    mm = torch.randn(n, -(-width // 8) * 8, generator=g) * 3
    mm[:, :S] = torch.round(mm[:, :S] * 2) / 2  # ties
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30,
                            -1e30, 88.0, -104.0, 0.0, -0.0])
    pick = torch.rand(n, 3 * S, generator=g) < 0.08
    idx = torch.randint(len(special), (n, 3 * S), generator=g)
    mm[:, :3 * S] = torch.where(pick, special[idx], mm[:, :3 * S])
    for k, v in enumerate(special.tolist()):  # each one at least once
        mm[k % n, k % S] = v
        mm[(k + 1) % n, S + k % (2 * S)] = v
    return mm[:, :width]


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


SCHEMA = ("pronerf::depth_sort(Tensor mm_out, SymInt n_samples, float near, "
          "float far, float ndc_eps) -> (Tensor, Tensor, Tensor, Tensor)")


@pytest.mark.parametrize("S", [8, 16])
def test_op_is_registered_and_passes_opcheck(S):
    op = torch.ops.pronerf.depth_sort.default
    assert op is ds.depth_sort_op
    assert str(op._schema) == SCHEMA
    mm = sampler_output(13, S, seed=S)
    mm = torch.where(torch.isfinite(mm), mm, torch.zeros_like(mm))
    torch.library.opcheck(op, (mm, S, 0.0, 1.0, 1e-5))
    torch.library.opcheck(op, (mm.contiguous(), S, 2.0, 6.0, 1e-6))
    assert ds.sorted_sampler_depths.launches == 0  # no launch on the CPU


@pytest.mark.parametrize("bounds", [(0.0, 1.0, 1e-5), (1e-6, 1.0, 1e-6),
                                    (2.0, 6.0, 1e-5)],
                         ids=["stage2", "stage1", "near2_far6"])
@pytest.mark.parametrize("S", [8, 16])
@pytest.mark.parametrize("n", [1, 7, 4099])
def test_cpu_op_equals_the_old_chain_bit_for_bit(n, S, bounds):
    near, far, eps = bounds
    mm = sampler_output(n, S, seed=n + S)
    got = ds.sorted_sampler_depths(mm, S, near, far, eps)
    want = old_chain(mm, S, near, far, eps)
    for name, g, w in zip(("depth", "mm_add", "mm_mul", "z3d"), got, want):
        assert g.dtype == torch.float32 and g.is_contiguous(), name
        assert same_bits(g, w), name
    depth = got[0]
    # the inputs hold what they are meant to: equal depths, NaN, saturated
    # sigmoids at both ends
    if n > 1:
        assert bool((depth[:, 1:] == depth[:, :-1]).any())
        assert bool(torch.isnan(depth).any())
        assert bool((depth == near).any()) and bool((depth == far).any())


def test_the_chain_sorts_stably_and_nan_last():
    """What the kernel repeats: equal depths keep their payloads' order,
    NaN sorts after every number."""
    S = 8
    mm = torch.zeros(1, 3 * S)
    mm[0, :S] = torch.tensor([1.0, float("nan"), -1.0, 1.0, float("nan"),
                              -1.0, 0.0, 1.0])
    mm[0, S: 2 * S] = torch.arange(S, dtype=torch.float32)
    depth, add, _, _ = ds.sorted_sampler_depths(mm, S, 0.0, 1.0, 1e-5)
    assert add[0].tolist() == [2.0, 5.0, 6.0, 0.0, 3.0, 7.0, 1.0, 4.0]
    assert bool(torch.isnan(depth[0, -2:]).all())


def _frame_setup(netarch="nerf", S=8):
    sc = make_scene(n_views=5, H=10, W=12, seed=3)
    src = [0, 2, 3, 4]
    scene = prepare_scene(sc["images"][src], sc["poses"][src], sc["K"],
                          device="cpu")
    kw = dict(mmnetdepth=2, N_samples=S)
    if netarch == "donerf":
        kw |= dict(netarch="donerf", netdepth=4, netwidth=32)
    params = init_pronerf_params(torch.Generator().manual_seed(3), **kw)
    statics = RenderStatics.infer(compute_dtype="bfloat16", use_kernels=True,
                                  netarch=netarch, N_samples=S)
    return sc, scene, params, statics


def _spy(monkeypatch):
    calls = []
    real = ds.sorted_sampler_depths

    def spy(*a):
        calls.append(a[1])
        return real(*a)

    monkeypatch.setattr(ds, "sorted_sampler_depths", spy)
    return calls


@pytest.mark.parametrize("form", ["default", "int8", "raw_route", "donerf"])
def test_render_rays_with_kernels_on_the_cpu_is_unchanged(form,
                                                          monkeypatch):
    import dataclasses

    from pronerf_tpu_torch.models import pronerf

    sc, scene, params, statics = _frame_setup(
        "donerf" if form == "donerf" else "nerf")
    statics = dataclasses.replace(statics, **{
        "int8": {"quant": "int8"}, "raw_route": {"clamp_raw": True}}.get(
            form, {}))
    H, W = sc["images"].shape[1:3]
    c2w = sc["poses"][1][:3, :4]
    calls = _spy(monkeypatch)
    got = make_frame_renderer(statics, H, W, sc["K"], 0, device="cpu")(
        params, scene, c2w)
    assert calls == [8]
    monkeypatch.setattr(pronerf, "_sort_on_kernel", lambda *a: False)
    want = make_frame_renderer(statics, H, W, sc["K"], 0, device="cpu")(
        params, scene, c2w)
    assert calls == [8]
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   equal_nan=True, msg=k)


def test_more_than_32_samples_keep_the_chain(monkeypatch):
    sc, scene, params, statics = _frame_setup(S=40)
    calls = _spy(monkeypatch)
    H, W = sc["images"].shape[1:3]
    out = make_frame_renderer(statics, H, W, sc["K"], 0, device="cpu")(
        params, scene, sc["poses"][1][:3, :4])
    assert calls == []
    assert bool(torch.isfinite(out["rgb1"]).all())


def _raise(*a, **kw):
    raise AssertionError("a training route reached the depth sort op")


@pytest.mark.parametrize("stage", ["stage1_nerf", "stage1_sampler", "stage2"])
def test_training_routes_never_call_the_op(stage, monkeypatch):
    monkeypatch.setattr(ds, "sorted_sampler_depths", _raise)
    monkeypatch.setattr(ds, "depth_sort_op", _raise)
    sc = make_scene(n_views=5, H=6, W=8, seed=4)
    scene = prepare_scene(sc["images"], sc["poses"], sc["K"], device="cpu")
    params = init_pronerf_params(torch.Generator().manual_seed(4),
                                 netdepth=3, netwidth=32, mmnetdepth=2,
                                 mmnetwidth=32)
    statics = getattr(RenderStatics, stage)()
    rays = rays_for_pose(6, 8, sc["K"], torch.as_tensor(sc["poses"][2]),
                         device="cpu")
    rays["pose_id"] = torch.full((48,), 2)
    controls = {"neighbor_subset": [0, 1, 2, 3], "n_mult": 2,
                "dir_expand": True, "dir_jitter": False,
                "rng": torch.Generator().manual_seed(4)}
    out = render_rays(params, rays, scene, controls, statics)
    out["rgb1"].sum().backward()
    assert params["nerf"].parameters().__next__().grad is not None
