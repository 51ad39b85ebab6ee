"""The sampler depths' sort kernel (``kernels/depth_sort.py``,
``csrc/depth_sort.cu:depth_sort_kernel``) on the card, against the PyTorch
chain it replaces run on the card too (``ops/sampling.py:
sort_sampler_depths``: sigmoid, mul, add, a stable ``torch.sort``, two
gathers, the 3D depth): its four outputs bit for bit, a CUDA-graph replay,
whole frames through ``render_rays`` and the launch counter.

The cases: the rays of a 1008x756 frame, of a 504x378 one and a ragged
count, at 8, 16 and 32 samples a ray, from a sampler output laid out as the
MinMax kernel's (row-major, 8-padded columns, sliced); every case has equal
depths (logits on a coarse grid), NaN, +-inf and large logits. Apart:
planted equal keys, whose payloads show a stability error, and near = -0.0
with far < 0, which makes -0.0 depths.

These tests need a CUDA card and skip without one; the file imports no JAX.
On the card, from the root of the repo::

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_depth_sort_card.py
"""

import numpy as np
import pytest
import torch

RAYS = {"1008x756": 762048, "504x378": 190512, "ragged": 100003}
SERVED = (0.0, 1.0, 1e-5)  # near, far, ndc_eps of the served statics


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def sampler_output(n, S, device, seed, grid=0.5):
    """A MinMax-shaped sampler output: [N, 8-padded 3 S + 3] f32, sliced to
    3 S + 3 columns; logits rounded to ``grid`` (ties), a few NaN, +-inf,
    +-1e30 and saturating logits, NaN and inf among the payloads."""
    g = torch.Generator(device=device).manual_seed(seed)
    width = 3 * S + 3
    mm = torch.randn(n, -(-width // 8) * 8, generator=g, device=device) * 3
    mm[:, :S] = torch.round(mm[:, :S] / grid) * grid
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30,
                            -1e30, 100.0, -110.0, 0.0, -0.0], device=device)
    pick = torch.rand(n, 3 * S, generator=g, device=device) < 0.01
    idx = torch.randint(len(special), (n, 3 * S), generator=g, device=device)
    mm[:, :3 * S] = torch.where(pick, special[idx], mm[:, :3 * S])
    return mm[:, :width]


def both(mm, S, bounds=SERVED):
    from pronerf_tpu_torch.kernels import depth_sort as ds
    from pronerf_tpu_torch.ops.sampling import sort_sampler_depths

    before = ds.sorted_sampler_depths.launches
    got = ds.sorted_sampler_depths(mm, S, *bounds)
    assert ds.sorted_sampler_depths.launches - before == 1
    want = sort_sampler_depths(mm, S, *bounds)
    torch.cuda.synchronize()
    return got, want


def assert_same_bits(got, want):
    for name, g, w in zip(("depth", "mm_add", "mm_mul", "z3d"), got, want):
        assert g.shape == w.shape and g.is_contiguous(), name
        diff = g.view(torch.int32) != w.view(torch.int32)
        assert not bool(diff.any()), (
            f"{name}: {int(diff.sum())} of {diff.numel()} values differ, in "
            f"rays {diff.any(1).nonzero()[:8, 0].tolist()}")


@pytest.mark.card
@pytest.mark.parametrize("S", [8, 16, 32])
@pytest.mark.parametrize("rays", list(RAYS))
def test_kernel_equals_the_pytorch_chain_bit_for_bit(card, rays, S):
    mm = sampler_output(RAYS[rays], S, card, seed=S)
    got, want = both(mm, S)
    assert_same_bits(got, want)
    depth = want[0]
    assert bool((depth[:, 1:] == depth[:, :-1]).any())  # ties were sorted
    assert bool(torch.isnan(depth[:, -1]).any())


@pytest.mark.card
@pytest.mark.parametrize("S", [5, 8, 27])
def test_planted_equal_keys_keep_their_payloads_order(card, S):
    """Logits from {-1, 0, 1} and payloads that number their columns: a
    ray's equal depths must keep their columns' order."""
    n = 65536
    mm = sampler_output(n, S, card, seed=3 * S)
    g = torch.Generator(device=card).manual_seed(S)
    mm[:, :S] = torch.randint(-1, 2, (n, S), generator=g,
                              device=card).float()
    mm[:, S: 2 * S] = torch.arange(S, device=card, dtype=torch.float32)
    got, want = both(mm, S)
    assert_same_bits(got, want)
    depth, order = got[0], got[1]
    ties = depth[:, 1:] == depth[:, :-1]
    assert bool(ties.any())
    assert bool((order[:, 1:] > order[:, :-1])[ties].all())


@pytest.mark.card
@pytest.mark.parametrize("bounds", [SERVED, (1e-6, 1.0, 1e-6),
                                    (-0.0, -1.0, 1e-5), (2.0, 6.0, 1e-5)],
                         ids=["served", "stage1", "negative_zero", "far6"])
def test_nan_negative_zero_and_saturating_logits(card, bounds):
    S = 8
    mm = sampler_output(RAYS["504x378"], S, card, seed=11, grid=4.0)
    mm[::7, :S] = torch.tensor([float("nan"), -200.0, 300.0, -1e30, -0.0,
                                float("-inf"), 0.0, float("nan")],
                               device=card)
    got, want = both(mm, S, bounds)
    assert_same_bits(got, want)
    depth = got[0]
    assert bool(torch.isnan(depth[::7, -2:]).all())
    if bounds[0] == 0.0 and np.signbit(bounds[0]):  # -0.0 depths were made
        assert bool((depth.view(torch.int32) == -2**31).any())


@pytest.mark.card
def test_kernel_replays_in_a_cuda_graph(card):
    from pronerf_tpu_torch.kernels import depth_sort as ds

    S = 8
    mm = sampler_output(RAYS["1008x756"], S, card, seed=5)
    eager = ds.sorted_sampler_depths(mm, S, *SERVED)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm-up off the capture
        ds.sorted_sampler_depths(mm, S, *SERVED)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ds.sorted_sampler_depths(mm, S, *SERVED)
    graph.replay()
    torch.cuda.synchronize()
    assert_same_bits(out, eager)
    mm.copy_(sampler_output(RAYS["1008x756"], S, card, seed=6))
    graph.replay()
    torch.cuda.synchronize()
    from pronerf_tpu_torch.ops.sampling import sort_sampler_depths

    assert_same_bits(out, sort_sampler_depths(mm, S, *SERVED))


def frame_setup(card, netarch, H=756, W=1008):
    from pronerf_tpu_torch.models import pronerf
    from pronerf_tpu_torch.render.raygen import prepare_scene
    from pronerf_tpu_torch.render.renderer import resolve_gather_statics
    from pronerf_tpu_torch.utils.synthetic import make_scene

    sc = make_scene(n_views=5, H=H, W=W, focal=0.875 * W, seed=3)
    ref = [0, 2, 3, 4]
    scene = prepare_scene(sc["images"][ref], sc["poses"][ref], sc["K"],
                          device=card)
    statics = resolve_gather_statics(
        pronerf.RenderStatics.infer(compute_dtype="bfloat16",
                                    use_kernels=True, gather_tiles=-1,
                                    netarch=netarch), H, W, H * W)
    params = pronerf.init_pronerf_params(torch.Generator().manual_seed(3),
                                         netarch=netarch, device=card)
    return sc, scene, statics, pronerf.pack_serving_params(params, statics)


@pytest.mark.card
@pytest.mark.parametrize("netarch", ["nerf", "donerf"])
def test_frame_through_the_kernel_equals_the_chain(card, netarch,
                                                   monkeypatch):
    """A whole 1008x756 frame of seeded nets through ``render_rays`` with
    the served statics: every output equal bit for bit to the same frame
    with the route off (the chain on the card)."""
    from pronerf_tpu_torch.models import pronerf
    from pronerf_tpu_torch.render.raygen import rays_for_pose
    from pronerf_tpu_torch.utils.profiling import COUNTERS

    sc, scene, statics, packed = frame_setup(card, netarch)
    rays = rays_for_pose(756, 1008, sc["K"], torch.as_tensor(sc["poses"][1]),
                         device=card)
    controls = {"target_t": torch.as_tensor(sc["poses"][1][:3, 3],
                                            device=card)}
    with torch.no_grad():
        before = COUNTERS["depth_sort_launches"]
        got = pronerf.render_rays(packed, rays, scene, controls, statics)
        assert COUNTERS["depth_sort_launches"] - before == 1
        monkeypatch.setattr(pronerf, "_sort_on_kernel", lambda *a: False)
        want = pronerf.render_rays(packed, rays, scene, controls, statics)
        assert COUNTERS["depth_sort_launches"] - before == 1
    torch.cuda.synchronize()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k].contiguous().view(torch.uint8),
                           want[k].contiguous().view(torch.uint8)), k


@pytest.mark.card
def test_counter_reads_one_an_eager_frame_and_none_a_replay(card):
    from pronerf_tpu_torch.render.renderer import make_frame_renderer
    from pronerf_tpu_torch.utils.profiling import COUNTERS, GRAPH_WARMUP
    from pronerf_tpu_torch.utils.tensors import as_f32

    H, W = 378, 504
    sc, scene, statics, packed = frame_setup(card, "nerf", H, W)
    render = make_frame_renderer(statics, H, W, sc["K"], 0, device=card)
    c2w = sc["poses"][1][:3, :4]

    def launches(fn):
        before = COUNTERS["depth_sort_launches"]
        out = fn()
        torch.cuda.synchronize()
        return COUNTERS["depth_sort_launches"] - before, out

    with torch.no_grad():
        n, eager = launches(lambda: render.frame(packed, scene,
                                                 as_f32(c2w, card)))
    assert n == 1
    assert launches(lambda: render(packed, scene, c2w))[0] == 1  # eager
    assert launches(lambda: render(packed, scene, c2w))[0] == \
        GRAPH_WARMUP + 1  # the capture
    replays = COUNTERS["frame_replays"]
    n, out = launches(lambda: render(packed, scene, c2w))
    assert n == 0 and COUNTERS["frame_replays"] == replays + 1
    assert torch.equal(out["rgb1"], eager["rgb1"])
