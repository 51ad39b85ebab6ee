"""The NeRF kernel's inputs in one kernel (``kernels/query_prep.py``,
``csrc/query_prep.cu:query_prep_kernel``) on the card, against the PyTorch
chain it replaces run on the card too (``query_prep.query_inputs_chain``:
the refine epilogue, the query points, the view encoding and its f32 GEMM,
the transposed rows, the norm and the mean): every output bit for bit but
the three sums, which must lie within ``query_prep.sum_bounds`` (the same
terms summed in another order: the view term's 27 exact products, whose
order cuBLAS picks; the norm over 3; the mean over S); a CUDA-graph replay;
whole frames through ``render_rays`` and ``render_frame``, eager and
replayed, within the served limits; and the launch counter.

The cases: the rays of a 1008x756 frame, of a 504x378 one and a ragged
count, at 8, 16 and 32 samples a ray, for the NeRF MLP's 128 view rows and
DoNeRF's 4, from a refine output laid out as the MinMax kernel's (row-major,
8-padded columns, sliced) with NaN, +-inf, +-1e30 and saturating logits,
NaN depths and corrections, and a few NaN view directions.

These tests need a CUDA card and skip without one; the file imports no JAX.
On the card, from the root of the repo::

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_query_prep_card.py
"""

import pytest
import torch

RAYS = {"1008x756": 762048, "504x378": 190512, "ragged": 100003}
ROWS = {"nerf": 128, "donerf": 4}
SERVED = (0.0, 1.0, 1e-2, True)  # near, far, offset_scale, add_offsets
# the served cells' limits on a frame's RMS against the reference
# (benchmark/configs: fern_trt, fern_donerf)
LIMITS = {"nerf": {"rgb1": 0.007, "rgb0": 0.008, "mm_rgb": 0.0013,
                   "depth": 0.005, "depth0": 0.0006},
          "donerf": {"rgb1": 0.06, "rgb0": 0.008, "mm_rgb": 0.0013,
                     "depth": 0.095, "depth0": 0.0006}}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def op_inputs(n, S, rows, device, seed):
    """The op's tensor inputs at ``n`` rays, with NaN, +-inf, +-1e30 and
    saturating values among the refine logits (1%), NaN depths, density
    corrections and view directions."""
    g = torch.Generator(device=device).manual_seed(seed)
    width = 4 * S + 3
    refine = torch.randn(n, -(-width // 8) * 8, generator=g,
                         device=device) * 3
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30,
                            -1e30, 100.0, -110.0, 0.0, -0.0], device=device)
    pick = torch.rand(n, width, generator=g, device=device) < 0.01
    idx = torch.randint(len(special), (n, width), generator=g,
                        device=device)
    refine[:, :width] = torch.where(pick, special[idx], refine[:, :width])
    depth = torch.sort(torch.sigmoid(
        torch.randn(n, S, generator=g, device=device) * 2), dim=-1).values
    depth[::101, -1] = float("nan")
    mm_add = torch.randn(n, S, generator=g, device=device)
    mm_add[::53, 0] = float("nan")
    mm_mul = torch.rand(n, S, generator=g, device=device)
    ndc_o = torch.randn(n, 3, generator=g, device=device)
    ndc_d = torch.randn(n, 3, generator=g, device=device)
    dirs = torch.nn.functional.normalize(
        torch.randn(n, 3, generator=g, device=device), dim=-1)
    dirs[::997] = float("nan")
    view_w = (torch.randn(rows, 256 + 27, generator=g, device=device)
              * 0.1)[:, 256:]
    return (refine[:, :width], depth, mm_add, mm_mul, ndc_o, ndc_d, dirs,
            view_w)


def both(ins, S, statics=SERVED):
    from pronerf_tpu_torch.kernels import query_prep as qp
    from pronerf_tpu_torch.utils.profiling import COUNTERS

    before = qp.query_inputs.launches, COUNTERS["query_prep_launches"]
    got = qp.query_inputs(*ins, S, *statics, 4)
    assert (qp.query_inputs.launches - before[0],
            COUNTERS["query_prep_launches"] - before[1]) == (1, 1)
    want = qp.query_inputs_chain(*ins, S, *statics, 4)
    torch.cuda.synchronize()
    return got, want


def assert_contract(got, want, ins, S):
    from pronerf_tpu_torch.kernels import query_prep as qp

    diff = qp.differences(got, want, ins[7], ins[6], S)
    bad = {k: v for k, v in diff.items() if not k.endswith("_exact") and v}
    assert not bad, (bad, diff)
    return diff


@pytest.mark.card
@pytest.mark.parametrize("arch", list(ROWS))
@pytest.mark.parametrize("S", [8, 16, 32])
@pytest.mark.parametrize("rays", list(RAYS))
def test_kernel_keeps_the_contract_with_the_chain(card, rays, S, arch):
    ins = op_inputs(RAYS[rays], S, ROWS[arch], card, seed=S + ROWS[arch])
    got, want = both(ins, S)
    assert_contract(got, want, ins, S)
    z_t = want[3]
    assert bool(torch.isnan(z_t).any())  # NaN logits and depths were there
    assert bool((want[0] == 0.0).any()) and bool((want[0] == 1.0).any())


@pytest.mark.card
@pytest.mark.parametrize("statics", [SERVED, (1e-6, 1.0, 1e-2, True),
                                     (2.0, 6.0, 2e-2, True),
                                     (0.0, 1.0, 1e-2, False)],
                         ids=["served", "stage1", "far6", "no_offsets"])
def test_other_bounds_and_no_offsets(card, statics):
    S = 8
    ins = op_inputs(RAYS["504x378"], S, ROWS["nerf"], card, seed=11)
    got, want = both(ins, S, statics)
    assert_contract(got, want, ins, S)


@pytest.mark.card
def test_kernel_replays_in_a_cuda_graph(card):
    from pronerf_tpu_torch.kernels import query_prep as qp

    S = 8
    ins = op_inputs(RAYS["1008x756"], S, ROWS["nerf"], card, seed=5)
    eager = qp.query_inputs(*ins, S, *SERVED, 4)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm-up off the capture
        qp.query_inputs(*ins, S, *SERVED, 4)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qp.query_inputs(*ins, S, *SERVED, 4)
    graph.replay()
    torch.cuda.synchronize()
    for name, a, b in zip(qp.OUTPUTS, out, eager):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
    fresh = op_inputs(RAYS["1008x756"], S, ROWS["nerf"], card, seed=6)
    for t, f in zip(ins, fresh):
        t.copy_(f)
    graph.replay()
    torch.cuda.synchronize()
    assert_contract(out, qp.query_inputs_chain(*ins, S, *SERVED, 4), ins, S)


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


def within_limits(got, want, netarch):
    rms = {k: float(((got[k].double() - want[k].double()) ** 2).mean()
                    .sqrt()) for k in LIMITS[netarch]}
    assert all(rms[k] <= LIMITS[netarch][k] for k in rms), rms
    return rms


@pytest.mark.card
@pytest.mark.parametrize("netarch", list(ROWS))
def test_render_rays_through_the_kernel_against_the_chain(card, netarch,
                                                          monkeypatch):
    """A whole 1008x756 frame of seeded nets through ``render_rays`` with
    the served statics against the same frame with the route off (the
    chain on the card): within the served limits, every output finite where
    the chain's is."""
    from pronerf_tpu_torch.models import pronerf
    from pronerf_tpu_torch.render.raygen import rays_for_pose
    from pronerf_tpu_torch.utils.profiling import COUNTERS

    sc, scene, statics, packed = frame_setup(card, netarch)
    rays = rays_for_pose(756, 1008, sc["K"], torch.as_tensor(sc["poses"][1]),
                         device=card)
    controls = {"target_t": torch.as_tensor(sc["poses"][1][:3, 3],
                                            device=card)}
    with torch.no_grad():
        before = COUNTERS["query_prep_launches"]
        got = pronerf.render_rays(packed, rays, scene, controls, statics)
        assert COUNTERS["query_prep_launches"] - before == 1
        monkeypatch.setattr(pronerf, "_prep_on_kernel", lambda *a: False)
        want = pronerf.render_rays(packed, rays, scene, controls, statics)
        assert COUNTERS["query_prep_launches"] - before == 1
    torch.cuda.synchronize()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(torch.isfinite(got[k]), torch.isfinite(want[k])), k
    within_limits(got, want, netarch)


@pytest.mark.card
@pytest.mark.parametrize("netarch", list(ROWS))
def test_render_frame_eager_and_replayed_against_the_chain(card, netarch,
                                                           monkeypatch):
    """``render_frame`` at 504x378: its eager frame, its capture and its
    replay against the chain's frame, within the served limits; the launch
    counter reads 1 an eager frame, ``GRAPH_WARMUP + 1`` a capture and 0 a
    replay."""
    from pronerf_tpu_torch.models import pronerf
    from pronerf_tpu_torch.render.renderer import make_frame_renderer
    from pronerf_tpu_torch.utils.profiling import COUNTERS, GRAPH_WARMUP
    from pronerf_tpu_torch.utils.tensors import as_f32

    H, W = 378, 504
    sc, scene, statics, packed = frame_setup(card, netarch, H, W)
    render = make_frame_renderer(statics, H, W, sc["K"], 0, device=card)
    c2w = sc["poses"][1][:3, :4]

    def launches(fn):
        before = COUNTERS["query_prep_launches"]
        out = fn()
        torch.cuda.synchronize()
        return COUNTERS["query_prep_launches"] - before, out

    counts, frames = [], []
    for _ in range(3):  # eager, capture, replay
        n, out = launches(lambda: render(packed, scene, c2w))
        counts.append(n)
        frames.append(out)
    assert counts == [1, GRAPH_WARMUP + 1, 0]
    monkeypatch.setattr(pronerf, "_prep_on_kernel", lambda *a: False)
    with torch.no_grad():
        n, chain = launches(lambda: render.frame(packed, scene,
                                                 as_f32(c2w, card)))
    assert n == 0
    for out in frames:
        within_limits(out, chain, netarch)
    assert torch.equal(frames[2]["rgb1"], frames[0]["rgb1"])
