"""The served frame's gather kernel pair (``kernels/epipolar_gather.py``)
on the card, against the PyTorch chain it replaces run on the card too
(``tests/torch_gather_cases.py``): the refine kernel's input bit for bit
(colours, hit masks and filled rows all decide it), the device counters,
the launches, a CUDA-graph replay, and whole frames through ``render_rays``.

The cases: the 1008x756 frame with the served windows (8 tiles of 198
rows), the 504x378 frame unwindowed, and at 1008x756 a ragged last tile
with the frame renderer's zero-direction pads, windows that miss, windows
that cover, unwindowed; each in both row layouts. Every case has NaN and
zero depths: their points fetch pixels in the image and come out invalid.

These tests need a CUDA card and skip without one; the file imports no JAX.
On the card, from the root of the repo (``--noconftest``: the tests'
``conftest.py`` imports JAX, which the card's machine does not have)::

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_gathers_card.py
"""

import pytest
import torch

import torch_gather_cases as gather_cases

CASES = {
    # name: (H, W, stride, zero-direction pads, n_tiles, window_rows)
    "served_1008x756": (756, 1008, 1, 0, 8, 198),
    "viewer_504x378": (378, 504, 1, 0, 0, 0),
    "ragged_last_tile": (756, 1008, 3, 40, 5, 198),
    "windows_that_miss": (756, 1008, 3, 0, 8, 16),
    "windows_that_cover": (756, 1008, 3, 0, 3, 756),
    "unwindowed_1008x756": (756, 1008, 1, 0, 0, 0),
}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


_made = {}


def case_of(name, card):
    H, W, stride, n_zero = CASES[name][:4]
    key = (H, W, stride, n_zero)
    if key not in _made:
        _made.clear()  # one frame's inputs on the card at a time
        _made[key] = gather_cases.frame_case(H, W, stride, n_zero,
                                             device=card)
    return _made[key]


@pytest.mark.card
@pytest.mark.parametrize("svc", [False, True], ids=["vsc", "svc"])
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_equals_the_pytorch_chain_bit_for_bit(card, name, svc):
    from pronerf_tpu_torch.kernels import epipolar_gather as eg

    c = case_of(name, card)
    n_tiles, rows = CASES[name][4:]
    want = gather_cases.chain(c, n_tiles, rows, svc)
    before = eg.epipolar_gather_rows.launches
    got = eg.epipolar_gather_rows(*gather_cases.args(c), c["head"], n_tiles,
                                  rows, svc=svc)
    torch.cuda.synchronize()
    assert eg.epipolar_gather_rows.launches - before == (2 if n_tiles else 1)
    diff = got.view(torch.int16) != want.view(torch.int16)
    assert gather_cases.same_bits(got, want), (
        f"{int(diff.sum())} of {diff.numel()} values differ, in rows "
        f"{sorted(set(diff.nonzero()[:, 0].tolist()))[:12]}")
    # the NaN depths' points: invalid in every view, as the chain has them
    assert torch.isnan(got[6:].float()).any()


@pytest.mark.card
@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][4]])
def test_device_counters_equal_the_pytorch_chain(card, name):
    from pronerf_tpu_torch.kernels import epipolar_gather as eg
    from pronerf_tpu_torch.utils import profiling

    c = case_of(name, card)
    n_tiles, rows = CASES[name][4:]
    with profiling.tracing(counters=True):
        gather_cases.chain(c, n_tiles, rows, False)
        want = profiling.read_device_counters()
    with profiling.tracing(counters=True):
        eg.epipolar_gather_rows(*gather_cases.args(c), c["head"], n_tiles,
                                rows)
        got = profiling.read_device_counters()
    assert got == want
    assert want["gather_in_image"] > 0


@pytest.mark.card
def test_kernel_pair_replays_in_a_cuda_graph(card):
    from pronerf_tpu_torch.kernels import epipolar_gather as eg

    c = case_of("served_1008x756", card)
    n_tiles, rows = CASES["served_1008x756"][4:]
    eager = eg.epipolar_gather_rows(*gather_cases.args(c), c["head"],
                                    n_tiles, rows)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm-up off the capture
        eg.epipolar_gather_rows(*gather_cases.args(c), c["head"], n_tiles,
                                rows)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = eg.epipolar_gather_rows(*gather_cases.args(c), c["head"],
                                      n_tiles, rows)
    graph.replay()
    torch.cuda.synchronize()
    assert gather_cases.same_bits(out, eager)


@pytest.mark.card
@pytest.mark.parametrize("hw", [(378, 504), (756, 1008)],
                         ids=["504x378", "1008x756"])
def test_frame_through_the_kernel_equals_the_pytorch_form(card, hw,
                                                          monkeypatch):
    """A whole frame of random nets through ``render_rays`` with the gather
    statics the frame renderer resolves: every output equal bit for bit to
    the same frame with the route off (the PyTorch form on the card)."""
    from pronerf_tpu_torch.kernels import epipolar_gather as eg
    from pronerf_tpu_torch.models import pronerf
    from pronerf_tpu_torch.render.raygen import prepare_scene, rays_for_pose
    from pronerf_tpu_torch.render.renderer import resolve_gather_statics
    from pronerf_tpu_torch.utils.synthetic import make_scene

    H, W = hw
    sc = make_scene(n_views=5, H=H, W=W, focal=0.875 * W, seed=3)
    ref = gather_cases.REF
    scene = prepare_scene(sc["images"][ref], sc["poses"][ref], sc["K"],
                          device=card)
    rays = rays_for_pose(H, W, sc["K"], torch.as_tensor(sc["poses"][1]),
                         device=card)
    statics = resolve_gather_statics(
        pronerf.RenderStatics.infer(compute_dtype="bfloat16",
                                    use_kernels=True, gather_tiles=-1),
        H, W, H * W)
    params = pronerf.init_pronerf_params(torch.Generator().manual_seed(3),
                                         device=card)
    packed = pronerf.pack_serving_params(params, statics)
    controls = {"target_t": torch.as_tensor(sc["poses"][1][:3, 3],
                                            device=card)}
    with torch.no_grad():
        before = eg.epipolar_gather_rows.launches
        got = pronerf.render_rays(packed, rays, scene, controls, statics)
        assert eg.epipolar_gather_rows.launches - before == (
            2 if statics.gather_tiles else 1)
        monkeypatch.setattr(pronerf, "_gather_on_kernel", lambda *a: False)
        want = pronerf.render_rays(packed, rays, scene, controls, statics)
    for k in want:
        assert torch.equal(torch.nan_to_num(got[k]),
                           torch.nan_to_num(want[k])), k
    assert statics.gather_tiles == (8 if H == 756 else 0)
