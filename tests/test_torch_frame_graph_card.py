"""The served frame as a CUDA graph (``render/renderer.py:render_frame``) on
the card: the first call of a (parameter set, scene) pair runs eagerly, the
second captures the frame body and every later one replays it.

For the served statics (``benchmark/configs/fern_trt.json``'s) at 504x378
and at 1008x756 (the windowed gather), the tiled form (1008x756 in tiles of
65,536 rays, the last one padded), the int8 form and the transposed form:

- replayed frames equal the frame body run eagerly (``renderer.frame``)
  bit for bit, over several poses, and a frame returned earlier is left as
  it was by the calls after it;
- ``COUNTERS``' ``graph_captures``, ``frame_eager`` and ``frame_replays``
  read one capture, one eager frame and a replay for every call after the
  first (the capturing call replays its new graph too);
- a new parameter set, and a scene with a tensor replaced, each cost one
  capture more and render what they hold;
- with the device counters on (``profiling.tracing(counters=True)``) the
  frame runs eagerly.

These tests need a CUDA card and skip without one; the file imports no JAX.
On the card, from the root of the repo (``--noconftest``: the tests'
``conftest.py`` imports JAX, which the card's machine does not have)::

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_frame_graph_card.py
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EVENTS = ("graph_captures", "frame_eager", "frame_replays")
FORMS = {
    # name: (H, W, tile_rays, statics replaced)
    "served_504x378": (378, 504, 0, {}),
    "served_1008x756": (756, 1008, 0, {}),
    "tiled_1008x756": (756, 1008, 65536, {}),
    "int8_504x378": (378, 504, 0, {"quant": "int8"}),
    "transposed_504x378": (378, 504, 0, {"transposed": True}),
}
REF = [0, 2, 3, 4]  # the scene's source views; view 1 is the one rendered


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


_scenes = {}


def scene_of(H, W, card):
    """The synthetic scene at H x W: its host arrays and its scene bundle
    on the card (one size at a time)."""
    from pronerf_tpu_torch.render.raygen import prepare_scene
    from pronerf_tpu_torch.utils.synthetic import make_scene

    if (H, W) not in _scenes:
        _scenes.clear()
        sc = make_scene(n_views=5, H=H, W=W, focal=0.875 * W, seed=3)
        _scenes[H, W] = sc, prepare_scene(sc["images"][REF],
                                          sc["poses"][REF], sc["K"],
                                          pack_corners="u8", device=card)
    return _scenes[H, W]


def params_of(seed, card):
    from pronerf_tpu_torch.models.pronerf import init_pronerf_params

    return init_pronerf_params(torch.Generator().manual_seed(seed),
                               device=card)


def renderer_of(form, card):
    from pronerf_tpu_torch.models.pronerf import RenderStatics
    from pronerf_tpu_torch.render.renderer import make_frame_renderer

    H, W, tile_rays, over = FORMS[form]
    config = json.loads((ROOT / "benchmark/configs/fern_trt.json")
                        .read_text())
    statics = dataclasses.replace(RenderStatics.infer(**config["statics"]),
                                  **over)
    sc, scene = scene_of(H, W, card)
    return make_frame_renderer(statics, H, W, sc["K"], tile_rays,
                               device=card), sc, scene


def poses_of(sc, n):
    """``n`` poses about the held-out view 1, each moved a little."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        c2w = sc["poses"][1][:3, :4].astype(np.float32).copy()
        c2w[:, 3] += rng.uniform(-0.01, 0.01, 3).astype(np.float32)
        out.append(c2w)
    return out


def events():
    from pronerf_tpu_torch.utils.profiling import COUNTERS

    return {k: COUNTERS[k] for k in EVENTS}


def moved(before):
    return {k: v - before[k] for k, v in events().items()}


def same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def body(render, params, scene, c2w, card):
    """The frame body run eagerly, as ``render`` runs it on first sight."""
    from pronerf_tpu_torch.utils.tensors import as_f32

    with torch.no_grad():
        return render.frame(render.pack(params), scene, as_f32(c2w, card))


def assert_frames_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert same_bits(got[k], want[k]), k


@pytest.mark.card
@pytest.mark.parametrize("form", list(FORMS))
def test_replays_equal_the_eager_frame_body(card, form):
    render, sc, scene = renderer_of(form, card)
    params = params_of(3, card)
    poses = poses_of(sc, 4)
    before = events()
    outs, kept = [], []
    for c2w in poses:
        out = render(params, scene, c2w)
        outs.append(out)
        kept.append({k: v.clone() for k, v in out.items()})
    torch.cuda.synchronize()
    assert moved(before) == {"graph_captures": 1, "frame_eager": 1,
                             "frame_replays": len(poses) - 1}
    for c2w, out, snap in zip(poses, outs, kept):
        assert_frames_equal(out, body(render, params, scene, c2w, card))
        assert_frames_equal(out, snap)  # no later call wrote into it
    ptrs = {out["rgb1"].data_ptr() for out in outs}
    assert len(ptrs) == len(outs)
    # the poses differ, and so do their frames
    assert not torch.equal(outs[0]["rgb1"], outs[1]["rgb1"])


@pytest.mark.card
@pytest.mark.parametrize("form", ["served_504x378", "served_1008x756",
                                  "int8_504x378"])
def test_new_params_capture_once_and_render_them(card, form):
    render, sc, scene = renderer_of(form, card)
    a, b = params_of(3, card), params_of(4, card)
    c2w = poses_of(sc, 1)[0]
    for _ in range(3):
        render(a, scene, c2w)
    before = events()
    got = [render(b, scene, c2w) for _ in range(3)]
    torch.cuda.synchronize()
    assert moved(before) == {"graph_captures": 1, "frame_eager": 1,
                             "frame_replays": 2}
    want = body(render, b, scene, c2w, card)
    for out in got:
        assert_frames_equal(out, want)
    assert not torch.equal(want["rgb1"],
                           body(render, a, scene, c2w, card)["rgb1"])


@pytest.mark.card
@pytest.mark.parametrize("form", ["served_504x378", "transposed_504x378"])
def test_a_replaced_scene_tensor_captures_again(card, form):
    render, sc, scene = renderer_of(form, card)
    params = params_of(3, card)
    c2w = poses_of(sc, 1)[0]
    for _ in range(3):
        render(params, scene, c2w)
    # the source views moved by one pixel: the same keys, a new images
    # tensor
    other = dict(scene, images=torch.roll(scene["images"], 1, dims=2))
    before = events()
    got = [render(params, other, c2w) for _ in range(3)]
    torch.cuda.synchronize()
    assert moved(before) == {"graph_captures": 1, "frame_eager": 1,
                             "frame_replays": 2}
    want = body(render, params, other, c2w, card)
    for out in got:
        assert_frames_equal(out, want)
    assert not torch.equal(want["rgb1"],
                           body(render, params, scene, c2w, card)["rgb1"])


@pytest.mark.card
@pytest.mark.parametrize("form", ["served_1008x756", "tiled_1008x756"])
def test_device_counters_run_the_frame_eagerly(card, form):
    from pronerf_tpu_torch.utils import profiling

    render, sc, scene = renderer_of(form, card)
    params = params_of(3, card)
    c2w = poses_of(sc, 1)[0]
    for _ in range(3):  # the graph is there
        render(params, scene, c2w)
    before = events()
    with profiling.tracing(counters=True):
        got = render(params, scene, c2w)
        counted = profiling.read_device_counters()
    assert moved(before) == {"graph_captures": 0, "frame_eager": 1,
                             "frame_replays": 0}
    assert counted["gather_in_image"] > 0  # the windowed gather counted
    assert_frames_equal(got, body(render, params, scene, c2w, card))
    before = events()
    render(params, scene, c2w)
    assert moved(before) == {"graph_captures": 0, "frame_eager": 0,
                             "frame_replays": 1}
