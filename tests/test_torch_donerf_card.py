"""The DoNeRF kernel (``csrc/fused_nerf.cu:donerf_wg_kernel``, the radiance
net of ``netarch = donerf``) on the card:

- each form (raw, composite) against its plain version on the same inputs,
  at the rays of a 504x378 and of a 1008x756 frame, 8 and 16 samples a ray,
  seeded weights at the kernel's widths (D 8, W 256);
- the composite form against ``ops.composite`` of the raw form's output;
- a replayed DoNeRF frame (``render/renderer.py``'s CUDA graph) equal to the
  eager frame body bit for bit;
- ``COUNTERS["donerf_launches"]``: one for an eager frame, and
  ``infer --use-trt`` (``render/infer.py:run_inference``) serving DoNeRF
  through the kernel.

Bounds, kernel against plain version: both round at the same points, but
an f32 sum taken in another order can land on the other side of a bf16
boundary and later layers carry it on. Kaiming weights keep the raw logits
near their inputs' size, a few units, so the bound on raw is relative to
the plain output's largest magnitude: 1% (chip_smoke's 0.02 on heads of
size ~1, the NeRF kernel's; measured on an H100: one bf16 step, 0.023 to
0.031 of 4.2). The composited values are held element by element at 0.005
(weights sum to at most 1; disp relative to its size, 5%) on all but a
share of 1e-4 of them: the last sample's interval is 1e10, so its alpha is
a step in the sign of sigma + mm_add, and where a bf16 step of sigma
crosses zero there a ray's last weight jumps between 0 and its
transmittance. Composite against ``ops.composite`` of the raw form: the
same raw values, f32 arithmetic in another order, 1e-5.

These tests need a CUDA card and skip without one; the file imports no JAX.
On the card, from the root of the repo::

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_donerf_card.py
"""

import dataclasses
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
CHUNK = 16384   # rays a call of a plain version
RAYS = {"504x378": 190512, "1008x756": 762048}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def seeded_donerf(seed, device):
    from pronerf_tpu_torch.models.donerf import init_donerf

    net = init_donerf(torch.Generator().manual_seed(seed), device=device)
    with torch.no_grad():
        for i, lin in enumerate(net.layers):  # zero at init: make them count
            b = torch.rand(lin.bias.shape,
                           generator=torch.Generator().manual_seed(i))
            lin.bias.copy_((0.2 * b - 0.1).to(device))
    return net


def inputs(n_rays, S, device, seed):
    from pronerf_tpu_torch.ops.encoding import positional_encoding

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)

    dirs = rng.standard_normal((n_rays, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return {
        "pts24_t": t(rng.uniform(-1, 1, (S * 3, n_rays))),
        "d_pe": positional_encoding(t(dirs), 4),
        "z_t": t(np.sort(rng.random((S, n_rays)), axis=0)),
        "mm_add_t": t(rng.standard_normal((S, n_rays))),
        "mm_mul_t": t(rng.random((S, n_rays))),
        "dnorm_t": t(1.0 + rng.random((1, n_rays))),
    }


def cols(a, i):
    return a[:, i:i + CHUNK].contiguous()


@pytest.mark.card
@pytest.mark.parametrize("S", [8, 16])
@pytest.mark.parametrize("frame", list(RAYS))
def test_kernel_equals_its_plain_version(card, frame, S):
    from pronerf_tpu_torch.kernels import fused_nerf as fn
    from pronerf_tpu_torch.models.pronerf import view_contribution
    from pronerf_tpu_torch.ops.composite import composite

    n = RAYS[frame]
    net = seeded_donerf(S, card)
    packed = fn.pack_donerf_params(net)
    x = inputs(n, S, card, seed=S)
    aux = [x[k] for k in ("z_t", "mm_add_t", "mm_mul_t", "dnorm_t")]
    with torch.no_grad():
        dcon = view_contribution(net, x["d_pe"], torch.bfloat16).contiguous()
        raw = fn.fused_donerf_raw_t(packed, x["pts24_t"], dcon, S)
        comp = fn.fused_donerf_composite_t(packed, x["pts24_t"], dcon, *aux,
                                           S)
        plain_raw = torch.cat([
            fn.fused_donerf_raw_plain(packed, cols(x["pts24_t"], i),
                                      cols(dcon, i), S)
            for i in range(0, n, CHUNK)])
        parts = [fn.fused_donerf_composite_plain(
            packed, cols(x["pts24_t"], i), cols(dcon, i),
            *[cols(a, i) for a in aux], S) for i in range(0, n, CHUNK)]
    torch.cuda.synchronize()
    plain = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    size = float(plain_raw.abs().max())
    assert size > 0.5 and torch.isfinite(raw).all()
    err = float((raw - plain_raw).abs().max())
    assert err <= 0.01 * size, (err, size)
    for k in ("rgb", "depth", "acc", "weights"):
        d = (comp[k] - plain[k]).abs()
        share = float((d > 0.005).float().mean())
        assert float(plain[k].abs().max()) > 0 and share <= 1e-4, \
            (k, share, float(d.max()))
    assert float((comp["sigma"] - plain["sigma"]).abs().max()) <= 0.01 * size
    fin = torch.isfinite(plain["disp"])
    assert float((fin != torch.isfinite(comp["disp"])).float().mean()) <= 1e-4
    both = fin & torch.isfinite(comp["disp"])
    rel = ((comp["disp"] - plain["disp"]).abs() / plain["disp"].abs())[both]
    assert float((rel > 0.05).float().mean()) <= 1e-4

    # the composite form is the raw form's chain composited in f32
    assert torch.equal(comp["sigma"], raw[..., 3])
    ndc_d = torch.cat([x["dnorm_t"].T, torch.zeros(n, 2, device=card)], -1)
    ref = composite(raw, x["z_t"].T, ndc_d, mm_add=x["mm_add_t"].T,
                    mm_mul=x["mm_mul_t"].T)
    for k in ("rgb", "depth", "acc", "weights"):
        e = float((comp[k] - ref[k]).abs().max())
        assert e <= 1e-5, (k, e)


def served(card, H=378, W=504):
    """The DoNeRF configuration's statics (``benchmark/configs/
    fern_donerf.json``), a renderer of an H x W frame, the synthetic scene
    and seeded nets on the card."""
    from pronerf_tpu_torch.models.pronerf import (
        RenderStatics,
        init_pronerf_params,
    )
    from pronerf_tpu_torch.render.raygen import prepare_scene
    from pronerf_tpu_torch.render.renderer import make_frame_renderer
    from pronerf_tpu_torch.utils.synthetic import make_scene

    config = json.loads((ROOT / "benchmark/configs/fern_donerf.json")
                        .read_text())
    statics = RenderStatics.infer(**config["statics"])
    assert statics.netarch == "donerf" and statics.use_kernels
    sc = make_scene(n_views=5, H=H, W=W, focal=0.875 * W, seed=3)
    ref = [0, 2, 3, 4]
    scene = prepare_scene(sc["images"][ref], sc["poses"][ref], sc["K"],
                          pack_corners="u8", device=card)
    params = init_pronerf_params(torch.Generator().manual_seed(3),
                                 netarch="donerf", device=card)
    render = make_frame_renderer(statics, H, W, sc["K"], 0, device=card)
    return render, sc, scene, params


def poses_of(sc, n):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        c2w = sc["poses"][1][:3, :4].astype(np.float32).copy()
        c2w[:, 3] += rng.uniform(-0.01, 0.01, 3).astype(np.float32)
        out.append(c2w)
    return out


def counters():
    from pronerf_tpu_torch.utils.profiling import COUNTERS

    return {k: COUNTERS[k] for k in ("donerf_launches",
                                     "nerf_composite_launches",
                                     "nerf_raw_launches", "frame_eager",
                                     "frame_replays", "graph_captures")}


def moved(before):
    return {k: v - before[k] for k, v in counters().items()}


@pytest.mark.card
@pytest.mark.parametrize("size", [(378, 504), (756, 1008)])
def test_replayed_frame_equals_the_eager_body(card, size):
    from pronerf_tpu_torch.utils.tensors import as_f32

    render, sc, scene, params = served(card, *size)
    poses = poses_of(sc, 4)
    before = counters()
    with torch.no_grad():
        eager = render.frame(render.pack(params), scene,
                             as_f32(poses[0], card))
    torch.cuda.synchronize()
    # an eager frame launches the DoNeRF kernel once, and no NeRF kernel
    assert moved(before) == dict.fromkeys(before, 0) | {"donerf_launches": 1}
    outs = [render(params, scene, c2w) for c2w in poses]
    torch.cuda.synchronize()
    got = moved(before)
    assert (got["graph_captures"], got["frame_eager"],
            got["frame_replays"]) == (1, 1, len(poses) - 1)
    assert got["nerf_composite_launches"] == got["nerf_raw_launches"] == 0
    for c2w, out in zip(poses, outs):
        with torch.no_grad():
            want = render.frame(render.pack(params), scene, as_f32(c2w, card))
        for k in want:
            assert torch.equal(out[k].view(torch.uint8),
                               want[k].contiguous().view(torch.uint8)), k
    assert torch.equal(outs[0]["rgb1"], eager["rgb1"])
    assert not torch.equal(outs[0]["rgb1"], outs[1]["rgb1"])


@pytest.mark.card
def test_infer_use_trt_serves_donerf_through_the_kernel(card):
    from pronerf_tpu_torch.config import Config
    from pronerf_tpu_torch.render import infer

    with tempfile.TemporaryDirectory(prefix="donerf_card_") as tmp:
        cfg = Config.from_file(
            ROOT / "configs/llff/fern/fern_trt.txt",
            datadir="synthetic:504x378x17", use_trt=True, tile_rays=0,
            use_pallas=True, basedir=tmp, ft_path="", netarch="donerf",
            max_images=1)
        statics = infer._infer_statics(cfg, use_bf16=True)
        assert statics.use_kernels and statics.netarch == "donerf"
        before = counters()
        result = infer.run_inference(cfg)
    torch.cuda.synchronize()
    got = moved(before)
    # one pose, one eager frame: one launch of the DoNeRF kernel
    assert got["donerf_launches"] == got["frame_eager"] == 1
    assert got["nerf_composite_launches"] == got["nerf_raw_launches"] == 0
    assert np.isfinite(result["rgbs1"]).all()
    assert dataclasses.asdict(statics)["quant"] == "none"
