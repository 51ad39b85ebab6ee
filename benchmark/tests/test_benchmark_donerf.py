"""The DoNeRF configuration (``fern_donerf``, cell ``fern_donerf.view_1008``)
on the CPU at a small size: the plain DoNeRF reference against the port's
DoNeRF frame, planted faults read not correct, the cell's readers on a
hand-built trace, and the configuration's statics as ``infer --use-trt``
serves ``netarch = donerf``."""

import types

import numpy as np
import pytest
import torch

import harness
import run
import work
import work_donerf
from reference import donerf as rdonerf
from reference import msgpack
from reference import pronerf as ref
from reference import scene as rscene

CELL = "fern_donerf.view_1008"
CKPT_S2 = harness.ROOT / "results/soak/s2/370000.ckpt"


@pytest.fixture(scope="module")
def small():
    from pronerf_tpu_torch.convert import params_from_numpy
    from pronerf_tpu_torch.render.raygen import prepare_scene

    H, W, views = 36, 48, [1, 2, 3, 4]
    tree = msgpack.read_checkpoint(CKPT_S2)
    nets = {"nerf": rdonerf.draw_weights(0),
            "sampler": tree["mmr_network_fn"], "refine": tree["refine_net"]}
    sc = rscene.synthetic_scene(17, H, W, seed=0, views=views)
    c2w = rscene.spiral(sc["poses"], sc["bds"])[37].astype(np.float32)
    c2w[:, 3] += 0.01
    return {
        "H": H, "W": W, "sc": sc, "c2w": c2w, "nets": nets,
        "P": rdonerf.weights_from_tree(*nets.values()),
        "params": params_from_numpy(nets),
        "scene": prepare_scene(sc["images"], sc["poses"][views], sc["K"],
                               pack_corners="u8", device="cpu"),
        "rsc": {"images": torch.from_numpy(sc["images"]),
                "poses": torch.from_numpy(sc["poses"][views]), "K": sc["K"]},
    }


def _frames(small, statics):
    from pronerf_tpu_torch.render.renderer import make_frame_renderer

    H, W, sc = small["H"], small["W"], small["sc"]
    render = make_frame_renderer(statics, H, W, sc["K"], 0, device="cpu")
    got = render(small["params"], small["scene"], small["c2w"])
    want = rdonerf.render_frame(small["P"], small["rsc"],
                                torch.from_numpy(small["c2w"]), H, W,
                                sc["K"], block=500)
    return got, want


def test_draw_weights_is_the_ports_donerf_shape():
    from pronerf_tpu_torch.models.donerf import DoNeRFMLP

    tree = rdonerf.draw_weights(0)
    shapes = [p["w"].shape for p in tree["layers"]]
    assert shapes == [(63, 256)] + [(256, 256)] * 6 + [(283, 4)]
    net = DoNeRFMLP()
    assert [tuple(lin.weight.shape[::-1]) for lin in net.layers] == shapes
    assert all(not p["b"].any() for p in tree["layers"])
    # N(0, 2 / fan_in), and the same arrays from the same seed
    w = tree["layers"][3]["w"]
    assert abs(w.std() - np.sqrt(2 / 256)) < 0.01 * np.sqrt(2 / 256) * 10
    again = rdonerf.draw_weights(0)
    assert all(np.array_equal(a["w"], b["w"])
               for a, b in zip(tree["layers"], again["layers"]))


@pytest.mark.parametrize("edit", [{}, {"netdepth": 5, "netwidth": 32,
                                       "skip_layer": 2, "outputs": 6}])
def test_configuration_drives_the_drawn_net(edit):
    """The cell's net is drawn in the form the configuration states, so an
    edit of its ``widths`` or ``donerf`` block changes what runs: the
    release's 8 x 256 with the view features at layer 7 as it stands, and
    any other form it is edited to."""
    from traffic import viewer_donerf

    config = harness.load_json("configs", "fern_donerf")
    for key, v in edit.items():
        config["widths" if key.startswith("net") else "donerf"][key] = v
    D, W = config["widths"]["netdepth"], config["widths"]["netwidth"]
    skip, out = config["donerf"]["skip_layer"], config["donerf"]["outputs"]
    if not edit:
        assert (D, W, skip, out) == (8, 256, 7, 4)
    want = [(63 if i == 0 else W) + (27 if i == skip else 0)
            for i in range(D)]
    shapes = [p["w"].shape for p in viewer_donerf.draw_donerf(config)
              ["layers"]]
    assert shapes == list(zip(want, [W] * (D - 1) + [out]))


def test_reference_frame_equals_the_ports_kernel_free_f32_frame(small):
    """The port's DoNeRF frame without kernels in float32 against the plain
    reference, on every output. Both compute the same products in f32 with
    TF32 off and differ in the order of the sums: 2e-5 on the refine and
    sampler outputs and depth0 (reference.pronerf's bound for the same
    nets), 1e-4 on rgb1 and depth, which pass through the DoNeRF net, whose
    Kaiming weights (std sqrt(2 / fan_in)) carry a last-bit difference of
    the top PE octave (2^9 x) into logits of a few units (the bound of
    tests/test_torch_donerf.py on sigma is 2e-4 for the same reason)."""
    from pronerf_tpu_torch.models.pronerf import RenderStatics

    got, want = _frames(small, RenderStatics.infer(netarch="donerf"))
    tol = {"rgb1": 1e-4, "depth": 1e-4}
    for k in ref.FRAME_KEYS:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=tol.get(k, 2e-5), err_msg=k)


def test_served_frame_passes_its_limits_and_the_control_fails_them(small):
    """The configuration's statics (bf16, the kernels' plain versions on the
    CPU) read under the cell's limits; the reference in float8 (the
    control) over at least one of them."""
    from pronerf_tpu_torch.models.pronerf import RenderStatics
    from traffic.viewer import rms_errors

    limits = harness.load_json("workloads", CELL)["limits"]
    config = harness.load_json("configs", "fern_donerf")
    got, want = _frames(small, RenderStatics.infer(**config["statics"]))
    served = rms_errors([got], [want])
    assert all(served[k] <= limits[k] for k in limits), served
    control = rms_errors(
        [rdonerf.render_frame(small["P"], small["rsc"],
                              torch.from_numpy(small["c2w"]), small["H"],
                              small["W"], small["sc"]["K"], block=500,
                              quant=ref.fp8)], [want])
    assert any(control[k] > limits[k] for k in limits), control


def test_served_statics_are_the_infer_verbs():
    """The configuration's statics are what ``infer --use-trt`` serves with
    ``fern_trt.txt`` and ``netarch = donerf``: the kernels on."""
    from pronerf_tpu_torch.config import Config
    from pronerf_tpu_torch.models.pronerf import RenderStatics
    from pronerf_tpu_torch.render.infer import _infer_statics

    config = harness.load_json("configs", "fern_donerf")
    cfg = Config.from_file(harness.ROOT / config["source_config"],
                           use_trt=True, use_pallas=True, tile_rays=0,
                           netarch="donerf")
    statics = _infer_statics(cfg, use_bf16=True)
    assert statics == RenderStatics.infer(**config["statics"])
    assert statics.use_kernels and statics.netarch == "donerf"
    assert cfg.tile_rays == config["tile_rays"]
    for key, value in config["widths"].items():
        assert getattr(cfg, key) == value, key


# ------------------------------------------------------ planted faults --

def small_cell():
    cell = harness.load_json("workloads", CELL)
    cell["params"].update(height=36, width=48, check_frames=2,
                          warmup_frames=1, reference_block=1024)
    return cell


def plant(monkeypatch, fault):
    """One fault in the program: the frame of another pose, the direction
    term of the head left out, the density corrections left out of the
    composite, or the view features entering at layer 4 (the reference's
    DoNeRF with that skip, its weights drawn from the same seed, in the
    program's place)."""
    from pronerf_tpu_torch.kernels import fused_nerf
    from pronerf_tpu_torch.models import pronerf
    from pronerf_tpu_torch.render import renderer

    if fault == "no_direction":
        real_vc = pronerf.view_contribution
        monkeypatch.setattr(pronerf, "view_contribution",
                            lambda *a: torch.zeros_like(real_vc(*a)))
    elif fault == "no_mm":
        real_comp = fused_nerf.fused_donerf_composite_t

        def comp(packed, pts, dcon, z, mm_add, mm_mul, *a, **kw):
            return real_comp(packed, pts, dcon, z, torch.zeros_like(mm_add),
                             torch.ones_like(mm_mul), *a, **kw)

        monkeypatch.setattr(fused_nerf, "fused_donerf_composite_t", comp)
    elif fault in ("other_pose", "view_at_layer_4"):
        real = renderer.make_frame_renderer
        config = harness.load_json("configs", "fern_donerf")

        def make(statics, H, W, K, *a, **kw):
            render = real(statics, H, W, K, *a, **kw)

            def broken(params, scene, c2w):
                if fault == "other_pose":
                    c2w = c2w.copy()
                    c2w[:, 3] += 0.05
                    return render(params, scene, c2w)
                sc = rscene.synthetic_scene(17, H, W, seed=0,
                                            views=[1, 2, 3, 4])
                tree = msgpack.read_checkpoint(harness.ROOT
                                               / config["weights"])
                P = rdonerf.weights_from_tree(
                    rdonerf.draw_weights(config["donerf_seed"], skip=4),
                    tree["mmr_network_fn"], tree["refine_net"])
                rsc = {"images": torch.from_numpy(sc["images"]),
                       "poses": torch.from_numpy(sc["poses"][[1, 2, 3, 4]]),
                       "K": sc["K"]}
                return rdonerf.render_frame(P, rsc, torch.from_numpy(c2w), H,
                                            W, K, block=1024, skip=4)

            return broken

        monkeypatch.setattr(renderer, "make_frame_renderer", make)


@pytest.mark.parametrize("fault", [None, "other_pose", "no_direction",
                                   "no_mm", "view_at_layer_4"])
def test_viewer_donerf(monkeypatch, fault):
    if fault:
        plant(monkeypatch, fault)
    outcome, _, _ = run.run_cell(CELL, 2**35 + 3, 0.3, False, "cpu",
                                 small_cell())
    assert outcome.correct is (fault is None), harness.checks_line(
        outcome.checks)


# ------------------------------------------------------------- readers --

def fake_trace():
    """Two frames of 10 ms: the DoNeRF kernel, a MinMax kernel and a gather
    each, 1 ms idle at each frame's start, a copy at each end."""
    kernels, copies, spans = [], [], []
    for f in range(2):
        t = f * 10_000.0
        spans += [("frame", t, 10_000.0), ("render_frame", t, 3_000.0)]
        kernels += [("void pn::donerf_wg_kernel<true>(pn::NerfArgs)",
                     t + 1_000, 4_000),
                    ("pn::minmax_wg_kernel<false>(float const*)", t + 5_000,
                     2_000),
                    ("at::native::index_elementwise_kernel", t + 7_000,
                     2_500)]
        copies.append(("Memcpy DtoH", t + 9_500, 500))
    return harness.Trace(kernels, copies, spans, 0.0, 20_000.0, 2)


def test_readers_on_a_known_trace():
    """The cell's readers on ``fake_trace``, where the DoNeRF kernel takes
    exactly its bound and a frame 10 ms; the NeRF kernel's reader does not
    take the DoNeRF kernel for its own."""
    cell = harness.load_json("workloads", CELL)
    config = harness.load_json("configs", "fern_donerf")
    p, st = cell["params"], config["statics"]
    rays, S = p["height"] * p["width"], st["N_samples"]
    bound = work.roofline_s(*work_donerf.donerf_kernel(rays, S))
    tr = fake_trace()
    tr.kernels = [(n, s, bound * 1e6 if "donerf" in n else d)
                  for n, s, d in tr.kernels]
    outcome = types.SimpleNamespace(
        trace=tr, run=types.SimpleNamespace(cell=cell, config=config,
                                            spans=harness.Spans()))

    def read(name):
        return harness.load_module("metrics", name).read(outcome)

    assert read("donerf_roofline") == pytest.approx(100.0)
    assert read("nerf_roofline") is None
    assert tr.kernel_us(("nerf_wg_kernel",)) == 0.0
    macs = work_donerf.pipeline_macs(p["height"], p["width"])
    assert read("frame_mfu.donerf") == pytest.approx(
        100 * 2 * sum(macs.values()) / 0.01 / 989e12)
    outcome.trace = fake_trace()
    assert read("device_idle.donerf") == pytest.approx(10.0)
    empty = types.SimpleNamespace(trace=None, run=outcome.run)
    for name in ("donerf_roofline", "frame_mfu.donerf", "device_idle.donerf"):
        assert harness.load_module("metrics", name).read(empty) is None


def test_donerf_work_counts():
    assert work_donerf.DONERF_KERNEL_MACS == 410_368
    assert work_donerf.DONERF_POINT_MACS == 410_368 + 27 * 4
    macs = work_donerf.pipeline_macs(756, 1008)
    nerf = work.pipeline_macs(756, 1008)
    assert macs["sampler"] == nerf["sampler"]
    assert macs["refine"] == nerf["refine"]
    assert macs["nerf"] == 756 * 1008 * 8 * (410_368 + 108)
    ops, nbytes = work_donerf.donerf_kernel(762_048)
    assert ops == 2 * 410_368 * 762_048 * 8
    # the bound is the operations': 5.06 ms at 989 TFLOP/s
    assert work.roofline_s(ops, nbytes) == pytest.approx(ops / 989e12)
    assert ops / 989e12 == pytest.approx(5.06e-3, rel=0.01)
