"""The frozen reference against the port's plain path on the CPU: the
checkpoint reader, the scene, and the frame at a small size. The reference
imports nothing of the port; these tests do, to hold it."""

import numpy as np
import pytest
import torch

import harness
from reference import msgpack
from reference import pronerf as ref
from reference import scene as rscene

CKPT_S2 = harness.ROOT / "results/soak/s2/370000.ckpt"


def test_checkpoint_reader_matches_the_ports():
    from pronerf_tpu_torch.train import checkpoint as ck

    data = CKPT_S2.read_bytes()
    ours = msgpack.read_checkpoint(CKPT_S2)
    theirs = ck.relistify(ck.msgpack_restore(data))

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b))

    same(ours, theirs)


@pytest.mark.parametrize("views", [None, [1, 2, 3, 4], [0, 16]])
def test_scene_matches_the_ports_generator(views):
    from pronerf_tpu_torch.utils.synthetic import make_consistent_scene

    want = make_consistent_scene(n_views=17, H=30, W=40, focal=35.0, seed=0)
    got = rscene.synthetic_scene(17, 30, 40, seed=0, views=views)
    idx = list(range(17)) if views is None else views
    assert np.array_equal(got["images"], want["images"][idx])
    assert np.array_equal(got["poses"], want["poses"])
    assert np.array_equal(got["K"], want["K"])


def test_spiral_matches_the_loaders():
    from pronerf_tpu_torch.data import llff

    sc = rscene.synthetic_scene(17, 30, 40, seed=0, views=[])
    hwf = np.tile(np.array([30.0, 40.0, 35.0], np.float32)[None, :, None],
                  (17, 1, 1))
    poses = np.concatenate([sc["poses"], hwf], 2)
    want = np.stack(llff._spiral_from_poses(poses, sc["bds"]))[:, :, :4]
    np.testing.assert_allclose(rscene.spiral(sc["poses"], sc["bds"]), want,
                               rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def small():
    from pronerf_tpu_torch.convert import params_from_numpy
    from pronerf_tpu_torch.render.raygen import prepare_scene

    H, W, views = 36, 48, [1, 2, 3, 4]
    tree = msgpack.read_checkpoint(CKPT_S2)
    nets = (tree["network_fine"], tree["mmr_network_fn"], tree["refine_net"])
    sc = rscene.synthetic_scene(17, H, W, seed=0, views=views)
    c2w = rscene.spiral(sc["poses"], sc["bds"])[37].astype(np.float32)
    c2w[:, 3] += 0.01
    return {
        "H": H, "W": W, "sc": sc, "c2w": c2w,
        "P": ref.weights_from_tree(*nets),
        "params": params_from_numpy(dict(zip(("nerf", "sampler", "refine"),
                                             nets))),
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
    want = ref.render_frame(small["P"], small["rsc"],
                            torch.from_numpy(small["c2w"]), H, W, sc["K"],
                            block=500)
    return got, want


def test_reference_frame_equals_the_ports_f32_path(small):
    """The port without kernels in float32 computes what the reference
    does, up to the order of f32 sums."""
    from pronerf_tpu_torch.models.pronerf import RenderStatics

    got, want = _frames(small, RenderStatics.infer())
    for k in ref.FRAME_KEYS:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=2e-5, err_msg=k)


def test_served_statics_are_the_infer_verbs():
    """The configuration's statics are what ``infer --use-trt`` serves
    with ``fern_trt.txt``."""
    from pronerf_tpu_torch.config import Config
    from pronerf_tpu_torch.models.pronerf import RenderStatics
    from pronerf_tpu_torch.render.infer import _infer_statics

    config = harness.load_json("configs", "fern_trt")
    cfg = Config.from_file(harness.ROOT / config["source_config"],
                           use_trt=True, use_pallas=True, tile_rays=0)
    assert _infer_statics(cfg, use_bf16=True) == \
        RenderStatics.infer(**config["statics"])
    assert cfg.tile_rays == config["tile_rays"]
    for key, value in config["widths"].items():
        assert getattr(cfg, key) == value, key


def test_served_frame_passes_its_limits_and_the_control_fails_them(small):
    """At a small size on the CPU (the kernels' plain versions, bf16): the
    served frame reads under the cell's limits, the reference in float8
    (the control) over at least one of them."""
    from pronerf_tpu_torch.models.pronerf import RenderStatics
    from traffic.viewer import rms_errors

    limits = harness.load_json("workloads", "fern_trt.view_1008")["limits"]
    config = harness.load_json("configs", "fern_trt")
    got, want = _frames(small, RenderStatics.infer(**config["statics"]))
    served = rms_errors([got], [want])
    assert all(served[k] <= limits[k] for k in limits), served
    control = rms_errors(
        [ref.render_frame(small["P"], small["rsc"],
                          torch.from_numpy(small["c2w"]), small["H"],
                          small["W"], small["sc"]["K"], block=500,
                          quant=ref.fp8)], [want])
    assert any(control[k] > limits[k] for k in limits), control
