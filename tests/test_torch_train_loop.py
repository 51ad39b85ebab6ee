"""The port's trainer end to end on the CPU: ``run_training`` for a few
steps of each stage with its expdir, the port's checkpoints (round trip,
resume, the stage-2 bootstrap, serving through ``run_inference``), and what
raises by name (a JAX msgpack checkpoint the port cannot map, a missing
capture); ``scan_steps > 1`` is held in tests/test_torch_fast_loop.py. The spiral video of ``i_video`` is held in
tests/test_torch_video.py.

Small nets (NeRF 3 x 32, sampler and refine 2 x 32), 64 rays a step, the
24x18 synthetic scene of 9 views. On the CPU every run is deterministic, so
a resumed run must equal the uninterrupted one exactly.
"""

import numpy as np
import pytest
import torch

from pronerf_tpu_torch.config import Config
from pronerf_tpu_torch.render.infer import load_params_for_inference
from pronerf_tpu_torch.train import checkpoint as ckpt_mod
from pronerf_tpu_torch.train.loop import run_training
from pronerf_tpu_torch.train.state import named_params

torch.set_num_threads(2)

SMALL = dict(datadir="synthetic:24x18x9", N_rand=64, netdepth=3, netwidth=32,
             mmnetdepth=2, mmnetwidth=32, i_print=1, i_weights=1000,
             i_img=0, i_testset=0, i_video=0, tile_rays=0)


def cfg_of(stage, basedir, **kw):
    """A release config at small widths; stage 2 without the config's
    pretrain_path (a checkpoint of the reference's) unless one is given."""
    name = "fern_epi.txt" if stage == 1 else "fern_refine.txt"
    extra = {} if stage == 1 else {"pretrain_path": ""}
    return Config.from_file(f"configs/llff/fern/{name}", basedir=str(basedir),
                            expname=f"s{stage}", **(SMALL | extra | kw))


def params_of(state):
    return {k: v.detach().clone() for k, v in
            named_params(state["params"]).items()}


def test_stage1_then_stage2_write_port_checkpoints(tmp_path, capsys):
    state1, exp1 = run_training(cfg_of(1, tmp_path, max_steps=4, i_img=2),
                                1, device="cpu")
    assert state1["global_step"] == 4
    assert state1["opt_nerf"]["count"] == 2 and state1["opt_s"]["count"] == 2
    names = sorted(p.name for p in exp1.iterdir())
    assert {"000004.ckpt", "args.txt", "config.txt", "metrics.jsonl",
            "imgs"} <= set(names)
    png = (exp1 / "imgs" / "test0_000004.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    ck = ckpt_mod.load_checkpoint(exp1 / "000004.ckpt")
    assert set(ck) == {"format", "global_step", "network_fn",
                       "mmr_network_fn", "refine_net", "optimizer",
                       "s_optimizer"}
    assert isinstance(ck["global_step"], int) and ck["global_step"] == 4
    assert all(v.device.type == "cpu" for v in ck["network_fn"].values())
    assert set(ck["optimizer"]["mu"]) == {
        f"nerf.{k}" for k in ck["network_fn"]}

    # stage 2 bootstraps from the stage-1 expdir (its newest checkpoint)
    state2, exp2 = run_training(
        cfg_of(2, tmp_path, max_steps=3, i_testset=3,
               pretrain_path=str(exp1)), 2, device="cpu")
    out = capsys.readouterr().out
    assert "Saved test set" in out and "Iter: 3" in out
    ck2 = ckpt_mod.load_checkpoint(exp2 / "000003.ckpt")
    assert set(ck2) == {"format", "global_step", "network_fn",
                        "network_fine", "mmr_network_fn", "refine_net",
                        "optimizer_state_dict", "optimizer_nerf"}
    assert ck2["optimizer_state_dict"]["count"] == 3
    assert ck2["optimizer_nerf"]["count"] == 0   # never stepped
    # the stage-2 nets started from the stage-1 weights, then trained
    assert not torch.equal(ck2["network_fine"]["pts.0.weight"],
                           ck["network_fn"]["pts.0.weight"])
    assert not torch.equal(ck2["network_fn"]["pts.0.weight"],
                           ck2["network_fine"]["pts.0.weight"])
    assert (exp2 / "testset_000003" / "000.png").exists()

    # serving reads the port's checkpoint: network_fine, then the MinMax nets
    # (the fused kernels need the release widths; on the card chip_smoke.py
    # serves a trained checkpoint through them)
    from pronerf_tpu_torch.render.infer import run_inference

    cfg_i = Config.from_file(
        "configs/llff/fern/fern_trt.txt", basedir=str(tmp_path),
        expname="serve", ft_path=str(exp2 / "000003.ckpt"),
        **{k: v for k, v in SMALL.items() if k.startswith(("net", "mm"))},
        datadir=SMALL["datadir"], tile_rays=0, use_trt=True)
    capsys.readouterr()
    result = run_inference(cfg_i, device="cpu")
    assert "Loading weights from" in capsys.readouterr().out
    params = load_params_for_inference(cfg_i.ft_path, cfg_i, "cpu")
    assert torch.equal(params["nerf"].pts[0].weight,
                       ck2["network_fine"]["pts.0.weight"])
    assert torch.equal(params["sampler"].layers[0].weight,
                       ck2["mmr_network_fn"]["layers.0.weight"])
    assert np.all(np.isfinite(result["rgbs1"]))
    # a stage-1 checkpoint serves its network_fn
    p1 = load_params_for_inference(exp1 / "000004.ckpt", cfg_i, "cpu")
    assert torch.equal(p1["nerf"].pts[0].weight,
                       ck["network_fn"]["pts.0.weight"])


@pytest.mark.parametrize("stage", [1, 2])
def test_resume_continues_the_run_exactly(tmp_path, stage):
    whole, _ = run_training(cfg_of(stage, tmp_path / "a", max_steps=5),
                            stage, device="cpu")
    first, exp = run_training(cfg_of(stage, tmp_path / "b", max_steps=3),
                              stage, device="cpu")
    assert first["global_step"] == 3
    resumed, _ = run_training(cfg_of(stage, tmp_path / "b", max_steps=2),
                              stage, device="cpu")
    assert resumed["global_step"] == 5
    want, got = params_of(whole), params_of(resumed)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    opt = "opt_s" if stage == 1 else "opt"
    assert resumed[opt]["count"] == whole[opt]["count"]
    for k, v in whole[opt]["nu"].items():
        assert torch.equal(resumed[opt]["nu"][k], v), k


def test_checkpoint_round_trip_and_atomic_write(tmp_path):
    state = {"global_step": 7, "net": {"w": torch.arange(6.).reshape(2, 3)},
             "opt": {"count": 3, "mu": {"a": torch.ones(2)}}}
    path = ckpt_mod.save_checkpoint(tmp_path / "x" / "000007.ckpt", state)
    assert not list((tmp_path / "x").glob("*.tmp"))
    back = ckpt_mod.load_checkpoint(path)
    assert back["global_step"] == 7 and isinstance(back["global_step"], int)
    assert torch.equal(back["net"]["w"], state["net"]["w"])
    assert back["opt"]["count"] == 3
    assert ckpt_mod.latest_checkpoint(tmp_path / "x") == path
    assert ckpt_mod.checkpoint_path(tmp_path, 12).endswith("000012.ckpt")
    assert ckpt_mod.latest_checkpoint(tmp_path / "none") is None


def test_jax_msgpack_checkpoint_raises_by_name(tmp_path):
    """A JAX checkpoint is read (tests/test_torch_checkpoint_jax.py); one
    whose layout the port cannot map raises, naming the key."""
    import jax.numpy as jnp

    from pronerf_tpu.train.checkpoint import save_checkpoint as j_save

    path = tmp_path / "000001.ckpt"
    j_save(path, {"global_step": jnp.int32(1),
                  "network_fn": {"w": jnp.ones((2, 2))}})
    with pytest.raises(ValueError, match="'network_fn'"):
        ckpt_mod.load_checkpoint(path)
    from pronerf_tpu_torch.render.infer import run_inference

    cfg = Config.from_file("configs/llff/fern/fern_trt.txt",
                           datadir="synthetic:24x18x9", basedir=str(tmp_path),
                           ft_path=str(path), tile_rays=0)
    with pytest.raises(ValueError, match="JAX checkpoint key 'network_fn'"):
        run_inference(cfg, device="cpu")


def test_what_is_not_ported_raises_before_any_step(tmp_path):
    # scan_steps > 1 is ported (tests/test_torch_fast_loop.py): a run
    # shorter than a chunk takes the per-step loop and equals a
    # scan_steps = 1 run
    short, _ = run_training(cfg_of(1, tmp_path / "scan", max_steps=2,
                                   scan_steps=4), 1, device="cpu")
    plain, _ = run_training(cfg_of(1, tmp_path / "plain", max_steps=2), 1,
                            device="cpu")
    assert short["global_step"] == plain["global_step"] == 2
    for k, v in params_of(plain).items():
        assert torch.equal(params_of(short)[k], v), k
    # the LLFF loader is ported (tests/test_torch_cli.py trains on a
    # capture); a missing capture raises, naming it
    with pytest.raises(FileNotFoundError, match="data/nerf_llff_data/fern"):
        run_training(cfg_of(1, tmp_path, max_steps=2,
                            datadir="data/nerf_llff_data/fern"), 1,
                     device="cpu")
    # nothing was trained or saved
    assert not list((tmp_path / "s1").glob("*.ckpt"))
    # an i_video boundary inside the run no longer raises (the spiral video
    # is ported): one past the last step writes no video
    state, _ = run_training(cfg_of(1, tmp_path, max_steps=1, i_video=5), 1,
                            device="cpu")
    assert state["global_step"] == 1
    assert not list((tmp_path / "s1").glob("spiral_*"))


def test_entry_point_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_training(cfg_of(1, tmp_path, max_steps=1), 1)
