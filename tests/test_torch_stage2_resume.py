"""The JAX soak's stage-2 checkpoint (``results/soak/s2/370000.ckpt``:
``fern_epi.txt`` for 500k steps, then ``fern_refine.txt`` for 370k, on
``synthetic:504x378x17``) resumed by the port's ``train/loop.py:
stage2_restore``, on the CPU, held against the JAX package's own reader:

- every tensor of the three trained nets and of the vestigial ``network_fn``
  equals its JAX leaf bit for bit (``w`` transposed);
- so do both Adam states (``opt`` over the three nets, stepped 370,000
  times; ``opt_nerf``, never stepped) and ``global_step``;
- a stage-2 scan chunk resumes from it: the steps 370,001 and 370,002, at
  the learning rate of those steps, advancing ``opt`` alone.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pronerf_tpu.train import checkpoint as j_ckpt
from pronerf_tpu_torch.config import Config
from pronerf_tpu_torch.models.pronerf import init_pronerf_params
from pronerf_tpu_torch.render.raygen import prepare_scene, rays_for_pose
from pronerf_tpu_torch.train.fast_loop import make_scan_executor
from pronerf_tpu_torch.train.loop import stage2_restore
from pronerf_tpu_torch.train.stage2 import init_stage2_state
from pronerf_tpu_torch.train.state import named_params, stage2_lr
from pronerf_tpu_torch.utils.synthetic import make_consistent_scene
from test_torch_checkpoint_jax import assert_tensors_equal, expected_net

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "results/soak/s2/370000.ckpt"
REFINE = ROOT / "configs/llff/fern/fern_refine.txt"


def fresh_state(cfg):
    """The stage-2 state and vestigial NeRF ``run_training`` makes before
    it resumes (the release widths of ``fern_refine.txt``)."""
    def nets(seed):
        return init_pronerf_params(
            torch.Generator().manual_seed(seed), N_samples=cfg.N_samples,
            N_point_ray_enc=cfg.N_point_ray_enc,
            num_neighbor=cfg.num_neighbor, mmnetdepth=cfg.mmnetdepth,
            mmnetwidth=cfg.mmnetwidth, device="cpu")

    return init_stage2_state(nets(0), cfg.weight_decay), nets(1)["nerf"]


@pytest.fixture(scope="module")
def resumed():
    cfg = Config.from_file(REFINE)
    state, vestigial = stage2_restore(CKPT, *fresh_state(cfg))
    return j_ckpt.load_checkpoint(CKPT), state, vestigial


@pytest.mark.parametrize("key,net", [
    ("network_fine", "nerf"), ("mmr_network_fn", "sampler"),
    ("refine_net", "refine"), ("network_fn", None)])
def test_nets_resume_bit_for_bit(resumed, key, net):
    raw, state, vestigial = resumed
    module = vestigial if net is None else state["params"][net]
    got = {k: v.detach() for k, v in module.state_dict().items()}
    assert_tensors_equal(got, expected_net(raw[key]), key)


@pytest.mark.parametrize("key,opt,count", [
    ("optimizer_state_dict", "opt", 370000),
    ("optimizer_nerf", "opt_nerf", 0)])
def test_optimizers_resume_bit_for_bit(resumed, key, opt, count):
    raw, state, _ = resumed
    adam = raw[key]
    assert isinstance(adam, dict)  # no weight decay: plain scale_by_adam
    assert state[opt]["count"] == int(adam["count"]) == count
    for part in ("mu", "nu"):
        tree = adam[part]
        if "nerf" in tree:
            want = {f"{net}.{n}": v for net in ("nerf", "sampler", "refine")
                    for n, v in expected_net(tree[net]).items()}
        else:
            want = {f"nerf.{n}": v for n, v in expected_net(tree).items()}
        assert_tensors_equal(state[opt][part], want, f"{key}.{part}")
    if count:  # the trained moments are not zero
        assert any(v.abs().sum() > 0 for v in state[opt]["nu"].values())


def test_global_step_resumes(resumed):
    raw, state, _ = resumed
    assert state["global_step"] == int(raw["global_step"]) == 370000
    assert isinstance(state["global_step"], int)


def test_a_scan_chunk_resumes_at_step_370000():
    """Two joint steps through the scan executor from the resumed state on
    a small batch of the soak's scene: the steps' learning rates are those
    of steps 370,001 and 370,002, ``opt`` advances by two and ``opt_nerf``
    not at all, every net moves, and the loss is that of a trained scene."""
    cfg = Config.from_file(REFINE, N_rand=64)
    state, _ = stage2_restore(CKPT, *fresh_state(cfg))
    before = {k: v.detach().clone()
              for k, v in named_params(state["params"]).items()}
    nerf_mu = {k: v.clone() for k, v in state["opt_nerf"]["mu"].items()}
    H, W = 378, 504  # the soak's scene, at the size it was trained at
    sc = make_consistent_scene(n_views=17, H=H, W=W, focal=0.875 * W,
                               seed=0)
    train = [i for i in range(17) if i % 8]
    K = sc["K"]
    scene = prepare_scene(sc["images"][train], sc["poses"][train], K,
                          device="cpu")
    # 16 pixels of each training view (a pool of 224 rays)
    pick = torch.randperm(H * W, generator=torch.Generator().manual_seed(1))
    pick = pick[:16]
    rows = []
    for v in train:
        rays = rays_for_pose(H, W, K, sc["poses"][v], device="cpu")
        rgb = torch.as_tensor(sc["images"][v]).reshape(-1, 3)
        rows.append(torch.stack([rays["or_o"], rays["or_d"], rgb], 1)[pick])
    pool = torch.cat(rows)
    ids = torch.arange(len(train), dtype=torch.int32).repeat_interleave(16)
    executor = make_scan_executor(cfg, H, W, float(K[0, 0]), len(train),
                                  2, 2)
    state, metrics = executor(state, scene, pool, ids, 0, 12345)
    assert state["global_step"] == 370002
    assert state["opt"]["count"] == 370002 and state["opt_nerf"]["count"] == 0
    lrs = np.float32(stage2_lr(np.array([370000.0, 370001.0]), cfg.lrate,
                               cfg.lrate_decay))
    assert executor.buf["lr"].numpy().tolist() == lrs.tolist()
    assert executor.buf["adam_count"].tolist() == [370001.0, 370002.0]
    after = named_params(state["params"])
    for net in ("nerf.", "sampler.", "refine."):
        assert any(not torch.equal(after[k], v) for k, v in before.items()
                   if k.startswith(net)), net
    assert all(torch.equal(state["opt_nerf"]["mu"][k], v)
               for k, v in nerf_mu.items())
    # the trained nets render the scene they were trained on: over 40 dB
    # on these rays (read 2.26e-6, 56.5 dB)
    assert 0.0 < float(metrics["mean_loss"]) < 1e-4
