"""The frozen stage-1 reference against the port's chunk executor on the
CPU (the executor runs its steps eagerly there), at a small batch: the
same draws, and the same losses, moments and parameters after a chunk."""

import numpy as np
import pytest
import torch

import harness
from reference import scene as rscene
from reference import train as rtrain
from traffic import train_chunks


def small_config(n_rand=64):
    config = harness.load_json("configs", "fern_epi")
    config["train"]["N_rand"] = n_rand
    config["scene"].update(height=36, width=48)
    return config


def small_cell():
    cell = harness.load_json("workloads", "fern_epi.train_s1")
    cell["params"].update(reshuffle_after=2, check_within=2)
    return cell


def test_train_config_is_fern_epi_with_scan_steps():
    """The configuration's training fields are ``fern_epi.txt``'s, with
    the ``scan_steps`` it assumes."""
    from pronerf_tpu_torch.config import Config

    config = harness.load_json("configs", "fern_epi")
    cfg = Config.from_file(harness.ROOT / config["source_config"],
                           scan_steps=config["train"]["scan_steps"])
    for key, value in config["train"].items():
        got = getattr(cfg, key)
        assert (list(got) if isinstance(got, tuple) else got) == value, key
    assert "scan_steps" in config["assumed"]


@pytest.mark.parametrize("step", [500001, 500002, 7])
def test_draws_are_the_executors(step):
    from pronerf_tpu_torch.train.fast_loop import draw_device_controls

    want = draw_device_controls(2**40 + 3, step, 14, 4, 8, 32, 64, "cpu")
    got = rtrain.draws(2**40 + 3, step, 14, 4, 8, 32, 64, "cpu")
    for a, b in (("n_mult", "n_mult"), ("dir_expand", "dir_expand"),
                 ("dir_jitter", "dir_jitter"), ("subset", "neighbor_subset"),
                 ("raw_noise", "raw_noise"),
                 ("jitter_noise", "jitter_noise")):
        assert torch.equal(got[a], want[b]), a


@pytest.fixture(scope="module")
def trainer():
    t = train_chunks.Trainer(small_cell(), small_config(), "cpu", 2**33 + 5)
    t.window(0.0)
    t.free()
    return t


def test_first_chunk_equals_the_reference(trainer):
    f = trainer.followed[0]
    got = train_chunks.compare(f["after"], trainer.reference_chunk(f),
                               trainer.K)
    assert got["loss_gap"] < 1e-3 and got["grad_gap_median"] < 1e-3 \
        and got["change_gap_median"] < 1e-3, got


def test_window_chunk_equals_the_reference(trainer):
    """The chunk followed in the window, from the program's state before
    it, on rows the reference works out again from the reshuffles."""
    f = trainer.followed[1]
    got = train_chunks.compare(f["after"], trainer.reference_chunk(f),
                               trainer.K)
    assert got["loss_gap"] < 1e-3 and got["grad_gap_median"] < 1e-3 \
        and got["change_gap_median"] < 1e-3, got


def test_the_window_starts_after_a_reshuffle(trainer):
    """Set-up's first chunk reads the pool's first order from row 0; the
    window's followed chunk comes after the window's reshuffle, at a
    non-zero row."""
    first, window = trainer.followed
    assert first["start"] == 0 and len(first["keys"]) == 1
    assert len(window["keys"]) == 3 and window["start"] > 0
    assert window["start"] == (trainer.check_at - 2) * trainer.stride
    assert window["before"]["step"] == trainer.step0 + trainer.K * (
        trainer.check_at + 1)


def test_leaf_gap_rules():
    want = {"a": torch.ones(4), "b": torch.ones(4) * 2,
            "c": torch.full((4,), 1e-6)}
    got = {"a": torch.ones(4), "b": torch.ones(4) * 3, "c": torch.zeros(4)}
    # c is under a thousandth of the median leaf: left out
    assert train_chunks.leaf_gaps(got, want) == pytest.approx(
        {"a": 0.0, "b": 0.5})
    unchanged = {k: torch.zeros(4) for k in want}
    assert train_chunks.leaf_gaps(unchanged, want) == pytest.approx(
        {"a": 1.0, "b": 1.0})


def test_ray_pool_holds_every_ray_once():
    sc = {"views": 17, "llffhold": 8}
    views = train_chunks.training_views(sc)
    assert views == [i for i in range(17) if i not in (0, 8, 16)]
    images = torch.rand((2, 3, 4, 3), generator=torch.Generator().manual_seed(0))
    poses = torch.eye(3, 4).repeat(2, 1, 1)
    K = np.array([[3.5, 0, 2], [0, 3.5, 1.5], [0, 0, 1]], np.float32)
    pool, ids = train_chunks.ray_pool(images, poses, K)
    assert pool.shape == (24, 3, 3) and ids.tolist() == [0] * 12 + [1] * 12
    assert torch.equal(pool[:, 2], images.reshape(-1, 3))
    o, d = rscene.rays_for_pose(3, 4, K, poses[1])
    assert torch.equal(pool[12:, 0], o) and torch.equal(pool[12:, 1], d)


def test_pool_order_is_the_device_reshuffles():
    """``pool_order`` works out the rows that ``device_reshuffle`` leaves,
    over several reshuffles."""
    from pronerf_tpu_torch.train.fast_loop import device_reshuffle

    pool = torch.arange(50 * 9, dtype=torch.float32).reshape(50, 3, 3)
    ids = torch.arange(50, dtype=torch.int32)
    want = pool.clone()
    keys = [2**62 + 1, 17, 2**40 + 9]
    for key in keys:
        device_reshuffle(pool, ids, key)
    order = train_chunks.pool_order(50, keys, "cpu")
    assert torch.equal(pool, want[order]) and torch.equal(ids, order.int())
