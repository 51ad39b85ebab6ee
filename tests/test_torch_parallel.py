"""Ray-sharded training and serving over ``torch.distributed``
(``pronerf_tpu_torch/parallel/``): a world of two ranks over gloo on the CPU
against a world of one and against the JAX package's sharded renderer.

The ranks are spawned processes (``parallel/launch.py:spawn``) that run
``tests/torch_parallel_ranks.py:cases`` (jax-free: the children import
torch and the port only); the rendezvous is a file under the test's
temporary directory, so that parallel test workers never share a port.
Every group has a 60 s timeout and the ranks a join deadline: a rendezvous
that hangs fails this file, within its limit. The ranks run once for the
whole file; the world of one is the same ``cases`` in this process, with
no process group.

Fixture: the 20x24 scene of the JAX package's parallel tests (6 views),
small nets (``torch_train_common.NETS``) for training and the release nets
for the frame (the kernels' widths), a batch of 128 rays of its pool, and
JAX params carried across.

Tolerances. World two against world one: loss ``rtol 1e-5`` and weights
``atol 2e-6``, the JAX package's own bounds for its sharded step against
its single-device step (``tests/test_parallel.py:75-79``): the two worlds
differ only in how the batch mean is summed (two half means averaged, or
one mean) and in the gradients' sum. The sharded frame against the world
of one: ``atol 2e-6`` (``tests/test_parallel.py:354``); each ray is
computed by the same code either way. The port's sharded frame against
JAX's (``make_sharded_frame_renderer`` on ``make_ray_mesh(2)``, f32, the
kernels' plain versions against JAX's interpret mode): the bounds of the
port's single-device frame against JAX's (``tests/test_torch_render.py``:
``atol 5e-5``, depth ``5e-4``), since the two frameworks sum the f32
products in another order. The multi-scene step over a scene a rank equals
the world of one bit for bit (each scene's step is the same computation);
over ray shards, the data-parallel bounds above.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pronerf_tpu.models import RenderStatics as JStatics
from pronerf_tpu.models import init_pronerf_params as j_init
from pronerf_tpu.parallel import make_ray_mesh as j_make_ray_mesh
from pronerf_tpu.parallel import (
    make_sharded_frame_renderer as j_make_sharded_renderer,
)
from pronerf_tpu.render import prepare_scene as j_prepare_scene
from pronerf_tpu.utils.synthetic import make_scene
from pronerf_tpu_torch.parallel import launch
from pronerf_tpu_torch.render.raygen import build_ray_pool
from pronerf_tpu_torch.train import checkpoint as t_ckpt
from torch_train_common import NETS, as_numpy, configs
import torch_parallel_ranks
from torch_jax_pe import jax_kernels_with_f32_pe  # noqa: F401 (autouse: f32 PE)

torch.set_num_threads(2)

WORLD, N_RAND = 2, 128
DEADLINE_S = 90
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-6
FRAME_ATOL = 2e-6
JAX_ATOL = {"depth": 5e-4, "depth0": 5e-4}


def _inputs():
    sc = make_scene(n_views=6, H=20, W=24, seed=0)
    H, W, focal = sc["hwf"]
    jparams = as_numpy(j_init(jax.random.PRNGKey(0), **NETS))
    pool, ids = build_ray_pool(sc["images"], sc["poses"], sc["K"],
                               list(range(6)), 4, np.random.default_rng(0))
    rng = np.random.default_rng(3)

    def noise(width, n=N_RAND):
        return torch.from_numpy(rng.standard_normal((n, width),
                                                    dtype=np.float32))

    base = {"n_mult": 2, "dir_expand": True, "dir_jitter": False,
            "neighbor_subset": torch.tensor([0, 1, 2, 3]),
            "target_t": torch.zeros(3), "rng": None}
    _, cfg = configs(N_rand=N_RAND)
    _, multi_cfg = configs(N_rand=64, i_print=1, i_weights=3, i_testset=2,
                           max_steps=3, max_images=1, expname="multi",
                           tile_rays=0)
    src = [0, 2, 3, 4, 5]  # a held-out target pose (tests/test_torch_render)
    return {
        "cfg": cfg, "H": H, "W": W, "focal": focal, "K": sc["K"],
        "images": sc["images"], "poses": sc["poses"], "params": jparams,
        # the kernels' nets are the release widths (8 x 256, 6 x 256)
        "frame_params": as_numpy(j_init(jax.random.PRNGKey(0))),
        "batch": pool[:N_RAND], "ids": ids[:N_RAND],
        "controls1": dict(base, raw_noise=noise(64), jitter_noise=noise(64)),
        "controls_s": dict(base),
        "controls2": dict(base, raw_noise=noise(8), jitter_noise=noise(8)),
        "src_images": sc["images"][src], "src_poses": sc["poses"][src],
        "target": sc["poses"][1][:3, :4],
        "multi_batch": np.stack([pool[N_RAND:2 * N_RAND],
                                 pool[2 * N_RAND:3 * N_RAND]]),
        "multi_ids": np.stack([ids[N_RAND:2 * N_RAND],
                               ids[2 * N_RAND:3 * N_RAND]]),
        "multi_noise": [{"raw_noise": noise(64), "jitter_noise": noise(64)}
                        for _ in range(2)],
        "multi_cfg": multi_cfg,
        "multi_datadirs": ["synthetic:24x18x6"] * 2,
    }


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The cases in a world of one (this process) and of two (spawned
    gloo ranks, joined by a deadline): ``(inputs, one, [rank0, rank1],
    dirs)``."""
    root = tmp_path_factory.mktemp("parallel")
    inp = _inputs()
    torch.save(inp, root / "inputs.pt")
    (root / "w1").mkdir()
    (root / "w2").mkdir()
    torch.set_num_threads(torch_parallel_ranks.THREADS)
    one = torch_parallel_ranks.cases(inp, root / "w1")
    launch.spawn(torch_parallel_ranks.run, WORLD, f"file://{root}/pg",
                 (str(root / "inputs.pt"), str(root / "w2")),
                 deadline_s=DEADLINE_S)
    two = [torch.load(root / "w2" / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    return inp, one, two, {"w1": root / "w1", "w2": root / "w2"}


def _close_params(got, want, atol=PARAM_ATOL):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("case", ["stage1_nerf", "stage1_sampler", "stage2"])
def test_data_parallel_steps_equal_the_single_process_step(worlds, case):
    inp, one, two, _ = worlds
    for rank in two:  # every rank holds the whole batch's update
        np.testing.assert_allclose(rank[case]["loss"], one[case]["loss"],
                                   rtol=LOSS_RTOL)
        _close_params(rank[case]["params"], one[case]["params"])
    # the step moved the params by about lr (Adam's first step)
    p0 = torch_parallel_ranks._named(torch_parallel_ranks._params(inp))
    moved = max(float((v - p0[k]).abs().max())
                for k, v in two[0][case]["params"].items())
    assert 0.5 * torch_parallel_ranks.LR < moved <= 2.5 * \
        torch_parallel_ranks.LR


def test_uneven_batch_raises(worlds):
    _, one, two, _ = worlds
    assert all(r["uneven_raised"] for r in two)
    assert not one["uneven_raised"]  # any batch splits over one rank


def test_sharded_frame_equals_single_process_and_jax(worlds):
    inp, one, two, _ = worlds
    st = one["frame_statics"]
    assert (st.gather_tiles, st.gather_window_rows) == (4, 8)
    for rank in two:  # every rank returns the whole frame
        for k, v in one["frame"].items():
            np.testing.assert_allclose(rank["frame"][k].numpy(), v.numpy(),
                                       atol=FRAME_ATOL, rtol=0, err_msg=k)
    # JAX's sharded renderer on a 2-device mesh, the same statics
    jst = JStatics.infer(compute_dtype=None, use_pallas=True,
                         gather_tiles=4, gather_window_rows=8)
    jscene = j_prepare_scene(inp["src_images"], inp["src_poses"], inp["K"],
                             pack_corners="u8")
    jrender = j_make_sharded_renderer(jst, inp["H"], inp["W"], inp["K"],
                                      j_make_ray_mesh(2))
    jparams = jax.tree_util.tree_map(jnp.asarray, inp["frame_params"])
    want = jrender(jparams, jscene, jnp.asarray(inp["target"]))
    for k, v in want.items():
        np.testing.assert_allclose(two[0]["frame"][k].numpy(), np.asarray(v),
                                   atol=JAX_ATOL.get(k, 5e-5), rtol=0,
                                   err_msg=k)


def test_multi_scene_step_over_ranks_equals_one_process(worlds):
    _, one, two, _ = worlds
    # a scene a rank: each rank holds its own scene's step, bit for bit
    for rank, res in enumerate(two):
        assert list(res["multi_rows"]) == [rank]
        want = one["multi_rows"][rank]
        assert res["multi_rows"][rank]["loss"] == want["loss"]
        _close_params(res["multi_rows"][rank]["params"], want["params"],
                      atol=0)
    assert one["multi_rows"][0]["loss"] != one["multi_rows"][1]["loss"]
    # each scene's batch over both ranks: the data-parallel bounds
    for res in two:
        assert list(res["multi_shards"]) == [0, 1]
        for s in (0, 1):
            np.testing.assert_allclose(res["multi_shards"][s]["loss"],
                                       one["multi_shards"][s]["loss"],
                                       rtol=LOSS_RTOL)
            _close_params(res["multi_shards"][s]["params"],
                          one["multi_shards"][s]["params"])


def test_multi_scene_training_over_ranks_equals_one_process(worlds):
    _, one, two, dirs = worlds
    assert one["loop_names"] == two[0]["loop_names"] == [
        "synthetic0", "synthetic1"]
    for name in one["loop_names"]:
        ck1, ck2 = (t_ckpt.latest_checkpoint(dirs[w] / "multi" /
                                             f"scene_{name}")
                    for w in ("w1", "w2"))
        assert ck1.endswith("000003.ckpt") and ck2.endswith("000003.ckpt")
        a, b = t_ckpt.load_checkpoint(ck1), t_ckpt.load_checkpoint(ck2)
        for key in ("network_fn", "mmr_network_fn", "refine_net"):
            for p, v in a[key].items():
                assert torch.equal(b[key][p], v), (name, key, p)
        assert (dirs["w2"] / "multi" / f"scene_{name}" /
                "testset_000002" / "000.png").exists()


def test_spawn_fails_on_a_rank_that_fails_or_hangs(tmp_path):
    with pytest.raises(RuntimeError, match="exited"):
        launch.spawn(torch_parallel_ranks.fail, 2, f"file://{tmp_path}/a",
                     deadline_s=60)
    with pytest.raises(TimeoutError, match="deadline"):
        launch.spawn(torch_parallel_ranks.hang, 2, f"file://{tmp_path}/b",
                     deadline_s=3)


def test_backend_follows_the_device():
    assert launch.backend_for("cpu") == "gloo"
    assert launch.backend_for("cuda") == "nccl"
    assert launch.world() == (0, 1)  # no group in this process
    with pytest.raises(ValueError, match="init_method"):
        launch.init_group("cpu", world_size=2)
