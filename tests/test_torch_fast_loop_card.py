"""The scan executor's early draws (``train/fast_loop.py``) on the card, at
``fern_refine``'s widths (stage 2: NeRF 8x256, sampler and refine 6x256, 8
samples, 4 neighbours, 4096 rays a step) in chunks of K = 8 CUDA-graph
replays: once a chunk's replays are queued, it draws the next chunk's
controls into a staging copy (queued after the replays), and the next chunk
copies them in.

- two chunks on one executor (the second takes the early draws) equal, bit
  for bit, the same two chunks each drawn at the call (a fresh executor a
  chunk): params, Adam moments, losses, metrics, the chunk's controls; the
  fill counters say which fill each chunk took;
- the early draws (``pn/predraw``) make no host sync:
  ``torch.cuda.set_sync_debug_mode("error")`` around them;
- under ``profiling.tracing()`` each chunk (``pn/chunk``) holds one
  ``pn/key``, the graph key's walk, before its first ``pn/step.joint``.

The scene is synthetic (6 views of 128x96, 73,728 rays in the pool). These
tests need a CUDA card and skip without one; the file imports no JAX. On the
card, from the root of the repo::

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_fast_loop_card.py
"""

import numpy as np
import pytest
import torch

K = 8
SEED = 2**40 + 12345  # larger than 32 bits, as the benchmark's seeds


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


class Setup:
    """``fern_refine``'s stage-2 config at K = 8, the synthetic scene, its
    ray pool on ``device`` and seeded nets at the config's widths."""

    def __init__(self, device, views=6, H=96, W=128):
        from pronerf_tpu_torch.config import Config
        from pronerf_tpu_torch.render.raygen import (
            build_ray_pool,
            prepare_scene,
        )
        from pronerf_tpu_torch.utils.synthetic import make_scene

        self.device = device
        self.cfg = Config.from_file("configs/llff/fern/fern_refine.txt",
                                    scan_steps=K)
        sc = make_scene(n_views=views, H=H, W=W, focal=0.875 * W, seed=0)
        self.H, self.W, self.focal, self.views = H, W, 0.875 * W, views
        self.scene = prepare_scene(sc["images"], sc["poses"], sc["K"],
                                   device=device)
        pool, ids = build_ray_pool(sc["images"], sc["poses"], sc["K"],
                                   list(range(views)), self.cfg.num_neighbor,
                                   np.random.default_rng(0), native=False)
        self.pool = torch.from_numpy(pool).to(device)
        self.ids = torch.from_numpy(ids).to(device)

    def state(self):
        from pronerf_tpu_torch.models.pronerf import init_pronerf_params
        from pronerf_tpu_torch.train.stage2 import init_stage2_state

        c = self.cfg
        params = init_pronerf_params(
            torch.Generator().manual_seed(0), netdepth=c.netdepth,
            netwidth=c.netwidth, mmnetdepth=c.mmnetdepth,
            mmnetwidth=c.mmnetwidth, N_samples=c.N_samples,
            N_point_ray_enc=c.N_point_ray_enc, num_neighbor=c.num_neighbor,
            device=self.device)
        return init_stage2_state(params, c.weight_decay)

    def executor(self):
        from pronerf_tpu_torch.train.fast_loop import make_scan_executor

        return make_scan_executor(self.cfg, self.H, self.W, self.focal,
                                  self.views, 2, K)

    def chunks(self, state, n, ex=None):
        """``n`` consecutive chunks from ``state`` on ``ex`` (a fresh
        executor a chunk where None): (state, last executor, metrics)."""
        for c in range(n):
            run = ex or self.executor()
            state, m = run(state, self.scene, self.pool, self.ids,
                           c * K * self.cfg.N_rand, SEED)
        return state, run, m


def fill_counts():
    from pronerf_tpu_torch.utils.profiling import COUNTERS

    return COUNTERS["fill_predrawn"], COUNTERS["fill_drawn"]


def assert_same_chunks(a, ex_a, m_a, b, ex_b, m_b):
    from pronerf_tpu_torch.train.state import named_params

    assert a["global_step"] == b["global_step"] == 2 * K
    for (k, x), y in zip(named_params(a["params"]).items(),
                         named_params(b["params"]).values()):
        assert torch.equal(x, y), k
    assert a["opt"]["count"] == b["opt"]["count"]
    for part in ("mu", "nu"):
        for k, v in a["opt"][part].items():
            assert torch.equal(v, b["opt"][part][k]), (part, k)
    assert torch.equal(ex_a.buf["losses"], ex_b.buf["losses"])
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k
    for ca, cb in zip(ex_a.chunk_controls(), ex_b.chunk_controls()):
        for k in ca:
            assert torch.equal(torch.as_tensor(ca[k]),
                               torch.as_tensor(cb[k])), k


def predrawn_against_drawn(device):
    s = Setup(device)
    ex = s.executor()
    p0, d0 = fill_counts()
    state, _, m = s.chunks(s.state(), 2, ex)
    assert fill_counts() == (p0 + 1, d0 + 1)
    want, ex_b, m_b = s.chunks(s.state(), 2)
    assert fill_counts() == (p0 + 1, d0 + 3)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    assert_same_chunks(state, ex, m, want, ex_b, m_b)


def strict_predraw(device):
    """Two chunks, each ``pn/predraw`` under the sync debug mode "error":
    a host sync there raises."""
    s = Setup(device)
    ex = s.executor()
    real = ex._predraw

    def predraw(*a):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*a)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    ex._predraw = predraw
    p0, _ = fill_counts()
    _, _, m = s.chunks(s.state(), 2, ex)
    assert fill_counts()[0] == p0 + 1
    assert np.isfinite(float(m["mean_loss"]))


@pytest.mark.card
def test_predrawn_chunks_equal_chunks_drawn_at_the_call(card):
    predrawn_against_drawn(card)


@pytest.mark.card
def test_the_early_draws_make_no_host_sync(card):
    strict_predraw(card)


@pytest.mark.card
def test_each_chunk_holds_one_key_span(card):
    from torch.profiler import ProfilerActivity, profile

    from pronerf_tpu_torch.utils import profiling

    s = Setup(card)
    ex = s.executor()
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            profiling.tracing():
        s.chunks(s.state(), 2, ex)
        torch.cuda.synchronize(card)
    spans = [(e.name[3:], e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("pn/")]
    chunks = [r for r in spans if r[0] == "chunk"]
    assert len(chunks) == 2
    for c in chunks:
        within = sorted((r for r in spans if r is not c
                         and c[1] <= r[1] and r[2] <= c[2]),
                        key=lambda r: r[1])
        keys = [r for r in within if r[0] == "key"]
        assert len(keys) == 1, within
        first_step = next(r for r in within if r[0] == "step.joint")
        assert keys[0][2] <= first_step[1]
