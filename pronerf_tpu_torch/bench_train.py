"""Training-step benchmark of the port: ms a step of the three training
steps at the fern operating point, ``python -m pronerf_tpu_torch.bench_train``.

The twin of the JAX package's root ``bench_train.py``, with its setup and
its JSON keys: ``fern_epi.txt`` with ``mmnetdepth = 6``; 17 views of
``make_scene(seed=0)`` at 504x378; the ray pool of views 0..15 with 4
neighbours from ``default_rng(0)``, its first 4096 rays; the same controls
(``n_mult = 4``, ``dir_expand``, neighbours ``[0, 1, 2, 3]``); stage 2
built at ``lrate = 3e-4``; every step at lr 5e-4.

Each step kind is timed CHAINED: ``ITERS`` steps, each on the last one's
params and Adam state, from the same initial state every call (the JAX file
records that unchained timing read 2.3x too fast). On the card the chain is
one CUDA graph of the ``ITERS`` steps (``train/fast_loop.capture_step_graph``),
replayed; a call is timed by the host clock to a readback of its losses,
minus the null dispatch, over ``ITERS``, median of 3. The same chain run
eagerly (each kernel launched from the host) goes beside it under the
``*_eager_ms`` keys. The noise is drawn once, from a generator seeded with 1,
and every step reads it, as every JAX step reads the one key of its
controls. Runs on the card; ``--device cpu`` runs the plain versions (for the
tests, at small sizes), where the chain is always eager.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

ITERS = 12
REPS = 3
LR = 5e-4
N_RAND = 4096
H, W, N_VIEWS = 378, 504, 17
NOISE_WIDTH = 64  # the exploration step's sample budget; stage 2 reads S
STEPS = ("stage1_nerf_ms", "stage1_sampler_ms", "stage2_ms")
OPTS = {"stage1_nerf_ms": ("opt_nerf",), "stage1_sampler_ms": ("opt_s",),
        "stage2_ms": ("opt",)}


def configs():
    """``(stage-1 config, stage-2 config)``: ``fern_epi.txt``, and the same
    at ``lrate = 3e-4``."""
    from pronerf_tpu_torch.cli import DEFAULT_STAGE1_CONFIG
    from pronerf_tpu_torch.config import Config

    cfg = Config.from_file(DEFAULT_STAGE1_CONFIG)
    return cfg, cfg.replace(lrate=3e-4)


def data(h=H, w=W, n_views=N_VIEWS, n_rand=N_RAND):
    """The scene and the batch: ``(sc, pool, ids, batch, batch_ids)``
    (numpy; the pool of views ``0 .. n_views - 2``)."""
    from pronerf_tpu_torch.render.raygen import build_ray_pool
    from pronerf_tpu_torch.utils.synthetic import make_scene

    sc = make_scene(n_views=n_views, H=h, W=w, focal=0.8 * w, seed=0)
    pool, ids = build_ray_pool(sc["images"], sc["poses"], sc["K"],
                               list(range(n_views - 1)), 4,
                               np.random.default_rng(0))
    return sc, pool, ids, pool[:n_rand], ids[:n_rand]


def controls(n_rand, device, noise=None):
    """The controls of every step: JAX's host choices, the neighbour subset
    and the target on the device, and the N(0, 1) noise ``[n_rand,
    NOISE_WIDTH]`` (``noise``: ``(raw, jitter)`` to give it, else drawn on
    the device from a generator seeded with 1)."""
    if noise is None:
        gen = torch.Generator(device=device).manual_seed(1)
        noise = tuple(torch.randn(n_rand, NOISE_WIDTH, generator=gen,
                                  device=device) for _ in range(2))
    raw, jit = (torch.as_tensor(n, device=device) for n in noise)
    return {
        "n_mult": 4, "dir_expand": True, "dir_jitter": False,
        "neighbor_subset": torch.tensor([0, 1, 2, 3], device=device),
        "target_t": torch.zeros(3, device=device),
        "raw_noise": raw, "jitter_noise": jit,
    }


def setup(device="cuda", h=H, w=W, n_views=N_VIEWS, n_rand=N_RAND,
          params=None, cfgs=None, noise=None):
    """Everything the chains need: ``{scene, batch, bids, controls, steps,
    params}`` on ``device``; ``steps`` maps each key of ``STEPS`` to
    ``(step function, state initialiser of the params)``. ``params`` default to the
    release widths (``mmnetdepth = 6``) from
    ``torch.Generator().manual_seed(0)``; ``cfgs`` to :func:`configs`."""
    from pronerf_tpu_torch.models.pronerf import init_pronerf_params
    from pronerf_tpu_torch.render.raygen import prepare_scene
    from pronerf_tpu_torch.train.stage1 import (
        init_stage1_state,
        make_stage1_steps,
    )
    from pronerf_tpu_torch.train.stage2 import (
        init_stage2_state,
        make_stage2_step,
    )
    from pronerf_tpu_torch.utils.tensors import resolve_device

    device = resolve_device(device)
    cfg, cfg2 = cfgs or configs()
    sc, _, _, batch, bids = data(h, w, n_views, n_rand)
    focal = 0.8 * w
    nerf, sampler = make_stage1_steps(cfg, h, w, focal)
    stage2 = make_stage2_step(cfg2, h, w, focal)
    if params is None:
        params = init_pronerf_params(torch.Generator().manual_seed(0),
                                     mmnetdepth=6, device=device)
    return {
        "scene": prepare_scene(sc["images"], sc["poses"], sc["K"],
                               device=device),
        "batch": torch.from_numpy(batch).to(device),
        "bids": torch.from_numpy(bids).to(device),
        "controls": controls(batch.shape[0], device, noise),
        "steps": {
            "stage1_nerf_ms": (nerf, lambda p: init_stage1_state(
                p, cfg.weight_decay)),
            "stage1_sampler_ms": (sampler, lambda p: init_stage1_state(
                p, cfg.weight_decay)),
            "stage2_ms": (stage2, lambda p: init_stage2_state(
                p, cfg2.weight_decay))},
        "params": params,
    }


def copy_params(params):
    """A copy of the three nets (each chain starts from its own)."""
    import copy

    return {k: copy.deepcopy(v) for k, v in params.items()}


def chain(step, state, s, iters=ITERS, lr=LR):
    """``iters`` steps of ``step`` from a fresh ``state`` (Adam counts 0),
    each on the last one's params and Adam state (updated in place):
    ``[iters]`` losses on the device. The steps' Adam counts (1, 2, ...)
    come from a device tensor, so that a CUDA graph of the chain holds no
    host count."""
    counts = torch.arange(1, iters + 1, dtype=torch.float32,
                          device=s["batch"].device)
    losses = []
    for j in range(iters):
        ctl = dict(s["controls"], adam_count=counts[j])
        _, m = step(state, s["scene"], s["batch"], s["bids"], ctl, lr)
        losses.append(m["loss"])
    return torch.stack(losses)


def chained_graph(step, state, s, opts, iters=ITERS, lr=LR):
    """A CUDA graph of ``chain`` from ``state`` and the ``[iters]`` buffer
    its replays write the losses to: ``(graph, losses)``. The warm-ups and
    the capture leave ``state`` as it was (``opts``: the optimizers whose
    moments the step updates); each replay runs the chain from the state's
    current values."""
    from pronerf_tpu_torch.train.fast_loop import (
        capture_step_graph,
        state_tensors,
    )

    out = torch.zeros(iters, device=s["batch"].device)
    host = {k: state[k]["count"] for k in opts}
    g0 = state["global_step"]

    def run():
        out.copy_(chain(step, state, s, iters, lr))

    graph = capture_step_graph(run, state_tensors(state, opts))
    state["global_step"] = g0
    for k, c in host.items():
        state[k]["count"] = c
    return graph, out


def _timed(call, restore, null_ms, iters, reps):
    """Per-step ms of ``call()`` (a chain; returns its losses): host clock
    to the readback of its losses, minus ``null_ms``, over ``iters``,
    median of ``reps`` calls after a warm one, each from the restored
    state."""
    from pronerf_tpu_torch.utils.profiling import readback

    restore()
    readback(call())
    times = []
    for _ in range(reps):
        restore()
        t0 = time.perf_counter()
        readback(call())
        times.append((time.perf_counter() - t0) * 1e3)
    return (float(np.median(times)) - null_ms) / iters


def time_step(name, s, null_ms, iters=ITERS, reps=REPS):
    """``(chained ms, eager ms)`` a step of the step kind ``name`` (a key
    of ``STEPS``): on the card the chain as one CUDA graph, replayed, and
    the chain run eagerly; on the CPU both eager."""
    from pronerf_tpu_torch.train.fast_loop import state_tensors
    from pronerf_tpu_torch.utils.profiling import readback

    step, init = s["steps"][name]
    state = init(copy_params(s["params"]))
    mutables = state_tensors(state, OPTS[name])
    saved = [t.detach().clone() for t in mutables]

    def restore():
        with torch.no_grad():
            for t, v in zip(mutables, saved):
                t.copy_(v)
        state["global_step"] = 0
        for k in OPTS[name]:
            state[k]["count"] = 0
        readback(mutables[0].detach())

    def eager():
        return chain(step, state, s, iters)

    eager_ms = _timed(eager, restore, null_ms, iters, reps)
    if s["batch"].device.type != "cuda":
        return eager_ms, eager_ms
    graph, out = chained_graph(step, state, s, OPTS[name], iters)

    def replay():
        graph.replay()
        return out

    return _timed(replay, restore, null_ms, iters, reps), eager_ms


def result_line(chained: dict, eager: dict, device_kind: str,
                n_rand=N_RAND) -> dict:
    """The JSON line of the JAX package's training bench: its keys from the
    chained ms, the eager ms beside them."""
    out = {k: round(chained[k], 3) for k in STEPS}
    alt = (out["stage1_nerf_ms"] + out["stage1_sampler_ms"]) / 2
    return {
        "metric": "fern_stage1_alternating_ms_per_step",
        "value": round(alt, 3),
        "unit": "ms",
        "vs_baseline": None,
        "extra": dict(
            out, n_rand=n_rand,
            full_500k_train_minutes=round(alt * 500e3 / 60e3, 1),
            **{k.replace("_ms", "_eager_ms"): round(eager[k], 3)
               for k in STEPS},
            device_kind=device_kind,
            chained_protocol=f"{ITERS} steps each on the last one's state, "
            "one CUDA graph replayed (the *_eager_ms keys: the same chain "
            "with its kernels launched from the host), host clock to a "
            f"readback minus the null dispatch, over {ITERS}, median of "
            f"{REPS}",
        ),
    }


def main(argv=None):
    from pronerf_tpu_torch.bench import card_name
    from pronerf_tpu_torch.utils.profiling import null_dispatch_ms

    ap = argparse.ArgumentParser(
        prog="python -m pronerf_tpu_torch.bench_train",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default: the CUDA card; raises "
                         "without one)")
    args = ap.parse_args(argv)
    s = setup(args.device)
    null = null_dispatch_ms(s["batch"].device)
    chained, eager = {}, {}
    for name in STEPS:
        chained[name], eager[name] = time_step(name, s, null)
    result = result_line(chained, eager, card_name(args.device))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
