"""Optimizer and LR schedules.

Adam(b1=0.9, b2=0.999, eps=1e-8) with optional L2 weight decay added to the
gradient, and an exponential LR decay applied by the caller every step.
Stage 1 decays on ``global_step / 2`` (both optimizers step every other
iteration); stage 2 decays on ``global_step`` without the halving.

The transform is written out as optax's ``scale_by_adam`` computes it (the
JAX package's optimizer): moments ``(1 - b) * g + b * m``, bias correction
by the step count, ``eps`` OUTSIDE the square root; the learning rate stays
out of it and is applied as ``p - lr * u``. ``torch.optim.Adam`` differs in
where eps enters and ties its state to parameter objects; here the state is
plain tensors keyed by parameter name, so two optimizers may cover
overlapping sets (stage 1: one over the NeRF, one over all three nets).
"""

from __future__ import annotations

from typing import Dict

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def named_params(params: Dict[str, torch.nn.Module], nets=None):
    """``{'<net>.<parameter name>': parameter}`` of ``params`` (the
    ``{'nerf', 'sampler', 'refine'}`` modules), for the nets in ``nets``
    (default: all, in the dict's order)."""
    return {
        f"{net}.{name}": p
        for net in (nets or params) for name, p in
        params[net].named_parameters()
    }


def adam_init(named: Dict[str, torch.Tensor]) -> dict:
    """Zero moments for every named parameter, step count 0."""
    return {
        "count": 0,
        "mu": {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
               for k, p in named.items()},
        "nu": {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
               for k, p in named.items()},
    }


def bias_corrections(count, device):
    """``(1 - b1 ** count, 1 - b2 ** count)`` as 0-d f32 tensors on
    ``device``, optax's ``decay ** count`` in f32. ``count`` is a host int or
    a 0-d f32 tensor there (a captured step's); both go through the same
    tensor ``pow``, so the two forms agree bit for bit."""
    if not torch.is_tensor(count):
        count = torch.full((), float(count), dtype=torch.float32,
                           device=device)
    b1 = torch.full((), B1, dtype=torch.float32, device=device)
    b2 = torch.full((), B2, dtype=torch.float32, device=device)
    return 1.0 - b1 ** count, 1.0 - b2 ** count


@torch.no_grad()
def adam_step(state: dict, named: Dict[str, torch.Tensor], grads, lr,
              weight_decay: float = 0.0, count=None) -> None:
    """One update of ``scale_by_adam`` (after ``add_decayed_weights`` when
    ``weight_decay > 0``) and ``p <- p - lr * u``, for every named parameter
    with its gradient in ``grads`` (same order as ``named``). The moments
    and the parameters are updated in place (the JAX package returns new
    arrays; in place saves a copy of every tensor, and keeps the addresses
    that a captured step reads).

    ``lr`` is a float or a 0-d f32 tensor on the parameters' device;
    ``count`` (default: the state's count + 1) this update's step count, a
    host int or a 0-d f32 tensor there. Either tensor form needs no host
    sync, which a CUDA graph of the step requires. The state's host count
    advances by one either way."""
    dev = next(iter(named.values())).device
    state["count"] += 1
    bc1, bc2 = bias_corrections(state["count"] if count is None else count,
                                dev)
    for (name, p), g in zip(named.items(), grads):
        if weight_decay and weight_decay > 0.0:
            g = g + weight_decay * p
        mu = state["mu"][name]
        nu = state["nu"][name]
        mu.copy_((1.0 - B1) * g + B1 * mu)
        nu.copy_((1.0 - B2) * (g * g) + B2 * nu)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
        p.copy_(p - lr * u)


def stage1_lr(global_step, lrate: float, lrate_decay: int):
    """lrate * 0.1 ** ((global_step / 2) / (lrate_decay * 1000)); a number
    or a tensor of steps (the scan executor evaluates a chunk's steps at
    once, in float64, and hands the steps their f32 values)."""
    return lrate * 0.1 ** ((global_step / 2.0) / (lrate_decay * 1000.0))


def stage2_lr(global_step, lrate: float, lrate_decay: int):
    """lrate * 0.1 ** (global_step / (lrate_decay * 1000))."""
    return lrate * 0.1 ** (global_step / (lrate_decay * 1000.0))
