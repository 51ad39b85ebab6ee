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


@torch.no_grad()
def adam_step(state: dict, named: Dict[str, torch.Tensor], grads, lr: float,
              weight_decay: float = 0.0) -> None:
    """One update of ``scale_by_adam`` (after ``add_decayed_weights`` when
    ``weight_decay > 0``) and ``p <- p - lr * u``, for every named parameter
    with its gradient in ``grads`` (same order as ``named``). The moments
    and the parameters are updated in place (the JAX package returns new
    arrays; in place saves a copy of every tensor)."""
    count = state["count"] + 1
    dev = next(iter(named.values())).device
    # the bias corrections in f32, as optax takes decay ** count
    bc1 = 1.0 - torch.tensor(B1, dtype=torch.float32, device=dev) ** count
    bc2 = 1.0 - torch.tensor(B2, dtype=torch.float32, device=dev) ** count
    for (name, p), g in zip(named.items(), grads):
        if weight_decay and weight_decay > 0.0:
            g = g + weight_decay * p
        mu = state["mu"][name]
        nu = state["nu"][name]
        mu.copy_((1.0 - B1) * g + B1 * mu)
        nu.copy_((1.0 - B2) * (g * g) + B2 * nu)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
        p.copy_(p - lr * u)
    state["count"] = count


def stage1_lr(global_step, lrate: float, lrate_decay: int):
    """lrate * 0.1 ** ((global_step / 2) / (lrate_decay * 1000))."""
    return lrate * 0.1 ** ((global_step / 2.0) / (lrate_decay * 1000.0))


def stage2_lr(global_step, lrate: float, lrate_decay: int):
    """lrate * 0.1 ** (global_step / (lrate_decay * 1000))."""
    return lrate * 0.1 ** (global_step / (lrate_decay * 1000.0))
