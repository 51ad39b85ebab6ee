"""Depth-sample manipulation on the deterministic path: sorting with
payloads, NDC<->3D depth, per-sample bin constraints.

The stage-1 exploration machinery of the JAX module (``explore_expand``,
``gap_jitter``) and ``sample_pdf`` belong to the training slice and are not
here yet.
"""

from __future__ import annotations

import torch


def sort_with_payloads(keys, *payloads):
    """Ascending STABLE sort of ``keys`` along the last axis, carrying each
    payload through the same permutation. Stability matters on the bf16
    path, where two of a ray's depths can be equal: equal keys keep their
    order, and so do their payloads."""
    keys, order = torch.sort(keys, dim=-1, stable=True)
    return (keys,) + tuple(torch.gather(p, -1, order) for p in payloads)


def ndc_to_3d_depth(z_ndc, eps: float):
    """NDC depth in [0, 1) -> 3D camera-space depth 1 / (1 - z - eps).

    eps is stage-dependent (1e-6 stage 1; 1e-5 stage 2 / inference) and
    matters numerically near the far plane, so it is an explicit argument.
    """
    return 1.0 / (1.0 - z_ndc - eps)


def bin_constrain(depths_sorted, refine_sig, near, far):
    """Constrain refined depths to per-sample bins around the sorted sampler
    depths: bin s spans [midpoint(s-1, s), midpoint(s, s+1)] with the first /
    last bins half-open toward near / far.

    Args:
      depths_sorted: [N, S] sorted sampler depths.
      refine_sig: [N, S] refine-net sigmoids in (0, 1).
      near, far: scalars (or [N, 1]).

    Returns: [N, S] refined depths, one inside each bin.
    """
    mids = 0.5 * (depths_sorted[..., 1:] + depths_sorted[..., :-1])
    upper = torch.cat([mids, 0.5 * (far + depths_sorted[..., -1:])], dim=-1)
    lower = torch.cat([0.5 * (near + depths_sorted[..., :1]), mids], dim=-1)
    return lower + (upper - lower) * refine_sig
