"""Shared serving-path parameter packing: the kernel panels are built once,
when a renderer is built, not once a frame."""

from __future__ import annotations

import torch


def pack_serving_params(params, statics):
    """Return ``params`` augmented with the pre-packed kernel panels the
    serving configuration of ``statics`` will consume.

    - ``nerf_packed`` whenever the fused NeRF kernel is on;
    - ``sampler_packed`` / ``refine_packed`` when the MinMax nets run as
      fused kernels too (bf16 + no mmnetskips: the fold precondition).

    No-op (returns ``params`` unchanged) outside the kernel serving path or
    when the panels are already present. The int8 panels and the transposed
    graph's permuted refine panels are not ported yet.
    """
    if not statics.use_kernels or "nerf_packed" in params:
        return params
    from pronerf_tpu_torch.kernels.fused_minmax import pack_minmax_params
    from pronerf_tpu_torch.kernels.fused_nerf import pack_nerf_params

    if statics.quant != "none" or statics.transposed:
        raise NotImplementedError(
            "quant='int8' and transposed=True are not ported to "
            "pronerf_tpu_torch yet"
        )
    pdt = (
        torch.bfloat16 if statics.compute_dtype == "bfloat16"
        else torch.float32
    )
    params = dict(params, nerf_packed=pack_nerf_params(params["nerf"], pdt))
    if statics.compute_dtype == "bfloat16" and not statics.mmnetskips:
        params["sampler_packed"] = pack_minmax_params(
            params["sampler"], statics.N_point_ray_enc, pdt
        )
        params["refine_packed"] = pack_minmax_params(
            params["refine"], statics.N_samples, pdt
        )
    return params
