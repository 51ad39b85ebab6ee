"""Shared serving-path parameter packing: the kernel panels are built once,
when a renderer is built, not once a frame."""

from __future__ import annotations

import torch


def pack_serving_params(params, statics):
    """Return ``params`` augmented with the pre-packed kernel panels the
    serving configuration of ``statics`` will consume.

    - ``nerf_packed`` whenever the fused NeRF kernel is on, or
      ``nerf_packed_q`` (the int8 panels) with ``quant='int8'``;
    - ``sampler_packed`` / ``refine_packed`` when the MinMax nets run as
      fused kernels too (bf16 + no mmnetskips: the fold precondition), and
      with ``transposed`` also ``refine_packed_t``, whose first-layer rows
      are permuted to the transposed graph's (v, c, s) feature order.

    No-op (returns ``params`` unchanged) outside the kernel serving path or
    when the panels are already present.
    """
    if not statics.use_kernels or "nerf_packed" in params \
            or "nerf_packed_q" in params:
        return params
    from pronerf_tpu_torch.kernels.fused_minmax import pack_minmax_params
    from pronerf_tpu_torch.kernels.fused_nerf import pack_nerf_params

    pdt = (
        torch.bfloat16 if statics.compute_dtype == "bfloat16"
        else torch.float32
    )
    if statics.quant == "int8":
        from pronerf_tpu_torch.kernels.fused_nerf_q import (
            pack_nerf_params_int8,
        )

        params = dict(
            params, nerf_packed_q=pack_nerf_params_int8(params["nerf"])
        )
    else:
        params = dict(
            params, nerf_packed=pack_nerf_params(params["nerf"], pdt)
        )
    if statics.compute_dtype == "bfloat16" and not statics.mmnetskips:
        params["sampler_packed"] = pack_minmax_params(
            params["sampler"], statics.N_point_ray_enc, pdt
        )
        params["refine_packed"] = pack_minmax_params(
            params["refine"], statics.N_samples, pdt
        )
        if statics.transposed:
            from pronerf_tpu_torch.models.pronerf_t import (
                refine_rest_row_perm,
            )

            params["refine_packed_t"] = pack_minmax_params(
                params["refine"], statics.N_samples, pdt,
                rest_row_perm=refine_rest_row_perm(
                    statics.num_neighbor, statics.N_samples
                ),
            )
    return params
