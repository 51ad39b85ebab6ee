"""The serving render pipeline in fully TRANSPOSED layout: rays on the minor
axis, samples / features on the major one, end to end.

Counterpart of ``pronerf_tpu/models/pronerf_t.py``. The row-major serving
pipeline (``models.pronerf.render_rays`` with ``use_kernels``) already runs
the three MLPs as kernels that take transposed inputs; here everything
BETWEEN them keeps the kernels' layout too:

- the sampler / refine kernels return their native ``[out_rows, N]`` panels
  (``fused_minmax_t(transpose_out=False)``) and the heads are ROW slices;
- the depth sort runs along the sample axis (dim 0), stable, payloads
  carried along;
- the epipolar gather emits (v, c, s)-ordered feature rows directly
  (``ops.warp.epipolar_colors_shared_t``); the refine net's first-layer rows
  are permuted to match at pack time (``pack_minmax_params(rest_row_perm=
  ...)``);
- compositing streams inside the fused NeRF kernel
  (``fused_nerf_composite_t``), whose ``[S, N]`` aux inputs are native here:
  no raw ``[N, S, 4]`` is ever written.

Semantics: EXACTLY the deterministic inference branch
(``RenderStatics.infer``): shared nearest views, density corrections always,
no noise, clamp or jitter. Everything else keeps ``render_rays``.
"""

from __future__ import annotations

import torch

from pronerf_tpu_torch.models.pronerf import (
    RenderStatics,
    _nearest_views,
    pack_serving_params,
    render_rays,
    view_contribution,
)
from pronerf_tpu_torch.ops.encoding import positional_encoding
from pronerf_tpu_torch.ops.sampling import ndc_to_3d_depth
from pronerf_tpu_torch.ops.warp import (
    epipolar_colors_shared_t,
    is_u8_pack,
    mean_fill_invalid_t,
)
from pronerf_tpu_torch.utils.profiling import span


def transposed_eligible(statics: RenderStatics, images) -> bool:
    """True when ``render_rays_t`` implements these statics exactly: the
    deterministic kernel serving branch over a u8-packed scene."""
    return (
        statics.use_kernels
        and not statics.randomize
        and not statics.explore
        and not statics.jitter
        and statics.use_mm
        and not statics.clamp_raw
        and statics.noise_std == 0.0
        and statics.add_offsets
        and statics.epi_layout == "vsc"
        and not statics.mmnetskips
        and statics.netarch == "nerf"
        and is_u8_pack(images)
    )


def graph_for(statics: RenderStatics, images):
    """The graph a ray slab of ``statics`` runs over ``images``: this
    module's ``render_rays_t`` with ``transposed`` where it implements the
    statics exactly (:func:`transposed_eligible`), else
    ``models.pronerf.render_rays``. The frame renderers call it."""
    if statics.transposed and transposed_eligible(statics, images):
        return render_rays_t
    return render_rays


def refine_rest_row_perm(num_neighbor: int, n_samples: int):
    """Permutation mapping the transposed pipeline's (v, c, s) epipolar
    feature rows onto the refine net's (v, s, c) input rows."""
    return [
        v * n_samples * 3 + s * 3 + c
        for v in range(num_neighbor)
        for c in range(3)
        for s in range(n_samples)
    ]


def _bin_constrain_t(depths_sorted, refine_sig, near, far):
    """Dim-0 twin of ``ops.sampling.bin_constrain`` ([S, N] panels)."""
    mids = 0.5 * (depths_sorted[1:] + depths_sorted[:-1])
    upper = torch.cat([mids, 0.5 * (far + depths_sorted[-1:])], dim=0)
    lower = torch.cat([0.5 * (near + depths_sorted[:1]), mids], dim=0)
    return lower + (upper - lower) * refine_sig


def _plucker_t(o_t, d_t):
    """[6, N] Pluecker signature [d_hat, o x d_hat] from [3, N] rows (twin
    of ``ops.encoding.plucker`` on the ray origin)."""
    n = torch.sqrt(torch.sum(d_t * d_t, dim=0, keepdim=True))
    dh = d_t / n.clamp_min(1e-12)
    m = torch.stack(
        [
            o_t[1] * dh[2] - o_t[2] * dh[1],
            o_t[2] * dh[0] - o_t[0] * dh[2],
            o_t[0] * dh[1] - o_t[1] * dh[0],
        ],
        dim=0,
    )
    return torch.cat([dh, m], dim=0)


def render_rays_t(params, rays, scene, controls, statics: RenderStatics):
    """Transposed-serving twin of ``models.pronerf.render_rays``.

    Same (params, rays, scene, controls) contract and the same output dict;
    numerics match the row-major serving graph (the kernels' arithmetic is
    the same; the refine product sums its input rows in a permuted order, a
    bounded float reassociation). The stages carry ``render_rays``' spans,
    but for ``composite``, which runs inside the NeRF kernel here.
    """
    from pronerf_tpu_torch.kernels.fused_minmax import fused_minmax_t
    from pronerf_tpu_torch.kernels.fused_nerf import fused_nerf_composite_t

    if not transposed_eligible(statics, scene["images"]):
        raise ValueError(
            "render_rays_t implements the deterministic kernel serving "
            "branch over a u8-packed scene only (see transposed_eligible)"
        )
    params = pack_serving_params(params, statics)
    S = statics.N_samples
    V = statics.num_neighbor
    near, far = statics.near, statics.far
    kdt = (torch.bfloat16 if statics.compute_dtype == "bfloat16"
           else torch.float32)

    ndc_o_t = rays["ndc_o"].T.contiguous()  # [3, N]
    ndc_d_t = rays["ndc_d"].T.contiguous()
    or_o_t = rays["or_o"].T.contiguous()
    or_d_t = rays["or_d"].T.contiguous()
    n_rays = ndc_o_t.shape[1]

    # 1. Sampler on the folded Pluecker signature (collinearity fold: the
    # 48-point signature is 48 copies of one 6-vector).
    with span("sampler"):
        sig_t = _plucker_t(ndc_o_t, ndc_d_t)  # [6, N]
        # [out_pad, N]; heads are ROW slices
        mm_out = fused_minmax_t(params["sampler_packed"], sig_t,
                                transpose_out=False)
        mm_rgb_t = torch.sigmoid(mm_out[3 * S: 3 * S + 3])  # [3, N]
        depth_t = torch.sigmoid(mm_out[:S]) * (far - near) + near  # [S, N]
        mm_add_t = mm_out[S: 2 * S]
        mm_mul_t = mm_out[2 * S: 3 * S]

    # 2. Stable sort of the depths along the sample axis, the density
    # corrections carried through the same permutation.
    with span("sort"):
        depth_t, order = torch.sort(depth_t, dim=0, stable=True)
        mm_add_t = torch.gather(mm_add_t, 0, order)
        mm_mul_t = torch.gather(mm_mul_t, 0, order)
        z3d_t = ndc_to_3d_depth(depth_t, statics.ndc_eps)

    # 3. Shared-view epipolar gather, transposed; (v, c, s) feature rows.
    with span("gather"):
        nearest = _nearest_views(statics, scene, controls)
        colors_t = epipolar_colors_shared_t(
            scene["images"], scene["fused_mats"], scene["K"], nearest,
            or_o_t, or_d_t, z3d_t,
            n_tiles=max(statics.gather_tiles, 0),
            window_rows=statics.gather_window_rows,
        )  # [V, 3, S, N]
        colors_t = mean_fill_invalid_t(colors_t)
        epi_t = colors_t.reshape(V * 3 * S, n_rays)

    # 4. Refine net; first-layer rows permuted to the (v, c, s) order.
    with span("refine"):
        refine_out = fused_minmax_t(
            params["refine_packed_t"], torch.cat([sig_t, epi_t], dim=0),
            transpose_out=False,
        )  # [out_pad, N]
        refine_sig_t = torch.sigmoid(refine_out[:S])                # [S, N]
        refine_rgb_t = torch.sigmoid(refine_out[4 * S: 4 * S + 3])  # [3, N]
        po_rows = refine_out[S: 4 * S]  # [3S, N], row 3 s + c

        # 5. Bin-constrained depths.
        z_vals_t = _bin_constrain_t(depth_t, refine_sig_t, near,
                                    far)  # [S, N]

    # 6. Query points as (s, c) rows with the tanh offsets applied row-wise
    # (no [N, S, 3] intermediate); fused NeRF + streaming composite
    # (inference semantics; the [S, N] aux inputs are native here: no
    # transposes, no raw written).
    with span("nerf"):
        pts24_t = (
            ndc_o_t.repeat(S, 1)
            + z_vals_t.repeat_interleave(3, dim=0) * ndc_d_t.repeat(S, 1)
            + statics.offset_scale * torch.tanh(po_rows)
        )  # [S*3, N]
        d_pe = positional_encoding(rays["viewdirs"], statics.multires_views)
        vcon_t = view_contribution(params["nerf"], d_pe, kdt)  # [128, N]
        dnorm_t = torch.sqrt(torch.sum(ndc_d_t * ndc_d_t,
                                       dim=0))[None]  # [1, N]
        comp = fused_nerf_composite_t(
            params["nerf_packed"], pts24_t.float().contiguous(),
            vcon_t.contiguous(),
            z_vals_t.float().contiguous(),
            mm_add_t.float().contiguous(),
            mm_mul_t.float().contiguous(),
            dnorm_t.float().contiguous(),
            n_samples=S, white_bkgd=statics.white_bkgd,
        )
    return {
        "rgb0": refine_rgb_t.T,
        "rgb1": comp["rgb"],
        "depth": comp["depth"],
        "disp": comp["disp"],
        "acc": comp["acc"],
        "weights": comp["weights"],
        "mm_rgb": mm_rgb_t.T,
        "depth0": torch.mean(z_vals_t, dim=0),
        "sigma": comp["sigma"],
    }
