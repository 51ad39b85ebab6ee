"""The ProNeRF render pipeline, all (stage, branch) forms of it.

Pipeline per ray batch:
  1. Pluecker-encode 48 fixed NDC points -> sampler MLP -> 8 candidate depths
     (sigmoid into [near, far]) + density corrections + auxiliary RGB;
  2. sort depths (the corrections move with them), map NDC depth to 3D;
  3. select per-ray neighbor source views (training: random positions in
     each ray's distance order; eval: the nearest to the target pose),
     project the 8 candidates into them (epipolar warp), mean-fill invalid
     colors;
  4. refine MLP on [Pluecker(8 pts) || warped colors] -> refined depths
     (constrained to per-sample bins), 3D point offsets, auxiliary RGB;
  5. branch-specific sample surgery (stage-1 exploration expansion, stage-2
     jitter, learned offsets);
  6. NeRF MLP on positionally-encoded points/dirs -> alpha compositing with
     the sampler's density corrections folded in when enabled.

Counterpart of ``pronerf_tpu/models/pronerf.py``, with every (stage, branch)
of ``RenderStatics``: the deterministic serving path and the three training
branches (random per-ray neighbors, exploration, jitter, sigma noise,
frozen sampler). The step's random choices (n_mult, the direction coins,
the neighbor subset) are host values in ``controls``; the random draws come
from ``controls['rng']`` (a ``torch.Generator`` on the rays' device) unless
``controls`` carries them pre-drawn (``raw_noise``, ``jitter_noise``), which
is how the tests hand both packages the same numbers.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import torch

from pronerf_tpu_torch.models.donerf import DoNeRFMLP
from pronerf_tpu_torch.models.mlp import (
    MinMaxMLP,
    NeRFMLP,
    minmax_mlp_apply_folded,
)
from pronerf_tpu_torch.ops.composite import composite
from pronerf_tpu_torch.ops.encoding import (
    plucker,
    posenc_dim,
    positional_encoding,
)
from pronerf_tpu_torch.ops.rays import linspace_depths, ray_points
from pronerf_tpu_torch.ops.sampling import (
    bin_constrain,
    explore_expand,
    gap_jitter,
    ndc_to_3d_depth,
    sort_with_payloads,
)
from pronerf_tpu_torch.ops.warp import (
    epipolar_colors,
    epipolar_colors_per_view,
    epipolar_colors_shared,
    epipolar_colors_shared_windowed,
    is_u8_pack,
    mean_fill_invalid,
    mean_fill_invalid_sct,
    per_view_gather_auto,
)
from pronerf_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class RenderStatics:
    """Hashable configuration of one render path.

    Factory helpers below derive the (stage, branch) behavior matrix; every
    epsilon that differs between stages is explicit. The fields are those of
    the JAX package's ``RenderStatics``, with ``use_kernels`` in the place of
    ``use_pallas``. ``transposed`` is read by the frame renderer, which then
    takes ``models.pronerf_t.render_rays_t``.
    """

    N_samples: int = 8
    N_point_ray_enc: int = 48
    num_neighbor: int = 4
    multires: int = 10
    multires_views: int = 4
    netskips: tuple = (4,)
    mmnetskips: tuple = ()
    near: float = 1e-6
    far: float = 1.0
    ndc_eps: float = 1e-6           # NDC->3D depth epsilon (1e-6 s1, 1e-5 s2)
    epi_layout: str = "svc"          # refine-input color order: s1 [s,v,c], s2 [v,s,c]
    randomize: bool = True           # training-style neighbor choice + noise
    stop_sampler_grad: bool = False  # stage-1 NeRF branch: sampler/refine frozen
    explore: bool = False            # stage-1 NeRF branch sample multiplication
    jitter: bool = False             # stage-2 single-sided jitter
    add_offsets: bool = True         # +1e-2 * tanh offsets on query points
    use_mm: bool = True              # density corrections in compositing
    clamp_raw: bool = False          # stage-1 +-10 raw clamp
    noise_std: float = 0.0           # sigma noise std (stage-dependent)
    white_bkgd: bool = False
    max_expand: int = 64
    offset_scale: float = 1e-2
    compute_dtype: Optional[str] = None  # 'bfloat16' for the inference path
    use_kernels: bool = False  # fused PE->NeRF(->composite) and MinMax
                               # kernels (inference)
    fuse_composite: bool = False  # stream alpha compositing inside the NeRF
                                  # kernel, so raw [N, S, 4] never reaches
                                  # device memory
    pallas_block_rays: int = 4096  # carried for config parity; the CUDA
                                   # kernels fix their tile at build time
    gather_tiles: int = 0      # windowed epipolar gather: contiguous ray
                               # tiles a call (0 = off; -1 = auto, resolved
                               # by render.renderer.resolve_gather_statics)
    gather_window_rows: int = 0  # source-row band height per tile window
    gather_bf16: int = -1  # cast the deterministic-path epipolar colors to
                           # bf16 as they are gathered. -1 auto (= on when
                           # the fused MinMax kernels serve), 0 off, 1 force
    gather_split: bool = False   # u8 gathers as three word fetches a
                                 # point (the same values as the row fetch)
    gather_transposed: int = -1  # emit the epipolar colors directly in the
                                 # kernels' transposed layout: -1 auto
                                 # (= off), 0 off, 1 force
    train_gather: int = -1       # training-path warp: -1 auto (= the
                                 # all-views gather), 0 all-views, 1 the
                                 # per-view form (u8 pack)
    netarch: str = "nerf"     # radiance-field family: 'nerf' | 'donerf'
                              # (donerf runs without the kernels)
    transposed: bool = False  # fully transposed serving graph
                              # (models/pronerf_t.py)
    quant: str = "none"       # 'int8': run the fused NeRF kernel with int8
                              # products (kernels/fused_nerf_q.py)

    # -- factories reproducing the behavior matrix ------------------------
    @staticmethod
    def stage1_nerf(randomize=True, noise_std=1.0, **kw) -> "RenderStatics":
        """Stage-1 odd steps: train the NeRF with exploration; sampler and
        refine nets run frozen, density corrections OFF."""
        return RenderStatics(
            near=1e-6, ndc_eps=1e-6, epi_layout="svc", randomize=randomize,
            stop_sampler_grad=True, explore=randomize, add_offsets=False,
            use_mm=False, clamp_raw=True,
            noise_std=noise_std if randomize else 0.0, **kw,
        )

    @staticmethod
    def stage1_sampler(randomize=True, **kw) -> "RenderStatics":
        """Stage-1 even steps (and stage-1 eval with randomize=False): all
        nets live, offsets on, density corrections in compositing, no
        noise."""
        return RenderStatics(
            near=1e-6, ndc_eps=1e-6, epi_layout="svc", randomize=randomize,
            stop_sampler_grad=False, explore=False, add_offsets=True,
            use_mm=True, clamp_raw=True, noise_std=0.0, **kw,
        )

    @staticmethod
    def stage2(randomize=True, noise_std=1.0, **kw) -> "RenderStatics":
        """Stage-2 joint training / eval: near=0, eps=1e-5, [v,s,c] feature
        layout, jitter+noise only while training, no raw clamp."""
        return RenderStatics(
            near=0.0, ndc_eps=1e-5, epi_layout="vsc", randomize=randomize,
            stop_sampler_grad=False, explore=False, jitter=randomize,
            add_offsets=True, use_mm=True, clamp_raw=False,
            noise_std=noise_std if randomize else 0.0, **kw,
        )

    @staticmethod
    def infer(
        compute_dtype: Optional[str] = None,
        use_kernels: bool = False,
        **kw,
    ) -> "RenderStatics":
        """Deterministic inference, optionally in bfloat16 and/or through
        the fused kernels."""
        return RenderStatics(
            near=0.0, ndc_eps=1e-5, epi_layout="vsc", randomize=False,
            stop_sampler_grad=False, explore=False, jitter=False,
            add_offsets=True, use_mm=True, clamp_raw=False, noise_std=0.0,
            compute_dtype=compute_dtype, use_kernels=use_kernels, **kw,
        )


def init_pronerf_params(
    generator: Optional[torch.Generator] = None,
    *,
    netarch: str = "nerf",
    netdepth: int = 8,
    netwidth: int = 256,
    mmnetdepth: int = 6,
    mmnetwidth: int = 256,
    N_samples: int = 8,
    N_point_ray_enc: int = 48,
    num_neighbor: int = 4,
    multires: int = 10,
    multires_views: int = 4,
    netskips=(4,),
    mmnetskips=(),
    device=None,
) -> Dict[str, torch.nn.Module]:
    """Initialize the three nets: ``{'nerf', 'sampler', 'refine'}``.

    Head widths: sampler in=6*48=288 out=3*S+3=27; refine in=6*S + 3*V*S=144
    out=4*S+3=35. Weights are drawn on the CPU from ``generator`` (nerf, then
    sampler, then refine) and moved to ``device``. ``netarch='donerf'``
    makes the radiance net a ``models.donerf.DoNeRFMLP`` (Kaiming-normal,
    ``netskips`` unused).
    """
    g = generator if generator is not None else torch.Generator()
    if netarch == "donerf":
        nerf = DoNeRFMLP(netdepth, netwidth, posenc_dim(3, multires),
                         posenc_dim(3, multires_views), 4, generator=g,
                         device=device)
    else:
        nerf = NeRFMLP(
            netdepth, netwidth, posenc_dim(3, multires),
            posenc_dim(3, multires_views), tuple(netskips), g, device,
        )
    return {
        "nerf": nerf,
        "sampler": MinMaxMLP(
            mmnetdepth, mmnetwidth, 6 * N_point_ray_enc, 3 * N_samples + 3,
            tuple(mmnetskips), g, device,
        ),
        "refine": MinMaxMLP(
            mmnetdepth, mmnetwidth,
            6 * N_samples + 3 * num_neighbor * N_samples, 4 * N_samples + 3,
            tuple(mmnetskips), g, device,
        ),
    }


def _select_neighbors(rays, scene, controls):
    """[N, V] per-ray neighbor source-view ids while training: each ray's
    training views sorted by camera distance, without its own view, at the
    host-drawn positions ``neighbor_subset`` (shared across the batch). The
    own view is sent to +inf BY INDEX, so it sorts last even when two
    training poses coincide; the sort is stable, as ``jnp.argsort``."""
    poses_t = scene["poses_t"]  # [T, 3] training-pose translations
    pose_id = rays["pose_id"].to(torch.int64)
    target_t = poses_t[pose_id]  # [N, 3]
    dist = torch.linalg.norm(target_t[:, None, :] - poses_t[None], dim=-1)
    own = (torch.arange(poses_t.shape[0], device=dist.device)[None, :]
           == pose_id[:, None])
    dist = torch.where(own, torch.full_like(dist, float("inf")), dist)
    order = torch.argsort(dist, dim=-1, stable=True)  # self is now last
    subset = torch.as_tensor(controls["neighbor_subset"], dtype=torch.int64,
                             device=dist.device)
    return order[:, :-1][:, subset]


def _nearest_views(statics, scene, controls):
    """[V] nearest training views to the eval/inference target pose, shared
    by every ray of the frame. The sort is stable, so two views at the same
    distance keep their index order."""
    dist = torch.linalg.norm(
        controls["target_t"][None, :] - scene["poses_t"], dim=-1
    )
    return torch.argsort(dist, stable=True)[: statics.num_neighbor]


def view_contribution(nerf: NeRFMLP, d_pe, pack_dtype):
    """``vcon_t [128, N]`` float32: the direction half of the view layer,
    ``views_w[:, 256:] . d_pe`` with operands in ``pack_dtype`` and f32
    accumulation (bias excluded; the kernel adds it). The fused NeRF kernels
    cast it to the pack dtype before adding it."""
    wv = nerf.views.weight[:, nerf.W:]  # [128, Cd]
    return wv.to(pack_dtype).float() @ d_pe.to(pack_dtype).float().T


def _coin(c):
    """A direction coin as the ops take it: a 0-d tensor stays on its device
    (the ops choose with ``torch.where``, no host sync), anything else is a
    host bool."""
    return c if torch.is_tensor(c) else bool(c)


def _check_statics(statics: RenderStatics):
    if statics.netarch not in ("nerf", "donerf"):
        raise ValueError(
            f"netarch must be 'nerf' or 'donerf', got {statics.netarch!r}")
    if statics.quant not in ("none", "int8"):
        raise ValueError(
            f"quant must be 'none' or 'int8', got {statics.quant!r}")
    if statics.use_kernels and statics.netarch != "nerf":
        raise ValueError("the fused kernels implement the NeRF MLP; "
                         "netarch='donerf' runs without them")
    if statics.randomize and statics.use_kernels:
        raise ValueError("the fused kernels serve the deterministic path "
                         "only (no gradient flows through them)")


def render_rays(params, rays, scene, controls, statics: RenderStatics):
    """Render a batch of rays end to end.

    Args:
      params: {'nerf', 'sampler', 'refine'} modules, optionally with the
        pre-packed kernel panels of ``kernels.packing.pack_serving_params``.
      rays: dict of [N, ...] tensors: ndc_o, ndc_d, viewdirs (unit world
        dirs), or_o, or_d (original camera-space rays for warping), and
        pose_id ([N] train-view id; read when ``randomize``).
      scene: dict: images [T, H, W, 3], fused_mats [T, 3, 4], K [3, 3],
        poses_t [T, 3].
      controls: dict. Eval: target_t [3]. Training: n_mult (int, or a 0-d
        integer tensor on the rays' device), dir_expand, dir_jitter (bool,
        or 0-d bool tensors there), neighbor_subset [V] (ints), rng (a
        ``torch.Generator`` on the rays' device, for the draws that are not
        given), and optionally the pre-drawn N(0, 1) noise raw_noise and
        jitter_noise ([N, >= width]; the first ``width`` columns are used,
        width = the samples a ray after exploration).
      statics: RenderStatics.

    Gradients flow as in the JAX package's ``render_rays`` under
    ``jax.grad``: never through the epipolar gather (computed under
    ``no_grad`` on a detached ``z3d``), nor through the sampler and refine
    nets when ``stop_sampler_grad`` (they then run under ``no_grad``), nor
    into ``depth0``.

    With ``use_kernels`` the fused kernels run: on CUDA tensors the CUDA
    kernels, on CPU tensors their plain versions. No gradient flows through
    them; callers on the serving path run under ``torch.no_grad()``.

    Each numbered stage is a span (``utils/profiling.span``): ``sampler``
    (1), ``sort`` (2), ``gather`` (3, with the mean fill and the colours'
    layout), ``refine`` (4 and 5), ``nerf`` (6 up to ``raw`` or the fused
    composite), ``composite`` (``ops.composite.composite``).

    Returns: dict with rgb0 (refine aux rgb), rgb1 (composited NeRF rgb),
      depth, disp, acc, mm_rgb, depth0, weights, sigma.
    """
    _check_statics(statics)
    S = statics.N_samples
    near, far = statics.near, statics.far
    cdt = torch.bfloat16 if statics.compute_dtype == "bfloat16" else None

    ndc_o, ndc_d = rays["ndc_o"], rays["ndc_d"]
    n_rays = ndc_o.shape[0]

    # 1. Sampler: Pluecker signature of 48 fixed NDC points.
    # The Pluecker moment m = p x d_hat is invariant along the ray
    # (p = o + t d), so the 48-point signature is 48 copies of one
    # [d_hat, m] 6-vector; the serving path folds the tiling into the
    # first-layer weights instead of materializing [N, 288].
    with span("sampler"):
        fold_mm = cdt is not None and not statics.mmnetskips
        mm_kernel = fold_mm and statics.use_kernels
        # stage-1 NeRF steps train the NeRF alone: the sampler and refine nets
        # run frozen, so no graph is kept for them
        frozen = torch.no_grad() if statics.stop_sampler_grad \
            else contextlib.nullcontext()
        if mm_kernel:
            from pronerf_tpu_torch.kernels.fused_minmax import (
                fused_minmax_t,
                pack_minmax_params,
            )

            sig = plucker(ndc_o, ndc_d)  # [N, 6]
            sig_t = sig.T.contiguous()
            packed_s = params.get("sampler_packed")
            if packed_s is None:
                packed_s = pack_minmax_params(
                    params["sampler"], statics.N_point_ray_enc, cdt
                )
            mm_out = fused_minmax_t(packed_s, sig_t)[:, : 3 * S + 3]
        elif fold_mm:
            sig = plucker(ndc_o, ndc_d)  # [N, 6]
            with frozen:
                mm_out = minmax_mlp_apply_folded(
                    params["sampler"], sig, statics.N_point_ray_enc, None, cdt
                )
        else:
            sig_depths = linspace_depths(
                0.0, 1.0, statics.N_point_ray_enc, ndc_o.dtype, ndc_o.device
            )
            sig_pts = ray_points(
                ndc_o, ndc_d,
                sig_depths.expand(n_rays, statics.N_point_ray_enc),
            )
            sampler_in = plucker(sig_pts, ndc_d[:, None, :]).reshape(
                n_rays, -1)
            with frozen:
                mm_out = params["sampler"](sampler_in, cdt)
        mm_rgb = torch.sigmoid(mm_out[:, 3 * S:])
        mm_add = mm_out[:, S: 2 * S]
        mm_mul = mm_out[:, 2 * S: 3 * S]
        depth_values = torch.sigmoid(mm_out[:, :S]) * (far - near) + near

    # 2. Sort depths; carry the density corrections along.
    with span("sort"):
        depth_values, mm_add, mm_mul = sort_with_payloads(
            depth_values, mm_add, mm_mul
        )
        z3d = ndc_to_3d_depth(depth_values, statics.ndc_eps)

    # 3. Epipolar color features (never differentiated): per-ray neighbor
    # views while training, else the shared nearest views.
    with span("gather"):
        gdt = (
            torch.bfloat16
            if (statics.gather_bf16 == 1
                or (statics.gather_bf16 == -1 and mm_kernel))
            else None
        )
        imgs = scene["images"]
        u8 = is_u8_pack(imgs)
        # Transposed emit: produce the fused kernels' rays-minor layout
        # directly at the gather instead of transposing epi_flat below.
        t_emit = (
            not statics.randomize and mm_kernel and u8
            and not statics.gather_split and statics.gather_transposed == 1
        )
        # Full-resolution serving: tile the ray batch and gather through
        # source row windows (statics resolved by
        # render.renderer.resolve_gather_statics)
        windowed = (
            statics.gather_tiles > 0 and statics.gather_window_rows > 0 and u8
        )
        z3d = z3d.detach()
        with torch.no_grad():
            if statics.randomize:
                view_idx = _select_neighbors(rays, scene, controls)
                per_view = (statics.train_gather == 1 and u8) or (
                    statics.train_gather == -1 and per_view_gather_auto(imgs))
                gather = epipolar_colors_per_view if per_view \
                    else epipolar_colors
                colors = gather(
                    imgs, scene["fused_mats"], scene["K"], view_idx,
                    rays["or_o"], rays["or_d"], z3d,
                    split=statics.gather_split and u8,
                )  # [N, V, S, 3]
                colors = mean_fill_invalid(colors)
            else:
                nearest = _nearest_views(statics, scene, controls)
                args = (imgs, scene["fused_mats"], scene["K"], nearest,
                        rays["or_o"], rays["or_d"], z3d)
                if windowed:
                    colors = epipolar_colors_shared_windowed(
                        *args, statics.gather_tiles,
                        statics.gather_window_rows,
                        split=statics.gather_split, out_dtype=gdt,
                        transposed_out=t_emit,
                    )
                else:
                    colors = epipolar_colors_shared(
                        *args, split=statics.gather_split and u8,
                        out_dtype=gdt,
                        transposed_out=t_emit,
                    )
                if t_emit:  # [V, S*3, N]
                    n_views = colors.shape[0]
                    epi_v = mean_fill_invalid_sct(
                        colors.reshape(n_views, S, 3, n_rays))
                else:  # [N, V, S, 3]
                    colors = mean_fill_invalid(colors)
        if t_emit:
            epi_flat = None
            if statics.epi_layout == "svc":
                epi_t = epi_v.transpose(0, 1).reshape(-1, n_rays)
            else:
                epi_t = epi_v.reshape(-1, n_rays)  # [V*S*3, N]
        else:
            epi_t = None
            if statics.epi_layout == "svc":
                epi_flat = colors.transpose(1, 2).reshape(n_rays, -1)
            else:
                epi_flat = colors.reshape(n_rays, -1)  # [N, V*S*3]

    # 4. Refine net on [Pluecker(candidates) || warped colors]. Same
    # collinearity fold as the sampler: the 8 candidate points share one
    # Pluecker signature.
    with span("refine"):
        if mm_kernel:
            packed_r = params.get("refine_packed")
            if packed_r is None:
                packed_r = pack_minmax_params(params["refine"], S, cdt)
            # one dtype for the concat, so a bf16 gather stays bf16 (the kernel
            # casts its input to bf16 on entry either way)
            epi_rows_t = epi_t if epi_t is not None else epi_flat.T
            refine_out = fused_minmax_t(
                packed_r,
                torch.cat([sig_t.to(epi_rows_t.dtype), epi_rows_t], dim=0),
            )[:, : 4 * S + 3]
        elif fold_mm:
            with frozen:
                refine_out = minmax_mlp_apply_folded(
                    params["refine"], sig, S, epi_flat, cdt
                )
        else:
            epi_pts = ray_points(ndc_o, ndc_d, depth_values)
            plk = plucker(epi_pts, ndc_d[:, None, :]).reshape(n_rays, -1)
            with frozen:
                refine_out = params["refine"](
                    torch.cat([plk, epi_flat], dim=-1), cdt
                )
        refine_sig = torch.sigmoid(refine_out[:, :S])
        refine_rgb = torch.sigmoid(refine_out[:, 4 * S:])
        points_offset = torch.tanh(refine_out[:, S: 4 * S]).reshape(
            n_rays, S, 3)

        # 5. Bin-constrained refined depths + branch-specific surgery.
        z_vals = bin_constrain(depth_values, refine_sig, near, far)
        num_valid = None
        gen = controls.get("rng")
        if statics.explore:
            z_vals, num_valid = explore_expand(
                z_vals, controls["n_mult"], _coin(controls["dir_expand"]),
                near, far, statics.max_expand,
            )
            jittered = gap_jitter(
                z_vals, near, far, _coin(controls["dir_jitter"]), 0.99,
                noise=controls.get("jitter_noise"), generator=gen,
            )
            idx = torch.arange(statics.max_expand, device=z_vals.device)
            z_vals = torch.where(idx[None, :] < num_valid, jittered,
                                 torch.full_like(jittered, far))
        elif statics.jitter:
            z_vals = gap_jitter(
                z_vals, near, far, _coin(controls["dir_jitter"]), 1.0 - 2e-6,
                noise=controls.get("jitter_noise"), generator=gen,
            )
        n_s = z_vals.shape[-1]

    # 6. NeRF forward (fused kernel on the inference path, the module
    # otherwise) + shared compositing.
    with span("nerf"):
        comp = None
        if statics.use_kernels:
            # PE + MLP chain inside the kernel; the view-dir ENCODING and its
            # small product stay outside. With fuse_composite (and inference
            # semantics) alpha compositing streams inside the kernel.
            from pronerf_tpu_torch.kernels.fused_nerf import (
                fused_nerf_composite_t,
                fused_nerf_raw_t,
                pack_nerf_params,
            )

            kdt = torch.bfloat16 if cdt is not None else torch.float32
            d_pe = positional_encoding(rays["viewdirs"],
                                       statics.multires_views)
            vcon_t = view_contribution(params["nerf"], d_pe, kdt)  # [128, N]
            # [S*3, N] transposed query points, row 3*s + c, the offsets taken
            # from refine_out's [n, 3s + c] columns: the same points as
            # ray_points + offsets below.
            pts24_t = (
                ndc_o.T[None, :, :]
                + ndc_d.T[None, :, :] * z_vals.T[:, None, :]
            ).reshape(3 * S, n_rays)
            if statics.add_offsets:
                pts24_t = pts24_t + statics.offset_scale * torch.tanh(
                    refine_out[:, S: 4 * S].T
                )
            pts24_t = pts24_t.float().contiguous()
            fuse_comp = (
                statics.fuse_composite and statics.noise_std == 0.0
                and not statics.explore and not statics.clamp_raw
                and statics.use_mm
            )
            if statics.quant == "int8":
                # the int8 serving path (opt-in); compositing stays in
                # ops.composite, never inside the kernel
                from pronerf_tpu_torch.kernels.fused_nerf_q import (
                    fused_nerf_raw_tq,
                    pack_nerf_params_int8,
                )

                packed_q = params.get("nerf_packed_q")
                if packed_q is None:
                    packed_q = pack_nerf_params_int8(params["nerf"])
                raw = fused_nerf_raw_tq(
                    packed_q, pts24_t, vcon_t.contiguous(), n_samples=S)
            elif fuse_comp:
                packed = params.get("nerf_packed")
                if packed is None:
                    packed = pack_nerf_params(params["nerf"], kdt)
                dnorm = torch.linalg.norm(ndc_d, dim=-1)[None, :]
                comp = fused_nerf_composite_t(
                    packed, pts24_t, vcon_t,
                    z_vals.T.float().contiguous(),
                    mm_add.T.float().contiguous(),
                    mm_mul.T.float().contiguous(),
                    dnorm.float().contiguous(),
                    n_samples=S, white_bkgd=statics.white_bkgd,
                )
                sigma_out = comp["sigma"]
            else:
                packed = params.get("nerf_packed")
                if packed is None:
                    packed = pack_nerf_params(params["nerf"], kdt)
                raw = fused_nerf_raw_t(packed, pts24_t, vcon_t, n_samples=S)
        else:
            query_pts = ray_points(ndc_o, ndc_d, z_vals)
            if statics.add_offsets:
                query_pts = query_pts + statics.offset_scale * points_offset
            x_pe = positional_encoding(query_pts, statics.multires)
            d_pe = positional_encoding(rays["viewdirs"],
                                       statics.multires_views)
            if cdt is None or statics.netarch == "donerf":
                # The parity path (and donerf) broadcasts dirs per point; the
                # serving path hands the NeRF module the per-ray encoding.
                d_pe = d_pe[:, None, :].expand(n_rays, n_s, d_pe.shape[-1])
            raw = params["nerf"](x_pe, d_pe, cdt)

    if comp is None:
        with span("composite"):
            noise = None
            if statics.noise_std > 0.0:
                rn = controls.get("raw_noise")
                if rn is None:
                    rn = torch.randn(z_vals.shape, generator=gen,
                                     dtype=z_vals.dtype, device=z_vals.device)
                else:
                    rn = rn[:, :n_s].to(z_vals.dtype)
                noise = statics.noise_std * rn
            comp = composite(
                raw,
                z_vals,
                ndc_d,
                noise=noise,
                mm_add=mm_add if statics.use_mm else None,
                mm_mul=mm_mul if statics.use_mm else None,
                clamp_raw=statics.clamp_raw,
                num_valid=num_valid,
                white_bkgd=statics.white_bkgd,
            )
            sigma_out = raw[..., 3]
    return {
        "rgb0": refine_rgb,
        "rgb1": comp["rgb"],
        "depth": comp["depth"],
        "disp": comp["disp"],
        "acc": comp["acc"],
        "weights": comp["weights"],
        "mm_rgb": mm_rgb,
        "depth0": torch.mean(z_vals.detach(), dim=-1),
        "sigma": sigma_out,
    }
