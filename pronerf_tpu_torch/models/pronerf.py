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
    explore_expand,
    gap_jitter,
    sort_sampler_depths,
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
    the JAX package's ``RenderStatics`` with ``use_kernels`` in the place of
    ``use_pallas``, less two: its switch of the composite into the NeRF
    kernel (the kernel path here composites there wherever the statics
    allow it) and its Pallas block of rays (the CUDA kernels fix their tile
    at build time). The graph a ray slab runs is picked by
    ``models.pronerf_t.graph_for``.
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
                              # (donerf's kernel is bf16, no int8)
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
        the fused kernels. With the kernels the frame composites inside the
        NeRF kernel (the int8 kernel returns raw for ``ops.composite``)."""
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


def view_weight(nerf, n_dir: int):
    """The columns of the layer that reads the view features which take the
    direction encoding (``n_dir`` wide): the NeRF MLP's ``views.weight[:,
    256:]`` [128, n_dir], DoNeRF's head ``W[:, W:]`` [4, n_dir]. A view of
    the weight, no copy."""
    if isinstance(nerf, DoNeRFMLP):
        return nerf.layers[-1].weight[:, -n_dir:]
    return nerf.views.weight[:, nerf.W:]


def view_contribution(nerf, d_pe, pack_dtype):
    """The direction half of the layer that reads the view features, per
    ray, with operands in ``pack_dtype`` and f32 accumulation (bias
    excluded; the kernel adds it): for the NeRF MLP ``vcon_t [128, N] =
    views_w[:, 256:] . d_pe``, which the fused NeRF kernels cast to the
    pack dtype before adding it; for DoNeRF ``dcon_t [4, N]``, the head's
    ``W[:, W:] . d_pe``, which its kernel adds to the head's f32 sums.
    ``nerf`` is the radiance net, or the weight :func:`view_weight` gives."""
    wv = nerf if torch.is_tensor(nerf) else view_weight(nerf, d_pe.shape[-1])
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
    if statics.use_kernels and statics.netarch == "donerf":
        if statics.quant != "none":
            raise ValueError("the int8 kernel implements the NeRF MLP; "
                             "netarch='donerf' takes quant='none'")
        if statics.compute_dtype != "bfloat16":
            raise ValueError("the DoNeRF kernel is bf16: netarch='donerf' "
                             "takes the kernels with compute_dtype="
                             "'bfloat16'")
    if statics.randomize and statics.use_kernels:
        raise ValueError("the fused kernels serve the deterministic path "
                         "only (no gradient flows through them)")


def _gather_on_kernel(statics, mm_kernel: bool, images, gather_dtype):
    """Whether step 3 of :func:`render_rays` runs the kernel pair of
    ``kernels/epipolar_gather.py`` (gather, fill and the refine kernel's
    whole input x_t in one pass, the values of the PyTorch forms; the split
    fetch and the transposed emit change nothing there): the deterministic
    path, the fused MinMax kernel, the u8 corner pack on the card and bf16
    colours. Every other case keeps the PyTorch forms."""
    return (not statics.randomize and mm_kernel and is_u8_pack(images)
            and images.is_cuda and gather_dtype == torch.bfloat16)


def _sort_on_kernel(mm_kernel: bool, n_samples: int) -> bool:
    """Whether step 2 of :func:`render_rays` runs ``kernels/depth_sort.py``'s
    op (the depths, their sort and the 3D depths in one kernel, the chain's
    values bit for bit): where the MinMax kernel made the sampler's output
    (no autograd) and the sort network takes S. Every other case keeps the
    chain, ``ops.sampling.sort_sampler_depths``."""
    from pronerf_tpu_torch.kernels.depth_sort import MAX_SAMPLES

    return mm_kernel and n_samples <= MAX_SAMPLES


def _prep_on_kernel(statics, mm_kernel: bool, n_samples: int) -> bool:
    """Whether step 6 of :func:`render_rays` builds the NeRF kernel's inputs
    with ``kernels/query_prep.py``'s op (the refine epilogue, the query
    points, the view term and the composite's rows in one kernel, the
    chain's values but for the order of three sums): where the MinMax
    kernel ran the refine net (no autograd), no exploration or jitter moves
    the depths, the kernel takes S and the view encoding is at its octaves.
    Every other case keeps the chain (``query_prep.refine_epilogue``,
    ``query_points_t``, :func:`view_contribution`)."""
    from pronerf_tpu_torch.kernels.query_prep import MAX_SAMPLES, VIEW_OCTAVES

    return (mm_kernel and not statics.explore and not statics.jitter
            and n_samples <= MAX_SAMPLES
            and statics.multires_views == VIEW_OCTAVES)


def pack_serving_params(params, statics: RenderStatics):
    """Return ``params`` with the kernel panels that a frame of ``statics``
    reads, so that a renderer packs them once a parameter set, not once a
    frame. ``render_rays`` and ``models.pronerf_t.render_rays_t`` call it on
    entry, where packed params make it a no-op.

    - ``nerf_packed_q`` (the int8 panels) with ``quant = 'int8'``, else
      ``nerf_packed``; with ``transposed`` ``nerf_packed`` too, because the
      transposed graph composites in the bf16/f32 NeRF kernel, as the JAX
      package's does; for DoNeRF ``donerf_packed`` in their place;
    - ``sampler_packed`` / ``refine_packed`` when the MinMax nets run as
      kernels in ``render_rays`` (bf16 and no ``mmnetskips``: the fold's
      precondition);
    - with ``transposed`` (and no ``mmnetskips``) ``sampler_packed`` and
      ``refine_packed_t``, whose first-layer rows are permuted to the
      transposed graph's (v, c, s) feature order.

    Returns ``params`` itself outside the kernel path and when every panel
    is there; else a new dict with the missing panels added, so that params
    packed for one form and handed to another are completed.
    """
    if not statics.use_kernels:
        return params
    pdt = (torch.bfloat16 if statics.compute_dtype == "bfloat16"
           else torch.float32)
    int8, bf16 = statics.quant == "int8", pdt == torch.bfloat16
    minmax = not statics.mmnetskips
    donerf = statics.netarch == "donerf"
    need = {
        "nerf_packed_q": int8,
        "nerf_packed": not donerf and (not int8 or statics.transposed),
        "donerf_packed": donerf,
        "sampler_packed": minmax and (bf16 or statics.transposed),
        "refine_packed": minmax and bf16,
        "refine_packed_t": minmax and statics.transposed,
    }
    missing = [k for k, on in need.items() if on and k not in params]
    if not missing:
        return params
    from pronerf_tpu_torch.kernels import (
        fused_minmax,
        fused_nerf,
        fused_nerf_q,
    )
    from pronerf_tpu_torch.models.pronerf_t import refine_rest_row_perm

    S = statics.N_samples
    pack = {
        "nerf_packed_q": lambda: fused_nerf_q.pack_nerf_params_int8(
            params["nerf"]),
        "nerf_packed": lambda: fused_nerf.pack_nerf_params(params["nerf"],
                                                           pdt),
        "donerf_packed": lambda: fused_nerf.pack_donerf_params(
            params["nerf"], pdt),
        "sampler_packed": lambda: fused_minmax.pack_minmax_params(
            params["sampler"], statics.N_point_ray_enc, pdt),
        "refine_packed": lambda: fused_minmax.pack_minmax_params(
            params["refine"], S, pdt),
        "refine_packed_t": lambda: fused_minmax.pack_minmax_params(
            params["refine"], S, pdt, rest_row_perm=refine_rest_row_perm(
                statics.num_neighbor, S)),
    }
    return dict(params, **{k: pack[k]() for k in missing})


def render_rays(params, rays, scene, controls, statics: RenderStatics):
    """Render a batch of rays end to end.

    Args:
      params: {'nerf', 'sampler', 'refine'} modules, optionally with the
        kernel panels of :func:`pack_serving_params` (packed here where
        they are missing).
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
    (1), ``sort`` (2, the depths from the sampler's logits too; with the
    MinMax kernel the kernel of ``kernels/depth_sort.py``), ``gather`` (3,
    with the mean fill and the colours' layout; for the served frame on the
    card the kernel pair of ``kernels/epipolar_gather.py``, which writes the
    refine kernel's whole input), ``refine`` (4 and 5), ``nerf`` (6 up to
    ``raw`` or the fused composite; where the MinMax kernel ran the refine
    net, it launches first the op of ``kernels/query_prep.py``, which does
    step 5 and builds every input of the NeRF kernel in one kernel),
    ``composite`` (``ops.composite.composite``).

    Returns: dict with rgb0 (refine aux rgb), rgb1 (composited NeRF rgb),
      depth, disp, acc, mm_rgb, depth0, weights, sigma.
    """
    _check_statics(statics)
    params = pack_serving_params(params, statics)
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
            from pronerf_tpu_torch.kernels.fused_minmax import fused_minmax_t

            sig = plucker(ndc_o, ndc_d)  # [N, 6]
            sig_t = sig.T.contiguous()
            mm_out = fused_minmax_t(params["sampler_packed"],
                                    sig_t)[:, : 3 * S + 3]
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

    # 2. Depths from the sampler's logits, sorted; the density corrections
    # move with them. Where the MinMax kernel made mm_out, one kernel does
    # it all (its plain version, the chain, on CPU tensors).
    with span("sort"):
        if _sort_on_kernel(mm_kernel, S):
            from pronerf_tpu_torch.kernels.depth_sort import (
                sorted_sampler_depths as sort_depths,
            )
        else:
            sort_depths = sort_sampler_depths
        depth_values, mm_add, mm_mul, z3d = sort_depths(
            mm_out, S, near, far, statics.ndc_eps)

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
        gather_kernel = _gather_on_kernel(statics, mm_kernel, imgs, gdt)
        x_t = None
        z3d = z3d.detach()
        with torch.no_grad():
            if gather_kernel:
                from pronerf_tpu_torch.kernels.epipolar_gather import (
                    epipolar_gather_rows,
                )

                x_t = epipolar_gather_rows(
                    imgs, scene["fused_mats"], scene["K"],
                    _nearest_views(statics, scene, controls), rays["or_o"],
                    rays["or_d"], z3d, sig_t,
                    statics.gather_tiles if windowed else 0,
                    statics.gather_window_rows,
                    svc=statics.epi_layout == "svc",
                )
            elif statics.randomize:
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
        if gather_kernel:
            epi_t = epi_flat = None
        elif t_emit:
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
            if x_t is None:
                # one dtype for the concat, so a bf16 gather stays bf16 (the
                # kernel casts its input to bf16 on entry either way)
                epi_rows_t = epi_t if epi_t is not None else epi_flat.T
                x_t = torch.cat([sig_t.to(epi_rows_t.dtype), epi_rows_t],
                                dim=0)
            refine_out = fused_minmax_t(params["refine_packed"],
                                        x_t)[:, : 4 * S + 3]
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
        # 5. Bin-constrained refined depths + branch-specific surgery; on
        # the kernel path (no surgery) step 6's op does it all.
        from pronerf_tpu_torch.kernels import query_prep as qp

        prep = _prep_on_kernel(statics, mm_kernel, S)
        num_valid = None
        gen = controls.get("rng")
        if not prep:
            refine_rgb, z_vals = qp.refine_epilogue(refine_out, depth_values,
                                                    S, near, far)
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
        n_s = S if prep else z_vals.shape[-1]

    # 6. NeRF forward (fused kernel on the inference path, the module
    # otherwise) + shared compositing.
    with span("nerf"):
        comp = None
        offsets = refine_out[:, S: 4 * S] if statics.add_offsets else None
        if statics.use_kernels:
            # PE + MLP chain inside the kernel; its inputs (the query points,
            # the view-dir encoding's product, the composite's rows) are
            # built outside: by kernels/query_prep.py's op where the refine
            # net ran in the MinMax kernel, else by the chain. Where the
            # statics allow it (no noise, exploration or raw clamp; the
            # density corrections on), alpha compositing streams inside the
            # kernel; else the raw kernel's output goes to ops.composite.
            # DoNeRF runs its own form of the kernel (its pack, the head's
            # direction term).
            from pronerf_tpu_torch.kernels import fused_nerf as fn

            if statics.netarch == "donerf":
                nerf_packed = params["donerf_packed"]
                raw_t = fn.fused_donerf_raw_t
                composite_t = fn.fused_donerf_composite_t
            else:
                nerf_packed = params.get("nerf_packed")
                raw_t = fn.fused_nerf_raw_t
                composite_t = fn.fused_nerf_composite_t
            if prep:
                (refine_rgb, pts24_t, vcon_t, z_t, mm_add_t, mm_mul_t,
                 dnorm_t, depth0) = qp.query_inputs(
                    refine_out, depth_values, mm_add, mm_mul, ndc_o, ndc_d,
                    rays["viewdirs"],
                    view_weight(params["nerf"],
                                posenc_dim(3, statics.multires_views)),
                    S, near, far, statics.offset_scale, statics.add_offsets,
                    statics.multires_views)
            else:
                kdt = torch.bfloat16 if cdt is not None else torch.float32
                d_pe = positional_encoding(rays["viewdirs"],
                                           statics.multires_views)
                # [128, N] (NeRF) or [4, N] (DoNeRF)
                vcon_t = view_contribution(params["nerf"], d_pe, kdt)
                # [S*3, N] transposed query points, row 3*s + c, the offsets
                # taken from refine_out's [n, 3s + c] columns: the same
                # points as ray_points + offsets below
                pts24_t = qp.query_points_t(ndc_o, ndc_d, z_vals, offsets,
                                            statics.offset_scale)
            fuse_comp = (
                statics.noise_std == 0.0 and not statics.explore
                and not statics.clamp_raw and statics.use_mm
            )
            if statics.quant == "int8":
                # the int8 serving path (opt-in); compositing stays in
                # ops.composite, never inside the kernel
                from pronerf_tpu_torch.kernels.fused_nerf_q import (
                    fused_nerf_raw_tq,
                )

                raw = fused_nerf_raw_tq(
                    params["nerf_packed_q"], pts24_t, vcon_t.contiguous(),
                    n_samples=S)
            elif fuse_comp:
                if not prep:
                    z_t, mm_add_t, mm_mul_t = (
                        t.T.float().contiguous()
                        for t in (z_vals, mm_add, mm_mul))
                    dnorm_t = torch.linalg.norm(ndc_d, dim=-1)[None, :] \
                        .float().contiguous()
                comp = composite_t(
                    nerf_packed, pts24_t, vcon_t, z_t, mm_add_t, mm_mul_t,
                    dnorm_t, n_samples=S, white_bkgd=statics.white_bkgd,
                )
                sigma_out = comp["sigma"]
            else:
                raw = raw_t(nerf_packed, pts24_t, vcon_t, n_samples=S)
            if prep and comp is None:  # ops.composite takes [N, S] depths
                z_vals = z_t.T.contiguous()
        else:
            query_pts = ray_points(ndc_o, ndc_d, z_vals)
            if offsets is not None:
                query_pts = query_pts + statics.offset_scale * torch.tanh(
                    offsets).reshape(n_rays, S, 3)
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
        "depth0": depth0 if prep else torch.mean(z_vals.detach(), dim=-1),
        "sigma": sigma_out,
    }
