"""Epipolar inverse warping: project candidate sample points into neighboring
source views and fetch bilinearly-interpolated colors.

- ``grid_sample(align_corners=True, padding_mode='zeros')`` semantics are an
  explicit out-of-bounds mask over a 4-corner gather + lerp;
- the per-view projection matrix is pre-fused into ``M = F @ [R^T | -R^T t]``
  (F = diag(1,-1,-1)) so the per-point work is one small product and a
  perspective divide with ``|z|``;
- the geometry is full float32: the small products are written as multiplies
  and sums, so no TF32 or bf16 path can touch them.

Every gather of the JAX module:

- the deterministic shared-view path: the row-major gather
  ``epipolar_colors_shared`` (its transposed emit ``transposed_out``, the
  three-word ``split`` form), the windowed gather of full-resolution
  serving ``epipolar_colors_shared_windowed``, and the fully transposed
  ``epipolar_colors_shared_t`` of the transposed serving graph (windowed
  too), each with its mean fill;
- the training path's all-views gather ``epipolar_colors`` (per-ray
  neighbor views) and its per-view form ``epipolar_colors_per_view``;
- the samplers: bilinear from a u8 corner pack (row or split word
  fetches), from a float corner stack or from plain images, and nearest
  from a whole-pixel u8 pack (``warp_interp = nearest``).

The windowed gathers choose each ray tile's source-row window from the
tile's own projections. The window start stays a device tensor: the rows
are fetched from the whole view at ``(start + row in the window) * W + x``,
the same words a slice of the window holds, with no copy and no host sync.
Under ``utils/profiling.tracing(counters=True)`` they count, on the device,
the points of live rays that project into the image (``gather_in_image``)
and those of them whose row falls outside the tile's window
(``gather_window_miss``: marked invalid and mean-filled).
"""

from __future__ import annotations

import torch

from pronerf_tpu_torch.utils import profiling


def _matvec(M, v):
    """[..., i, j] x [..., j] -> [..., i] as multiplies and a sum (full f32)."""
    return (M * v[..., None, :]).sum(-1)


def fuse_projection(c2w):
    """Per-view fused matrix M = F @ [R^T | -R^T t] with F = diag(1,-1,-1).

    Applying M to homogeneous world points yields p = (c_x, -c_y, -c_z) in
    the source camera frame; pixel coords follow as
    u = fx * p_x / |p_z| + cx, v = fy * p_y / |p_z| + cy.

    Args:
      c2w: [..., 3, 4] camera-to-world pose(s).

    Returns: [..., 3, 4].
    """
    R = c2w[..., :3, :3]
    t = c2w[..., :3, 3]
    Rt = R.transpose(-1, -2)
    w2c_t = -_matvec(Rt, t)
    M = torch.cat([Rt, w2c_t[..., None]], dim=-1)
    F = torch.tensor([1.0, -1.0, -1.0], dtype=M.dtype, device=M.device)
    return M * F[..., :, None]


def project_points(pts, M, K, H: int, W: int, eps: float = 1e-8):
    """Project world points into a source view; return normalized coords.

    Args:
      pts: [..., 3] world points.
      M: [..., 3, 4] fused matrices (see :func:`fuse_projection`),
         broadcastable against pts' batch shape.
      K: [3, 3] shared intrinsics.
      H, W: source image size.

    Returns:
      (xn, yn): [...] coords normalized to [-1, 1] (align_corners mapping);
      values outside [-1, 1] are out of bounds.
    """
    p = _matvec(M[..., :3], pts) + M[..., 3]
    z = torch.abs(p[..., 2]) + eps
    u = K[0, 0] * p[..., 0] / z + K[0, 2]
    v = K[1, 1] * p[..., 1] / z + K[1, 2]
    xn = 2.0 * u / (W - 1) - 1.0
    yn = 2.0 * v / (H - 1) - 1.0
    return xn, yn


def build_corner_stack(images):
    """Precompute the 2x2-neighborhood channel stack for fused bilinear
    gathers: out[..., j, i, :] = concat(img[j, i], img[j, i+1], img[j+1, i],
    img[j+1, i+1]) with edge clamping, so one row fetch brings all four
    corners. Built once per scene (4x image memory).

    Args: images [T, H, W, C]. Returns [T, H, W, 4*C].
    """
    right = torch.cat([images[:, :, 1:], images[:, :, -1:]], dim=2)
    down = torch.cat([images[:, 1:], images[:, -1:]], dim=1)
    diag = torch.cat([down[:, :, 1:], down[:, :, -1:]], dim=2)
    return torch.cat([images, right, down, diag], dim=-1)


def build_corner_stack_u8(images):
    """Quantized corner stack: the 12 corner channels (2x2 neighborhood x
    RGB, see :func:`build_corner_stack`) packed as THREE int32 words of four
    uint8 lanes each, so one 12-byte row holds everything a bilinear sample
    needs. Exact for 8-bit source images (synthetic float scenes quantize to
    1/255).

    The words are assembled in int64 and wrapped to int32: a corner byte of
    128 or more in the top lane makes the word negative, bit for bit what a
    uint32 word reinterpreted as int32 holds.

    Args: images [T, H, W, 3] float in [0, 1].
    Returns: int32 [T, H, W, 3] (word j = channel j of the four corners).
    """
    stack = build_corner_stack(images)  # [T, H, W, 12] = 4 corners x rgb
    q = torch.clamp(torch.round(stack * 255.0), 0, 255).to(torch.int64)
    # word j (j = r,g,b): byte c holds corner c's channel j, so a single
    # byte-lane extraction of the 3 words yields one corner's rgb.
    words = [
        q[..., 0 * 3 + j]
        | (q[..., 1 * 3 + j] << 8)
        | (q[..., 2 * 3 + j] << 16)
        | (q[..., 3 * 3 + j] << 24)
        for j in range(3)
    ]
    w = torch.stack(words, dim=-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def is_u8_pack(images) -> bool:
    """True for an int32 [T, H, W, 3] :func:`build_corner_stack_u8` array."""
    return images.dim() == 4 and images.dtype == torch.int32


def is_nearest_pack(images) -> bool:
    """True for an int32 [T, H, W] :func:`build_rgb_word_u8` array."""
    return images.dim() == 3 and images.dtype == torch.int32


def build_rgb_word_u8(images):
    """Whole-pixel u8 pack for nearest-neighbor warping: int32 [T, H, W]
    with r | g<<8 | b<<16, one word fetched per sample point.

    Args: images [T, H, W, 3] float in [0, 1]."""
    q = torch.clamp(torch.round(images * 255.0), 0, 255).to(torch.int32)
    return q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)


def _lanes(words):
    """The four byte lanes of u8-pack words as floats in [0, 1] (corners
    00, 01, 10, 11)."""
    return [((words >> shift) & 0xFF).to(torch.float32) * (1.0 / 255.0)
            for shift in (0, 8, 16, 24)]


def _index(c, n: int):
    """A pixel index from a coordinate already clipped to [0, n - 1],
    clipped again as an integer: a NaN coordinate (a diverged state's
    point) clips to NaN, and its integer is undefined; clipped, it fetches
    a pixel in the image (the point is out of bounds all the same, so its
    colour is masked) instead of faulting. A no-op for every finite
    coordinate."""
    return torch.clamp(c.to(torch.int64), 0, n - 1)


def _pixel_coords(xn, yn, H: int, W: int):
    inb = (xn >= -1.0) & (xn <= 1.0) & (yn >= -1.0) & (yn <= 1.0)
    u = torch.clamp((xn + 1.0) * 0.5 * (W - 1), 0.0, W - 1)
    v = torch.clamp((yn + 1.0) * 0.5 * (H - 1), 0.0, H - 1)
    x0 = _index(torch.floor(u), W)
    y0 = _index(torch.floor(v), H)
    return inb, x0, y0, u - x0.to(u.dtype), v - y0.to(v.dtype)


def _lerp(c00, c01, c10, c11, wx, wy, inb):
    top = c00 * (1.0 - wx) + c01 * wx
    bot = c10 * (1.0 - wx) + c11 * wx
    out = top * (1.0 - wy) + bot * wy
    return out * inb[..., None].to(out.dtype)


def bilinear_sample_packed_u8(packed, view_idx, xn, yn):
    """Bilinear sample from a :func:`build_corner_stack_u8` array: ONE
    3-word int32 row fetch per sample point, then a byte unpack.
    ``(rows >> k) & 0xFF`` is right for negative words too (the shift is
    arithmetic, the mask drops the sign bits)."""
    T, H, W, _ = packed.shape
    inb, x0, y0, wx, wy = _pixel_coords(xn, yn, H, W)
    idx = view_idx.to(torch.int64) * (H * W) + y0 * W + x0
    rows = packed.reshape(T * H * W, 3)[idx]  # [..., 3] words
    return _lerp(*_lanes(rows), wx[..., None], wy[..., None], inb)


def _split_lerp(table, idx, wx, wy, hit):
    """Three rank-1 word fetches (one a colour channel) and the lerp of
    each, in the scale-then-lerp order of the row form, so the two are
    equal bit for bit. table [P, 3] words; idx, wx, wy, hit [...]."""
    hit_f = hit.to(torch.float32)
    chans = []
    for k in range(3):
        c00, c01, c10, c11 = _lanes(table[:, k][idx])
        top = c00 * (1.0 - wx) + c01 * wx
        bot = c10 * (1.0 - wx) + c11 * wx
        chans.append((top * (1.0 - wy) + bot * wy) * hit_f)
    return torch.stack(chans, dim=-1)


def bilinear_sample_packed_u8_split(packed, view_idx, xn, yn):
    """:func:`bilinear_sample_packed_u8` with the [P, 3] row fetch split
    into THREE rank-1 word fetches (the JAX package's ``gather_split``
    knob). The values equal the row form's bit for bit."""
    T, H, W, _ = packed.shape
    inb, x0, y0, wx, wy = _pixel_coords(xn, yn, H, W)
    idx = view_idx.to(torch.int64) * (H * W) + y0 * W + x0
    return _split_lerp(packed.reshape(T * H * W, 3), idx, wx, wy, inb)


def nearest_sample_packed_u8(packed, view_idx, xn, yn):
    """Nearest-neighbor sample from a :func:`build_rgb_word_u8` array: ONE
    int32 word fetched per point, the pixel rounded half to even (as
    ``jnp.round``). Not reference parity (the reference always samples
    bilinearly): the ``warp_interp = 'nearest'`` serving knob."""
    T, H, W = packed.shape
    inb = (xn >= -1.0) & (xn <= 1.0) & (yn >= -1.0) & (yn <= 1.0)
    u = torch.clamp((xn + 1.0) * 0.5 * (W - 1), 0.0, W - 1)
    v = torch.clamp((yn + 1.0) * 0.5 * (H - 1), 0.0, H - 1)
    x0 = _index(torch.round(u), W)
    y0 = _index(torch.round(v), H)
    words = packed.reshape(T * H * W)[
        view_idx.to(torch.int64) * (H * W) + y0 * W + x0]
    out = torch.stack([(words >> shift) & 0xFF for shift in (0, 8, 16)],
                      dim=-1).to(torch.float32) * (1.0 / 255.0)
    return out * inb[..., None].to(out.dtype)


def _sample(images, view_idx, xn, yn, split: bool = False):
    """The sampler for ``images``' layout: nearest from a whole-pixel pack,
    bilinear from a u8 corner pack (row or split fetches), a float corner
    stack or plain images."""
    if is_nearest_pack(images):
        return nearest_sample_packed_u8(images, view_idx, xn, yn)
    if is_u8_pack(images):
        if split:
            return bilinear_sample_packed_u8_split(images, view_idx, xn, yn)
        return bilinear_sample_packed_u8(images, view_idx, xn, yn)
    if images.shape[-1] == 12:
        return bilinear_sample_packed(images, view_idx, xn, yn)
    return bilinear_sample(images, view_idx, xn, yn)


def bilinear_sample_packed(corner_stack, view_idx, xn, yn):
    """Bilinear sample from a :func:`build_corner_stack` array with ONE
    row fetch per sample point. Semantics identical to
    :func:`bilinear_sample` (align_corners=True, zeros outside [-1, 1])."""
    T, H, W, C4 = corner_stack.shape
    C = C4 // 4
    inb, x0, y0, wx, wy = _pixel_coords(xn, yn, H, W)
    idx = view_idx.to(torch.int64) * (H * W) + y0 * W + x0
    rows = corner_stack.reshape(T * H * W, C4)[idx]
    # Edge clamp in the stack already duplicates the border pixel, so the
    # (zero-weighted) out-of-row corner matches bilinear_sample's clip.
    return _lerp(rows[..., :C], rows[..., C: 2 * C], rows[..., 2 * C: 3 * C],
                 rows[..., 3 * C:], wx[..., None], wy[..., None], inb)


def bilinear_sample(images, view_idx, xn, yn):
    """Bilinear sample with align_corners=True and zeros outside [-1, 1].

    Args:
      images: [T, H, W, C].
      view_idx: [...] integer view index per sample point.
      xn, yn: [...] normalized coords.

    Returns: [..., C]; exact zeros where (xn, yn) is out of bounds.
    """
    T, H, W, C = images.shape
    inb, x0, y0, wx, wy = _pixel_coords(xn, yn, H, W)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    flat = images.reshape(T * H * W, C)
    base = view_idx.to(torch.int64) * (H * W)

    def gather(yi, xi):
        return flat[base + yi * W + xi]

    return _lerp(gather(y0, x0), gather(y0, x1), gather(y1, x0),
                 gather(y1, x1), wx[..., None], wy[..., None], inb)


def epipolar_colors(images, fused_mats, K, view_idx, rays_o, rays_d, z3d,
                    split: bool = False):
    """Colors of candidate sample points as seen from per-ray neighbor views
    (the training path: every ray has its own views).

    Args:
      images: [T, H, W, 3] float source images, a [T, H, W, 12]
        :func:`build_corner_stack`, an int32 [T, H, W, 3]
        :func:`build_corner_stack_u8` or an int32 [T, H, W]
        :func:`build_rgb_word_u8` (nearest).
      fused_mats: [T, 3, 4] per-view fused projection (``fuse_projection``).
      K: [3, 3] shared intrinsics.
      view_idx: [N, V] integer neighbor view ids per ray.
      rays_o, rays_d: [N, 3] ORIGINAL camera-space rays (not NDC).
      z3d: [N, S] 3D depths along each ray.
      split: u8 corner pack only: three word fetches a point instead of one
        row (the same values).

    Returns: colors [N, V, S, 3] (zeros where the projection left the image).
    """
    H, W = images.shape[1:3]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z3d[..., None]  # [N, S, 3]
    M = fused_mats[view_idx]  # [N, V, 3, 4]
    xn, yn = project_points(pts[:, None, :, :], M[:, :, None, :, :], K, H, W)
    vidx = view_idx[:, :, None].expand(xn.shape)
    return _sample(images, vidx, xn, yn, split)


def per_view_gather_auto(images) -> bool:
    """The policy of ``train_gather = -1`` (auto), which ``render_rays``
    consults on its training branches: always the single all-views gather
    (:func:`epipolar_colors`); ``train_gather = 1`` forces the per-view form
    (:func:`epipolar_colors_per_view`)."""
    del images
    return False


def epipolar_colors_per_view(images, fused_mats, K, view_idx, rays_o,
                             rays_d, z3d, split: bool = False):
    """:func:`epipolar_colors` restructured as one single-view gather per
    training view: all rays' points are projected into view ``v`` and
    sampled from its table alone, and each (ray, slot) takes the result of
    the view it selected (``view_idx == v``, a 0/1 mask, so the sum over
    views is exact). The same values as the all-views gather.

    Args:
      images: int32 [T, H, W, 3] :func:`build_corner_stack_u8` pack.
      view_idx: [N, V] integer per-ray neighbor view ids.
      Other args as :func:`epipolar_colors`.

    Returns: colors [N, V, S, 3].
    """
    T, H, W, _ = images.shape
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z3d[..., None]  # [N,S,3]
    zero = torch.zeros(z3d.shape, dtype=torch.int64, device=z3d.device)
    out = None
    for v in range(T):
        xn, yn = project_points(pts, fused_mats[v], K, H, W)  # [N, S]
        c = _sample(images[v:v + 1], zero, xn, yn, split)  # [N, S, 3]
        sel = (view_idx == v).to(c.dtype)  # [N, V]
        contrib = sel[:, :, None, None] * c[:, None, :, :]
        out = contrib if out is None else out + contrib
    return out


def _lerp_t_block(table, idx, wx, wy, hit, out_dtype):
    """One view's u8-pack bilinear sample emitted as the TRANSPOSED block
    ``[S*3, n]`` the fused kernels consume. Per element the same
    scale-then-lerp arithmetic as :func:`bilinear_sample_packed_u8`, so the
    values are equal bit for bit; rows are ordered (s, c) = s * 3 + c,
    matching ``epi_layout='vsc'`` per-view rows.

    table [P, 3] int32 words, idx [n, S] rows of it, wx/wy/hit [n, S]."""
    n, S = idx.shape
    out = _lerp(*_lanes(table[idx]), wx[..., None], wy[..., None], hit)
    blk = out.reshape(n, S * 3).T
    return blk if out_dtype is None else blk.to(out_dtype)


def _view_matrix(fused_mats, vid):
    """``fused_mats[vid]`` for a 0-d device tensor ``vid`` without reading
    it on the host (indexing with a 0-d tensor calls ``.item()``, a device
    sync a view)."""
    return fused_mats.index_select(0, vid.reshape(1))[0]


def _check_shared_args(images, split, transposed_out):
    if transposed_out and (not is_u8_pack(images) or split):
        raise ValueError("transposed_out needs the int32 u8 corner pack and "
                         "the row fetch (split=False)")


def epipolar_colors_shared(images, fused_mats, K, view_ids, rays_o, rays_d,
                           z3d, split: bool = False, out_dtype=None,
                           transposed_out: bool = False):
    """Epipolar colors when ALL rays share the same source views (the
    deterministic eval/inference selection).

    Args:
      images: as :func:`epipolar_colors`.
      fused_mats: [T, 3, 4] per-view fused projection (``fuse_projection``).
      K: [3, 3] shared intrinsics.
      view_ids: [V] integer source-view ids shared by every ray.
      rays_o, rays_d: [N, 3] ORIGINAL camera-space rays (not NDC).
      z3d: [N, S] 3D depths along each ray.
      split: u8 corner pack only: three word fetches a point (the same
        values).
      out_dtype: cast each view's colors to this dtype as they are sampled
        (``torch.bfloat16`` where the fused kernels consume them: they cast
        their input anyway, so valid colors are unchanged and only the
        mean-fill of invalid ones then runs in bf16).
      transposed_out: emit the kernel-consumable transposed layout
        [V, S*3, N] directly (u8 pack only; see :func:`_lerp_t_block`).
        The values are those of the default form, bit for bit.

    Returns: colors [N, V, S, 3] (zeros where the projection left the
    image), or [V, S*3, N] when ``transposed_out``.
    """
    _check_shared_args(images, split, transposed_out)
    T, H, W = images.shape[:3]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z3d[..., None]  # [N, S, 3]
    outs = []
    for v in range(int(view_ids.shape[0])):
        vid = view_ids[v]
        xn, yn = project_points(pts, _view_matrix(fused_mats, vid), K, H,
                                W)  # [N, S]
        if transposed_out:
            inb, x0, y0, wx, wy = _pixel_coords(xn, yn, H, W)
            outs.append(_lerp_t_block(
                images.reshape(T * H * W, 3),
                vid.to(torch.int64) * (H * W) + y0 * W + x0, wx, wy, inb,
                out_dtype,
            ))
            continue
        c = _sample(images, vid.expand(xn.shape), xn, yn, split)
        outs.append(c if out_dtype is None else c.to(out_dtype))
    return torch.stack(outs, dim=0 if transposed_out else 1)


def _pad_rays(n_tiles: int, n: int, o, d, z, dim: int):
    """Pad ``n`` rays (along ``dim``) to a multiple of ``n_tiles``: origins
    and depths with 0, directions with 1.0, as the JAX package pads them
    (such pads count as live rays for window placement; the frame's own
    zero-direction pads do not)."""
    n_pad = -(-n // n_tiles) * n_tiles - n
    if not n_pad:
        return o, d, z

    def pad(x, value):
        shape = list(x.shape)
        shape[dim] = n_pad
        return torch.cat([x, x.new_full(shape, value)], dim=dim)

    return pad(o, 0.0), pad(d, 1.0), pad(z, 0.0)


def _window_rows(y0, inb, live, n_tiles: int, window_rows: int, H: int,
                 ray_dim: int):
    """The source rows of a windowed gather. Rays (along ``ray_dim`` of
    ``y0`` / ``inb``) fall into ``n_tiles`` contiguous tiles; each tile's
    window of ``wr`` rows starts at the lowest row among its points that
    project into the image from a live ray (clipped so the window fits; H
    - wr when it has none), all tiles at once on the device. A point whose
    row lies outside its tile's window is marked invalid (``hit`` false).

    Returns (rows, hit): the row of each point, ``start + clip(y0 - start,
    0, wr - 1)``, and the hit mask, both shaped as ``y0``."""
    wr = min(window_rows, H)
    y = torch.where(inb & live, y0, torch.full_like(y0, H))
    y = y.movedim(ray_dim, 0)
    y_lo = y.reshape(n_tiles, -1).amin(dim=1)  # [n_tiles]
    start = torch.clamp(y_lo, 0, max(H - wr, 0))
    shape = [1] * y0.dim()
    shape[ray_dim] = y0.shape[ray_dim]
    start = start.repeat_interleave(y0.shape[ray_dim] // n_tiles).reshape(
        shape)
    y_loc = y0 - start
    hit = inb & (y_loc >= 0) & (y_loc < wr)
    return start + torch.clamp(y_loc, 0, wr - 1), hit


def _count_window_misses(inb, hit, live, n: int, ray_dim: int):
    """The device counters of a windowed gather (while they are on), over
    its first ``n`` rays along ``ray_dim`` (the rest pad a call)."""
    if not profiling.counting():
        return
    seen = (inb & live).narrow(ray_dim, 0, n)
    profiling.count("gather_in_image", seen)
    profiling.count("gather_window_miss", seen & ~hit.narrow(ray_dim, 0, n))


def epipolar_colors_shared_windowed(
    images, fused_mats, K, view_ids, rays_o, rays_d, z3d,
    n_tiles: int, window_rows: int, split: bool = False, out_dtype=None,
    transposed_out: bool = False,
):
    """Shared-view epipolar colors through per-tile SOURCE-ROW WINDOWS (the
    JAX package's full-resolution serving gather, ``gather_tiles > 0``).

    Rays arrive in target-row-major order; the batch is cut into
    ``n_tiles`` contiguous tiles (padded to a multiple as the JAX function
    pads it), and each (tile, view) reads a band of ``window_rows`` source
    rows around the tile's projected rows (:func:`_window_rows`). The corner
    pack carries each pixel's right / down neighbours, so a point inside the
    band samples exactly as :func:`epipolar_colors_shared` does; a point
    whose row lands outside it is marked invalid like an out-of-image one
    (zeros, then ``mean_fill_invalid``). With a covering window the result
    equals the unwindowed gather bit for bit.

    Args:
      images: int32 [T, H, W, 3] :func:`build_corner_stack_u8` pack.
      view_ids: [V] integer shared source-view ids.
      rays_o, rays_d: [N, 3] original camera-space rays, target-row-major;
        a ray with a zero direction (the frame renderer's pad) does not
        place windows.
      z3d: [N, S] 3D depths.
      n_tiles, window_rows: the tiles a call and the band height.
      split, out_dtype, transposed_out: as :func:`epipolar_colors_shared`.

    Returns: colors [N, V, S, 3], or [V, S*3, N] when ``transposed_out``.
    """
    _check_shared_args(images, split, transposed_out)
    if not is_u8_pack(images):
        raise ValueError("the windowed gather needs the int32 u8 corner pack")
    T, H, W, _ = images.shape
    N = z3d.shape[0]
    rays_o, rays_d, z3d = _pad_rays(n_tiles, N, rays_o, rays_d, z3d, 0)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z3d[..., None]
    live = (rays_d.abs().sum(dim=-1) > 0)[:, None]  # [Np, 1]
    table = images.reshape(T * H * W, 3)
    outs = []
    for v in range(int(view_ids.shape[0])):
        vid = view_ids[v]
        xn, yn = project_points(pts, _view_matrix(fused_mats, vid), K, H,
                                W)  # [Np, S]
        inb, x0, y0, wx, wy = _pixel_coords(xn, yn, H, W)
        rows, hit = _window_rows(y0, inb, live, n_tiles, window_rows, H, 0)
        _count_window_misses(inb, hit, live, N, 0)
        idx = vid.to(torch.int64) * (H * W) + rows * W + x0
        if transposed_out:
            outs.append(_lerp_t_block(table, idx, wx, wy, hit, out_dtype))
            continue
        if split:
            c = _split_lerp(table, idx, wx, wy, hit)
        else:
            c = _lerp(*_lanes(table[idx]), wx[..., None], wy[..., None], hit)
        outs.append(c if out_dtype is None else c.to(out_dtype))
    if transposed_out:
        return torch.stack(outs, dim=0)[..., :N]  # [V, S*3, N]
    return torch.stack(outs, dim=1)[:N]  # [N, V, S, 3]


def epipolar_colors_shared_t(images, fused_mats, K, view_ids, or_o_t, or_d_t,
                             z3d_t, n_tiles: int = 0, window_rows: int = 0):
    """Shared-view epipolar colors in the TRANSPOSED serving layout: every
    array keeps rays on the minor axis, projections and lerp weights as
    [S, N] panels, colours as [3, S, N] per view.

    Same projections and the same u8 bilinear unpack order as
    :func:`epipolar_colors_shared` (and as
    :func:`epipolar_colors_shared_windowed` when ``n_tiles > 0``): given
    equal projections the colours are equal bit for bit. The projection is
    written out as scalar multiplies and sums in f32, left to right.

    Args:
      images: int32 [T, H, W, 3] :func:`build_corner_stack_u8` pack
        (required).
      view_ids: [V] integer source-view ids shared by every ray.
      or_o_t, or_d_t: [3, N] original camera-space rays, transposed.
      z3d_t: [S, N] 3D depths, transposed.
      n_tiles / window_rows: as :func:`epipolar_colors_shared_windowed`
        (0 = unwindowed); rays must be target-row-major for windows to
        cover.

    Returns: colors_t [V, 3, S, N] float32; reshape to [V*3*S, N] for the
    (v, c, s)-ordered refine-input rows (the refine net's first-layer rows
    are permuted to match at pack time:
    ``pack_minmax_params(rest_row_perm=...)``).
    """
    if not is_u8_pack(images):
        raise ValueError("epipolar_colors_shared_t needs the int32 u8 "
                         "corner pack [T, H, W, 3]")
    T, H, W, _ = images.shape
    N = z3d_t.shape[1]
    n_tiles = n_tiles if n_tiles and n_tiles > 0 else 0
    if n_tiles:
        or_o_t, or_d_t, z3d_t = _pad_rays(n_tiles, N, or_o_t, or_d_t, z3d_t,
                                          1)
    table = images.reshape(T * H * W, 3)
    # [3, S, Np] world points: row (c, s) = o_c + d_c * z_s
    pts = or_o_t[:, None, :] + or_d_t[:, None, :] * z3d_t[None, :, :]
    live = (or_d_t.abs().sum(dim=0) > 0)[None, :]  # [1, Np]
    outs = []
    for v in range(int(view_ids.shape[0])):
        vid = view_ids[v]
        M = _view_matrix(fused_mats, vid)  # [3, 4]
        p = [
            M[i, 0] * pts[0] + M[i, 1] * pts[1] + M[i, 2] * pts[2] + M[i, 3]
            for i in range(3)
        ]  # each [S, Np]
        z = torch.abs(p[2]) + 1e-8
        u_pix = K[0, 0] * p[0] / z + K[0, 2]
        v_pix = K[1, 1] * p[1] / z + K[1, 2]
        xn = 2.0 * u_pix / (W - 1) - 1.0
        yn = 2.0 * v_pix / (H - 1) - 1.0
        inb, x0, y0, wx, wy = _pixel_coords(xn, yn, H, W)
        hit = inb
        if n_tiles:
            y0, hit = _window_rows(y0, inb, live, n_tiles, window_rows, H, 1)
            _count_window_misses(inb, hit, live, N, 1)
        rows = table[vid.to(torch.int64) * (H * W) + y0 * W + x0]  # [S, Np, 3]
        # the scale-then-lerp order of bilinear_sample_packed_u8
        c00, c01, c10, c11 = _lanes(rows.permute(2, 0, 1))  # [3, S, Np]
        top = c00 * (1.0 - wx[None]) + c01 * wx[None]
        bot = c10 * (1.0 - wx[None]) + c11 * wx[None]
        out = top * (1.0 - wy[None]) + bot * wy[None]
        outs.append(out * hit[None].to(out.dtype))
    return torch.stack(outs, dim=0)[..., :N]  # [V, 3, S, N]


def _mean_fill(colors, channel_dim: int, view_dim: int, eps: float):
    valid = (colors.sum(dim=channel_dim, keepdim=True) > 0).to(colors.dtype)
    mean = (valid * colors).sum(dim=view_dim, keepdim=True) / (
        valid.sum(dim=view_dim, keepdim=True) + eps
    )
    return colors * valid + mean * (1.0 - valid)


def mean_fill_invalid_t(colors_t, eps: float = 1e-6):
    """Transposed twin of :func:`mean_fill_invalid`: colors_t [V, 3, S, N],
    validity = channel sum > 0 per (view, sample, ray)."""
    return _mean_fill(colors_t, 1, 0, eps)


def mean_fill_invalid_sct(colors_t, eps: float = 1e-6):
    """(s, c)-row twin of :func:`mean_fill_invalid_t` for the transposed
    gather emit: colors_t [V, S, 3, N]."""
    return _mean_fill(colors_t, 2, 0, eps)


def mean_fill_invalid(colors, eps: float = 1e-6):
    """Replace invalid (all-zero) warped colors by the mean of the valid
    neighbor views at the same (ray, sample): a warp is "valid" iff its
    channel sum is > 0.

    Args:
      colors: [N, V, S, 3].

    Returns: [N, V, S, 3].
    """
    return _mean_fill(colors, -1, 1, eps)
