"""Epipolar inverse warping: project candidate sample points into neighboring
source views and fetch bilinearly-interpolated colors.

- ``grid_sample(align_corners=True, padding_mode='zeros')`` semantics are an
  explicit out-of-bounds mask over a 4-corner gather + lerp;
- the per-view projection matrix is pre-fused into ``M = F @ [R^T | -R^T t]``
  (F = diag(1,-1,-1)) so the per-point work is one small product and a
  perspective divide with ``|z|``;
- the geometry is full float32: the small products are written as multiplies
  and sums, so no TF32 or bf16 path can touch them.

The deterministic shared-view path of the JAX module: the row-major gather
``epipolar_colors_shared``, its transposed emit (``transposed_out``) and the
fully transposed ``epipolar_colors_shared_t`` of the transposed serving
graph, each with its mean fill; and the training path's all-views gather
``epipolar_colors`` (per-ray neighbor views). The windowed, split, per-view
and nearest-neighbor forms are not ported yet.
"""

from __future__ import annotations

import torch


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


def _pixel_coords(xn, yn, H: int, W: int):
    inb = (xn >= -1.0) & (xn <= 1.0) & (yn >= -1.0) & (yn <= 1.0)
    u = torch.clamp((xn + 1.0) * 0.5 * (W - 1), 0.0, W - 1)
    v = torch.clamp((yn + 1.0) * 0.5 * (H - 1), 0.0, H - 1)
    x0 = torch.floor(u).to(torch.int64)
    y0 = torch.floor(v).to(torch.int64)
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

    def lane(shift):
        return ((rows >> shift) & 0xFF).to(torch.float32) * (1.0 / 255.0)

    return _lerp(lane(0), lane(8), lane(16), lane(24),
                 wx[..., None], wy[..., None], inb)


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


def epipolar_colors(images, fused_mats, K, view_idx, rays_o, rays_d, z3d):
    """Colors of candidate sample points as seen from per-ray neighbor views
    (the training path: every ray has its own views).

    Args:
      images: [T, H, W, 3] float source images, a [T, H, W, 12]
        :func:`build_corner_stack`, or an int32 [T, H, W, 3]
        :func:`build_corner_stack_u8`.
      fused_mats: [T, 3, 4] per-view fused projection (``fuse_projection``).
      K: [3, 3] shared intrinsics.
      view_idx: [N, V] integer neighbor view ids per ray.
      rays_o, rays_d: [N, 3] ORIGINAL camera-space rays (not NDC).
      z3d: [N, S] 3D depths along each ray.

    Returns: colors [N, V, S, 3] (zeros where the projection left the image).
    """
    T, H, W, C = images.shape
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z3d[..., None]  # [N, S, 3]
    M = fused_mats[view_idx]  # [N, V, 3, 4]
    xn, yn = project_points(pts[:, None, :, :], M[:, :, None, :, :], K, H, W)
    vidx = view_idx[:, :, None].expand(xn.shape)
    if is_u8_pack(images):
        return bilinear_sample_packed_u8(images, vidx, xn, yn)
    if C == 12:
        return bilinear_sample_packed(images, vidx, xn, yn)
    return bilinear_sample(images, vidx, xn, yn)


def per_view_gather_auto(images) -> bool:
    """The policy of ``train_gather = -1`` (auto), which ``render_rays``
    consults on its training branches: always the single all-views gather
    (:func:`epipolar_colors`). The per-view form (``train_gather = 1``) is
    not ported yet."""
    del images
    return False


def _lerp_t_block(table, idx, wx, wy, hit, out_dtype):
    """One view's u8-pack bilinear sample emitted as the TRANSPOSED block
    ``[S*3, n]`` the fused kernels consume. Per element the same
    scale-then-lerp arithmetic as :func:`bilinear_sample_packed_u8`, so the
    values are equal bit for bit; rows are ordered (s, c) = s * 3 + c,
    matching ``epi_layout='vsc'`` per-view rows.

    table [P, 3] int32 words, idx [n, S] rows of it, wx/wy/hit [n, S]."""
    n, S = idx.shape
    rows = table[idx]  # [n, S, 3] words

    def lane(shift):
        return ((rows >> shift) & 0xFF).to(torch.float32) * (1.0 / 255.0)

    out = _lerp(lane(0), lane(8), lane(16), lane(24),
                wx[..., None], wy[..., None], hit)
    blk = out.reshape(n, S * 3).T
    return blk if out_dtype is None else blk.to(out_dtype)


def epipolar_colors_shared(images, fused_mats, K, view_ids, rays_o, rays_d,
                           z3d, out_dtype=None, transposed_out: bool = False):
    """Epipolar colors when ALL rays share the same source views (the
    deterministic eval/inference selection).

    Args:
      images: [T, H, W, 3] float source images, a [T, H, W, 12]
        :func:`build_corner_stack`, or an int32 [T, H, W, 3]
        :func:`build_corner_stack_u8`.
      fused_mats: [T, 3, 4] per-view fused projection (``fuse_projection``).
      K: [3, 3] shared intrinsics.
      view_ids: [V] integer source-view ids shared by every ray.
      rays_o, rays_d: [N, 3] ORIGINAL camera-space rays (not NDC).
      z3d: [N, S] 3D depths along each ray.
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
    T, H, W, C = images.shape
    if transposed_out and not is_u8_pack(images):
        raise ValueError("transposed_out needs the int32 u8 corner pack")
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z3d[..., None]  # [N, S, 3]
    outs = []
    for v in range(int(view_ids.shape[0])):
        vid = view_ids[v]
        xn, yn = project_points(pts, fused_mats[vid], K, H, W)  # [N, S]
        if transposed_out:
            inb, x0, y0, wx, wy = _pixel_coords(xn, yn, H, W)
            outs.append(_lerp_t_block(
                images.reshape(T * H * W, 3),
                vid.to(torch.int64) * (H * W) + y0 * W + x0, wx, wy, inb,
                out_dtype,
            ))
            continue
        vidx = vid.expand(xn.shape)
        if images.dtype == torch.int32:
            c = bilinear_sample_packed_u8(images, vidx, xn, yn)
        elif C == 12:
            c = bilinear_sample_packed(images, vidx, xn, yn)
        else:
            c = bilinear_sample(images, vidx, xn, yn)
        outs.append(c if out_dtype is None else c.to(out_dtype))
    return torch.stack(outs, dim=0 if transposed_out else 1)


def epipolar_colors_shared_t(images, fused_mats, K, view_ids, or_o_t, or_d_t,
                             z3d_t, n_tiles: int = 0, window_rows: int = 0):
    """Shared-view epipolar colors in the TRANSPOSED serving layout: every
    array keeps rays on the minor axis, projections and lerp weights as
    [S, N] panels, colours as [3, S, N] per view.

    Same projections and the same u8 bilinear unpack order as
    :func:`epipolar_colors_shared`: given equal projections the colours are
    equal bit for bit. The projection is written out as scalar multiplies
    and sums in f32, left to right.

    Args:
      images: int32 [T, H, W, 3] :func:`build_corner_stack_u8` pack
        (required).
      view_ids: [V] integer source-view ids shared by every ray.
      or_o_t, or_d_t: [3, N] original camera-space rays, transposed.
      z3d_t: [S, N] 3D depths, transposed.
      n_tiles / window_rows: the windowed form (source-row windows per ray
        tile) is not ported yet; ``n_tiles > 0`` raises.

    Returns: colors_t [V, 3, S, N] float32; reshape to [V*3*S, N] for the
    (v, c, s)-ordered refine-input rows (the refine net's first-layer rows
    are permuted to match at pack time:
    ``pack_minmax_params(rest_row_perm=...)``).
    """
    if n_tiles and n_tiles > 0:
        raise NotImplementedError(
            "the windowed transposed gather (n_tiles > 0) is not ported to "
            "pronerf_tpu_torch yet"
        )
    if not is_u8_pack(images):
        raise ValueError("epipolar_colors_shared_t needs the int32 u8 "
                         "corner pack [T, H, W, 3]")
    T, H, W, _ = images.shape
    table = images.reshape(T * H * W, 3)
    # [3, S, N] world points: row (c, s) = o_c + d_c * z_s
    pts = or_o_t[:, None, :] + or_d_t[:, None, :] * z3d_t[None, :, :]
    outs = []
    for v in range(int(view_ids.shape[0])):
        vid = view_ids[v]
        M = fused_mats[vid]  # [3, 4]
        p = [
            M[i, 0] * pts[0] + M[i, 1] * pts[1] + M[i, 2] * pts[2] + M[i, 3]
            for i in range(3)
        ]  # each [S, N]
        z = torch.abs(p[2]) + 1e-8
        u_pix = K[0, 0] * p[0] / z + K[0, 2]
        v_pix = K[1, 1] * p[1] / z + K[1, 2]
        xn = 2.0 * u_pix / (W - 1) - 1.0
        yn = 2.0 * v_pix / (H - 1) - 1.0
        inb, x0, y0, wx, wy = _pixel_coords(xn, yn, H, W)
        rows = table[vid.to(torch.int64) * (H * W) + y0 * W + x0]  # [S, N, 3]
        rows_t = rows.permute(2, 0, 1)  # [3, S, N] words

        def lane(shift):
            return ((rows_t >> shift) & 0xFF).to(torch.float32) * (1.0 / 255.0)

        # the scale-then-lerp order of bilinear_sample_packed_u8
        c00, c01, c10, c11 = lane(0), lane(8), lane(16), lane(24)
        top = c00 * (1.0 - wx[None]) + c01 * wx[None]
        bot = c10 * (1.0 - wx[None]) + c11 * wx[None]
        out = top * (1.0 - wy[None]) + bot * wy[None]
        outs.append(out * inb[None].to(out.dtype))
    return torch.stack(outs, dim=0)  # [V, 3, S, N]


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
