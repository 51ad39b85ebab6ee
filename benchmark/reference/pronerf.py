"""A plain float32 ProNeRF in PyTorch: the benchmark's reference.

It follows the published pipeline (ProNeRF, arXiv:2312.08136, and the
release configs under ``configs/llff/fern/``), one ray batch at a time:

1. sampler MLP on the Pluecker coordinates of 48 fixed NDC points of the
   ray -> S depths (sigmoid into [near, far]), S density additions, S
   density multipliers, an auxiliary rgb;
2. depths sorted (the corrections move with them) and lifted to metric
   depth 1 / (1 - z - eps);
3. the candidates projected into the neighbour views (serving: the V
   views nearest the target pose, shared; training: per-ray views at the
   step's positions in each ray's distance order), colours sampled
   bilinearly (corners aligned, zero outside the image), an invalid colour
   (all channels 0) replaced by the mean of the valid views;
4. refine MLP on [Pluecker(candidates) || colours] -> a depth inside each
   candidate's bin, 3-D offsets (tanh, x 1e-2), an auxiliary rgb;
5. training only: stage-1 exploration (n_mult shifted copies, one-sided
   jitter) on the NeRF step;
6. the NeRF MLP (8 x 256, skip after layer 4, 128-wide view branch) on the
   positionally encoded points and directions, then alpha compositing with
   the sampler's corrections.

Weights are a dict ``'<net>.<layer>.weight|bias'`` of tensors, ``weight``
stored [out, in]. Every product is a float32 matrix product with TF32 off;
``quant`` (a function of a tensor) rounds both operands of every MLP
product first, which is how the control runs the same arithmetic in a lower
precision. It imports nothing of the program.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from .scene import ndc_rays, rays_for_pose

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NERF_DEPTH, MM_DEPTH, NERF_SKIP = 8, 6, 4
FRAME_KEYS = ("rgb1", "rgb0", "mm_rgb", "depth", "depth0")

SERVE = dict(near=0.0, far=1.0, eps=1e-5, layout="vsc", frozen=False,
             explore=False, offsets=True, use_mm=True, clamp=False,
             noise_std=0.0)
STAGE1_NERF = dict(SERVE, near=1e-6, eps=1e-6, layout="svc", frozen=True,
                   explore=True, offsets=False, use_mm=False, clamp=True,
                   noise_std=1.0)
STAGE1_SAMPLER = dict(SERVE, near=1e-6, eps=1e-6, layout="svc", clamp=True)


# --------------------------------------------------------------- weights --

def _layer(out, name, p, device):
    out[f"{name}.weight"] = torch.as_tensor(
        np.asarray(p["w"], np.float32).T.copy(), device=device)
    out[f"{name}.bias"] = torch.as_tensor(
        np.asarray(p["b"], np.float32).copy(), device=device)


def weights_from_tree(nerf, sampler, refine, device="cpu"):
    """The three nets of a JAX pytree (``w`` [in, out]) as the reference's
    weight dict."""
    out = {}
    for i, p in enumerate(nerf["pts"]):
        _layer(out, f"nerf.pts.{i}", p, device)
    for name in ("alpha", "feature", "views", "rgb"):
        _layer(out, f"nerf.{name}", nerf[name], device)
    for net, tree in (("sampler", sampler), ("refine", refine)):
        for i, p in enumerate(tree["layers"]):
            _layer(out, f"{net}.layers.{i}", p, device)
        _layer(out, f"{net}.out", tree["out"], device)
    return out


# ------------------------------------------------------------------ nets --

def _lin(P, name, x, quant):
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    if quant is not None:
        x, w = quant(x), quant(w)
    return x @ w.T + b


def minmax(P, net, x, quant=None):
    h = x
    for i in range(MM_DEPTH):
        h = F.elu(_lin(P, f"{net}.layers.{i}", h, quant))
    return _lin(P, f"{net}.out", h, quant)


def nerf(P, x_pe, d_pe, quant=None):
    h = x_pe
    for i in range(NERF_DEPTH):
        h = torch.relu(_lin(P, f"nerf.pts.{i}", h, quant))
        if i == NERF_SKIP:
            h = torch.cat([x_pe, h], -1)
    alpha = _lin(P, "nerf.alpha", h, quant)
    feature = _lin(P, "nerf.feature", h, quant)
    h = torch.relu(_lin(P, "nerf.views", torch.cat([feature, d_pe], -1),
                        quant))
    return torch.cat([_lin(P, "nerf.rgb", h, quant), alpha], -1)


def posenc(x, n_freqs):
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)]."""
    out = [x]
    for k in range(n_freqs):
        out += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(out, -1)


def plucker(pts, d):
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp_min(1e-12)
    d = d.expand(pts.shape)
    return torch.cat([d, torch.linalg.cross(pts, d, dim=-1)], -1)


# ------------------------------------------------------------ the warp --

def _project(pts, c2w, K, H, W):
    """Normalized coords in [-1, 1] (corners aligned) of world points in
    the camera ``c2w`` (looking down -z): x / |z|, y / |z|."""
    R, t = c2w[..., :3, :3], c2w[..., :3, 3]
    p = ((pts - t)[..., None, :] * R.transpose(-1, -2)).sum(-1)
    z = p[..., 2].abs() + 1e-8
    u = K[0][0] * p[..., 0] / z + K[0][2]
    v = -K[1][1] * p[..., 1] / z + K[1][2]
    return 2.0 * u / (W - 1) - 1.0, 2.0 * v / (H - 1) - 1.0


def _bilinear(images, view, xn, yn):
    """Bilinear sample of ``images`` [T, H, W, 3] at view ids ``view``,
    corners aligned, zeros outside [-1, 1]."""
    T, H, W, _ = images.shape
    inb = (xn >= -1) & (xn <= 1) & (yn >= -1) & (yn <= 1)
    u = ((xn + 1) * 0.5 * (W - 1)).clamp(0, W - 1)
    v = ((yn + 1) * 0.5 * (H - 1)).clamp(0, H - 1)
    x0, y0 = u.floor().long().clamp(0, W - 1), v.floor().long().clamp(0, H - 1)
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    wx, wy = (u - x0)[..., None], (v - y0)[..., None]
    flat = images.reshape(-1, 3)
    base = view.long() * (H * W)

    def px(y, x):
        return flat[base + y * W + x]

    top = px(y0, x0) * (1 - wx) + px(y0, x1) * wx
    bot = px(y1, x0) * (1 - wx) + px(y1, x1) * wx
    return (top * (1 - wy) + bot * wy) * inb[..., None]


def epipolar_colors(scene, views, or_o, or_d, z3d, window_rows=0):
    """[N, V, S, 3] colours of the points ``o + d z3d`` in the views
    ``views`` ([V] shared, or [N, V] per ray), invalid ones mean-filled.

    ``window_rows > 0``: the served form's source-row window, the batch
    being one tile: a point is invalid unless its top source row lies in
    the band of ``window_rows`` rows that starts at the lowest top row of
    the batch's in-image points in that view (clipped so the band fits)."""
    images, poses, K = scene["images"], scene["poses"], scene["K"]
    H, W = images.shape[1:3]
    pts = or_o[:, None, :] + or_d[:, None, :] * z3d[..., None]  # [N, S, 3]
    if views.dim() == 1:
        views = views[None].expand(pts.shape[0], -1)
    c2w = poses[views][:, :, None]  # [N, V, 1, 3, 4]
    xn, yn = _project(pts[:, None], c2w, K, H, W)  # [N, V, S]
    col = _bilinear(images, views[:, :, None].expand(xn.shape), xn, yn)
    if window_rows:
        wr = min(window_rows, H)
        inb = (xn >= -1) & (xn <= 1) & (yn >= -1) & (yn <= 1)
        y0 = ((yn + 1) * 0.5 * (H - 1)).clamp(0, H - 1).floor()
        lo = torch.where(inb, y0, torch.full_like(y0, H)).amin(dim=(0, 2))
        start = lo.clamp(0, max(H - wr, 0))[None, :, None]
        col = col * ((y0 >= start) & (y0 < start + wr))[..., None]
    valid = (col.sum(-1, keepdim=True) > 0).float()
    mean = (valid * col).sum(1, keepdim=True) / (
        valid.sum(1, keepdim=True) + 1e-6)
    return col * valid + mean * (1 - valid)


# ---------------------------------------------------------- compositing --

def composite(raw, z, d, mm_add=None, mm_mul=None, noise=None, clamp=False,
              num_valid=None):
    if clamp:
        raw = raw.clamp(-10.0, 10.0)
    S = z.shape[-1]
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)],
                      -1)
    idx = torch.arange(S, device=z.device)
    if num_valid is not None:
        dists = torch.where(idx == num_valid - 1, torch.full_like(dists, 1e10),
                            dists)
    dists = dists * torch.linalg.norm(d, dim=-1, keepdim=True)
    a = raw[..., 3]
    for extra in (noise, mm_add):
        if extra is not None:
            a = a + extra
    alpha = 1.0 - torch.exp(-torch.relu(a) * dists)
    if mm_mul is not None:
        alpha = alpha * torch.relu(mm_mul)
    if num_valid is not None:
        alpha = torch.where(idx < num_valid, alpha, torch.zeros_like(alpha))
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
    w = alpha * trans
    return {"rgb": (w[..., None] * torch.sigmoid(raw[..., :3])).sum(1),
            "depth": (w * z).sum(-1)}


# ------------------------------------------------------------ exploration --

def _neighbours(z, near, far):
    nxt = torch.cat([z[:, 1:], torch.full_like(z[:, :1], far)], -1)
    prv = torch.cat([torch.full_like(z[:, :1], near), z[:, :-1]], -1)
    return nxt, prv


def explore(z, n_mult: int, up: bool, jitter_up: bool, noise, near, far,
            width: int):
    """Stage-1 exploration: ``n_mult`` copies of each sample, copy m moved
    m / n_mult of the way to the next (``up``) or previous sample, the rest
    of ``width`` parked at ``far``; sorted; then each valid sample jittered
    by min(|noise| / 5, 0.99) of its gap, on the side ``jitter_up``.
    Returns (z [N, width], number of valid samples)."""
    N, S = z.shape
    n_valid = S * n_mult
    nxt, prv = _neighbours(z, near, far)
    gap = (nxt - z).abs() if up else -(z - prv).abs()
    j = torch.arange(width, device=z.device)
    s = (j // n_mult).clamp(max=S - 1)
    frac = (j % n_mult).float() / float(n_mult)
    zz = z[:, s] + frac * gap[:, s]
    zz = torch.where(j < n_valid, zz, torch.full_like(zz, far))
    zz = torch.sort(zz, dim=-1, stable=True).values
    nxt, prv = _neighbours(zz, near, far)
    mag = (noise[:, :width].abs() / 5.0).clamp(max=0.99)
    jit = zz + mag * (zz - nxt).abs() if jitter_up \
        else zz - mag * (zz - prv).abs()
    return torch.where(j < n_valid, jit, torch.full_like(jit, far)), n_valid


# ------------------------------------------------------------- the render --

def render_rays(P, rays, scene, views, st, N_samples=8, n_enc=48,
                quant=None, ctl=None, window_rows=0):
    """One batch of rays under the statics ``st`` (``SERVE``,
    ``STAGE1_NERF``, ``STAGE1_SAMPLER``). ``rays``: ndc_o, ndc_d, or_o,
    or_d, viewdirs [N, 3]; ``views``: the neighbour view ids, [V] or
    [N, V]; ``ctl`` (training): n_mult, dir_expand, dir_jitter (host
    values), raw_noise, jitter_noise [N, >= width]."""
    S, near, far = N_samples, st["near"], st["far"]
    o, d = rays["ndc_o"], rays["ndc_d"]
    N = o.shape[0]
    frozen = torch.no_grad() if st["frozen"] else contextlib.nullcontext()

    t = torch.linspace(0.0, 1.0, n_enc, device=o.device)
    sig = plucker(o[:, None] + d[:, None] * t[None, :, None], d[:, None])
    with frozen:
        mm = minmax(P, "sampler", sig.reshape(N, -1), quant)
    depth = torch.sigmoid(mm[:, :S]) * (far - near) + near
    depth, order = torch.sort(depth, dim=-1, stable=True)
    mm_add = mm[:, S:2 * S].gather(1, order)
    mm_mul = mm[:, 2 * S:3 * S].gather(1, order)
    z3d = (1.0 / (1.0 - depth - st["eps"])).detach()

    with torch.no_grad():
        col = epipolar_colors(scene, views, rays["or_o"], rays["or_d"], z3d,
                              window_rows)
    if st["layout"] == "svc":
        col = col.transpose(1, 2)
    plk = plucker(o[:, None] + d[:, None] * depth[..., None], d[:, None])
    with frozen:
        ref = minmax(P, "refine",
                     torch.cat([plk.reshape(N, -1), col.reshape(N, -1)], -1),
                     quant)
    mids = 0.5 * (depth[:, 1:] + depth[:, :-1])
    upper = torch.cat([mids, 0.5 * (far + depth[:, -1:])], -1)
    lower = torch.cat([0.5 * (near + depth[:, :1]), mids], -1)
    z = lower + (upper - lower) * torch.sigmoid(ref[:, :S])

    n_valid = noise = None
    if st["explore"]:
        z, n_valid = explore(z, int(ctl["n_mult"]), bool(ctl["dir_expand"]),
                             bool(ctl["dir_jitter"]), ctl["jitter_noise"],
                             near, far, ctl["width"])
    if st["noise_std"] > 0:
        noise = st["noise_std"] * ctl["raw_noise"][:, :z.shape[1]]
    pts = o[:, None] + d[:, None] * z[..., None]
    if st["offsets"]:
        pts = pts + 1e-2 * torch.tanh(ref[:, S:4 * S]).reshape(N, S, 3)
    d_pe = posenc(rays["viewdirs"], 4)[:, None].expand(N, z.shape[1], 27)
    raw = nerf(P, posenc(pts, 10), d_pe, quant)
    use = st["use_mm"]
    comp = composite(raw, z, d, mm_add if use else None,
                     mm_mul if use else None, noise, st["clamp"], n_valid)
    return {"rgb1": comp["rgb"], "depth": comp["depth"],
            "rgb0": torch.sigmoid(ref[:, 4 * S:]),
            "mm_rgb": torch.sigmoid(mm[:, 3 * S:]),
            "depth0": z.detach().mean(-1)}


# A served frame gathers through source-row windows where one 8-bit
# corner-packed view (12 bytes a pixel) exceeds this many bytes: the JAX
# package's rule, which the port keeps (``gather_tiles = -1``).
WINDOW_CLIFF_BYTES = 2.4e6


def window_rule(H: int, W: int):
    """``(tiles, window rows)`` of a served H x W frame (one call a frame),
    or None below the cliff: the rows of each window those that fit under
    the cliff, the frame cut into tiles of about half a window's rows."""
    if H * W * 12 <= WINDOW_CLIFF_BYTES:
        return None
    wr = max(64, int(WINDOW_CLIFF_BYTES // (W * 12)))
    return max(1, round(H / max(wr // 2, 1))), wr


@torch.no_grad()
def render_frame(P, scene, c2w, H: int, W: int, K, num_neighbor: int = 4,
                 block: int = 1 << 16, quant=None, windows=None):
    """The frame a viewer at ``c2w`` ([3, 4] on the weights' device) sees:
    rgb1, rgb0, mm_rgb [H, W, 3], depth, depth0 [H, W], computed in blocks
    of ``block`` rays. The neighbours are the ``num_neighbor`` views of
    ``scene`` nearest the camera (ties by index). ``windows``: ``(tiles,
    window rows)`` of the served form's windowed gather (``window_rule``),
    a block a tile."""
    window_rows = 0
    if windows is not None:
        tiles, window_rows = windows
        if (H * W) % tiles:
            raise ValueError(f"{H}x{W} rays do not cut into {tiles} tiles")
        block = H * W // tiles
    or_o, or_d = rays_for_pose(H, W, K, c2w)
    dist = torch.linalg.norm(scene["poses"][:, :3, 3] - c2w[:3, 3], dim=-1)
    views = torch.argsort(dist, stable=True)[:num_neighbor]
    outs = {k: [] for k in FRAME_KEYS}
    for lo in range(0, H * W, block):
        o, d = or_o[lo:lo + block], or_d[lo:lo + block]
        n_o, n_d = ndc_rays(H, W, float(K[0][0]), o, d)
        rays = {"ndc_o": n_o, "ndc_d": n_d, "or_o": o, "or_d": d,
                "viewdirs": d / torch.linalg.norm(d, dim=-1, keepdim=True)}
        out = render_rays(P, rays, scene, views, SERVE, quant=quant,
                          window_rows=window_rows)
        for k in FRAME_KEYS:
            outs[k].append(out[k])
    shapes = {"depth": (H, W), "depth0": (H, W)}
    return {k: torch.cat(v).reshape(shapes.get(k, (H, W, 3)))
            for k, v in outs.items()}


def fp8(x):
    """``x`` rounded to float8 e4m3 with one scale a tensor (its largest
    magnitude to 448), back in float32: the control's precision."""
    s = 448.0 / x.detach().abs().amax().clamp_min(1e-30)
    return (x * s).to(torch.float8_e4m3fn).float() / s
