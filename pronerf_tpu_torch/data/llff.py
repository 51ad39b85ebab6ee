"""LLFF forward-facing dataset layer.

Counterpart of ``pronerf_tpu/data/llff.py``, with its outputs bit for bit
(the behaviour of the reference loader, itself derived from the public
Fyusion/LLFF loader):

- ``poses_bounds.npy`` holds [N, 17]: a 3x5 matrix (3x4 c2w + [h, w, f]
  column) plus [near, far] bounds per image;
- rotation columns are remapped [down, right, back] -> [right, up, back]
  via ``[-y, x, z]`` and the view axis moved to axis 0;
- translations and bounds are rescaled by 1 / (bds.min() * bd_factor);
- poses are recentered around the average pose; a spiral render path is
  generated (120 views, 2 rotations);
- the infer variant adds greedy COLMAP-visibility reference-view selection
  (with the reference's ``num_neighbor=None`` crash fixed — see
  ``data.colmap.greedy_reference_views``).

Images are read as the JAX package reads them (imageio, through PIL and
libjpeg-turbo), but by the port's own readers: 8-bit PNGs by
``utils/png.py``, baseline and progressive JPEGs (a raw capture's camera
views) by ``utils/jpeg.py``, each equal to imageio bit for bit, so a capture
loads without an imaging package; only a file they do not decode goes to
imageio or PIL. Missing downsampled sets (``images_{factor}``) are made
in-process with PIL's Lanczos, as in the JAX package, but by the port's own
copy of it (``utils/resize.py``, equal to PIL bit for bit), so a raw
capture needs no imaging package either.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pronerf_tpu_torch.data.colmap import greedy_reference_views
from pronerf_tpu_torch.utils.jpeg import UnsupportedJPEG, read_jpeg
from pronerf_tpu_torch.utils.png import UnsupportedPNG, read_png, write_png
from pronerf_tpu_torch.utils.resize import resize_lanczos

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".JPG", ".PNG", ".JPEG")


def _list_images(imgdir: Path):
    return sorted(
        p for p in imgdir.iterdir() if p.suffix in _IMG_EXTS
    )


def _read(path) -> np.ndarray:
    """The image's pixels as ``imageio.v2.imread`` returns them (uint8 [H,
    W] gray, [H, W, 2] gray and alpha, [H, W, 3] RGB, [H, W, 4] RGBA): PNGs
    by ``read_png``, JPEGs by ``read_jpeg``; a file they do not decode (or
    another format) by imageio, else PIL. Without either it raises, naming
    the file and why the port's reader did not decode it."""
    path = Path(path)
    suffix = path.suffix.lower()
    reason = "neither a PNG nor a JPEG"
    try:
        if suffix == ".png":
            return read_png(path)
        if suffix in (".jpg", ".jpeg"):
            return read_jpeg(path)
    except (UnsupportedPNG, UnsupportedJPEG) as e:
        reason = str(e)
    try:
        import imageio.v2 as imageio
    except ImportError:
        try:
            from PIL import Image as PILImage
        except ImportError:
            raise ImportError(
                f"{path}: the port's reader did not decode it ({reason}); "
                "reading it another way needs imageio or PIL, and neither "
                "is installed (8-bit PNGs and baseline or progressive JPEGs "
                "need neither)") from None
        with PILImage.open(path) as img:
            return np.asarray(img.convert("RGB"))
    return np.asarray(imageio.imread(path))


def _imread(path) -> np.ndarray:
    """The JAX package's ``_imread``: what imageio returns, then ``[...,
    :3]`` (on a gray image, [H, W], that keeps its first three columns, as
    the reference does)."""
    return _read(path)[..., :3]


def _rgb(img: np.ndarray) -> np.ndarray:
    """PIL's ``convert("RGB")`` of what :func:`_read` returns: gray copied
    into three channels, alpha dropped (not composited)."""
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] < 3:
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _minify(basedir, factor: int) -> Path:
    """Create ``images_{factor}`` next to ``images`` if missing: each image
    decoded as the JAX package's ``PIL.Image.open(p).convert("RGB")``
    decodes it (:func:`_rgb`), resized by ``utils/resize.py`` (PIL's
    Lanczos, bit for bit) to ``round(w / factor) x round(h / factor)`` and
    written as a PNG by ``utils/png.py``: no imaging package is needed for
    PNG or JPEG sources."""
    basedir = Path(basedir)
    out = basedir / f"images_{factor}"
    if out.exists():
        return out
    src = _list_images(basedir / "images")
    out.mkdir(parents=True)
    for p in src:
        img = _rgb(_read(p))
        h, w = img.shape[:2]
        write_png(out / (p.stem + ".png"),
                  resize_lanczos(img, round(w / factor), round(h / factor)))
    return out


def _load_data(basedir, factor=None, load_imgs=True):
    basedir = Path(basedir)
    if not (basedir / "poses_bounds.npy").is_file():
        raise FileNotFoundError(
            f"datadir {basedir}: no poses_bounds.npy there (an LLFF capture "
            "holds poses_bounds.npy, images/ and sparse/0)")
    arr = np.load(basedir / "poses_bounds.npy")
    poses = arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = arr[:, -2:].transpose([1, 0])

    if factor is not None and factor != 1:
        imgdir = _minify(basedir, factor)
        sfx = f"_{factor}"
    else:
        factor = 1
        imgdir = basedir / "images"
        sfx = ""

    imgfiles = _list_images(imgdir)
    if poses.shape[-1] != len(imgfiles):
        raise ValueError(
            f"{len(imgfiles)} images in images{sfx} but "
            f"{poses.shape[-1]} poses in poses_bounds.npy"
        )
    sh = _imread(imgfiles[0]).shape
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] / factor

    if not load_imgs:
        return poses, bds, None
    imgs = np.stack(
        [_imread(f).astype(np.float32) / 255.0 for f in imgfiles], -1
    )
    return poses, bds, imgs


def normalize(v):
    return v / np.linalg.norm(v)


def viewmatrix(z, up, pos):
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def poses_avg(poses):
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], 1)


def recenter_poses(poses):
    """Express all poses relative to the average pose."""
    out = poses.copy()
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = np.concatenate([poses_avg(poses)[:3, :4], bottom], -2)
    homo = np.concatenate(
        [poses[:, :3, :4], np.tile(bottom[None], [poses.shape[0], 1, 1])], -2
    )
    out[:, :3, :4] = (np.linalg.inv(c2w) @ homo)[:, :3, :4]
    return out


def render_path_spiral(c2w, up, rads, focal, zrate, rots, N):
    """Spiral of N poses around the average pose looking at a focus depth."""
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = np.dot(
            c2w[:3, :4],
            np.array(
                [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]
            )
            * rads,
        )
        z = normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        render_poses.append(np.concatenate([viewmatrix(z, up, c), hwf], 1))
    return render_poses


def spherify_poses(poses, bds):
    """360-degree normalization: recenter on the point minimizing distance
    to all camera axes, rescale to unit radius, emit a circular path."""
    def p34_to_44(p):
        return np.concatenate(
            [p, np.tile(np.reshape(np.eye(4)[-1], [1, 1, 4]), [p.shape[0], 1, 1])],
            1,
        )

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    A_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
    b_i = -A_i @ rays_o
    pt_mindist = np.squeeze(
        -np.linalg.inv((np.transpose(A_i, [0, 2, 1]) @ A_i).mean(0))
        @ (b_i).mean(0)
    )

    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = normalize(up)
    vec1 = normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)

    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad**2 - zh**2)
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array(
            [radcircle * np.cos(th), radcircle * np.sin(th), zh]
        )
        up = np.array([0, 0, -1.0])
        vec2 = normalize(camorigin)
        vec0 = normalize(np.cross(vec2, up))
        vec1 = normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, camorigin], 1))
    new_poses = np.stack(new_poses, 0)
    new_poses = np.concatenate(
        [new_poses, np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)],
        -1,
    )
    poses_reset = np.concatenate(
        [
            poses_reset[:, :3, :4],
            np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape),
        ],
        -1,
    )
    return poses_reset, new_poses, bds


def _spiral_from_poses(poses, bds, path_zflat=False):
    c2w = poses_avg(poses)
    up = normalize(poses[:, :3, 1].sum(0))
    close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    tt = poses[:, :3, 3]
    rads = np.percentile(np.abs(tt), 90, 0)
    c2w_path = c2w
    N_views, N_rots = 120, 2
    if path_zflat:
        zloc = -close_depth * 0.1
        c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
        rads[2] = 0.0
        N_rots, N_views = 1, N_views // 2
    return render_path_spiral(
        c2w_path, up, rads, focal, zrate=0.5, rots=N_rots, N=N_views
    )


def _load_and_normalize(basedir, factor, recenter, bd_factor, spherify, path_zflat):
    poses, bds, imgs = _load_data(basedir, factor=factor)
    # [down, right, back] columns -> [right, up, back]: rows [-y, x, z].
    poses = np.concatenate(
        [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1
    )
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    imgs = np.moveaxis(imgs, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds *= sc

    if recenter:
        poses = recenter_poses(poses)
    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        render_poses = _spiral_from_poses(poses, bds, path_zflat)
    render_poses = np.array(render_poses).astype(np.float32)

    c2w = poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))
    return imgs.astype(np.float32), poses, bds, render_poses, i_test


def load_llff_data(
    basedir,
    factor=8,
    recenter=True,
    bd_factor=0.75,
    spherify=False,
    path_zflat=False,
):
    """Returns (images [N,H,W,3], poses [N,3,5], bds [N,2],
    render_poses [120,3,5], i_test)."""
    return _load_and_normalize(
        basedir, factor, recenter, bd_factor, spherify, path_zflat
    )


def load_llff_data_infer(
    basedir,
    factor=8,
    recenter=True,
    bd_factor=0.75,
    spherify=False,
    path_zflat=False,
    num_neighbor=4,
    llffhold=8,
):
    """load_llff_data + greedy COLMAP-visibility reference view selection.

    Returns (..., i_test array, i_ref array). The train split here follows
    the llffhold stride (every llffhold-th view is test)."""
    images, poses, bds, render_poses, _ = _load_and_normalize(
        basedir, factor, recenter, bd_factor, spherify, path_zflat
    )
    i_test = np.arange(images.shape[0])[::llffhold]
    i_train = np.array(
        [i for i in range(images.shape[0]) if i not in i_test]
    )
    i_ref = greedy_reference_views(
        Path(basedir) / "sparse/0", i_train, num_neighbor
    )
    return images, poses, bds, render_poses, i_test, i_ref
