"""COLMAP sparse-model readers (binary + text) + greedy reference-view
selection.

Counterpart of ``pronerf_tpu/data/colmap.py``. The layouts
follow the public COLMAP format specification (cameras / images / points3D
in both ``.bin`` and ``.txt`` encodings). ``greedy_reference_views`` refuses
``num_neighbor=None`` (the reference's default, on which its release infer
path crashes).

``build_visibility_matrix`` scans a binary model's tracks with the host
runtime (``pronerf_tpu_torch/native``) whenever its library loads, as the
JAX package does; ``native=False`` takes the Python readers. Both give the
same matrix.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class Image:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3d_ids: np.ndarray


@dataclasses.dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2d_idxs: np.ndarray


# COLMAP camera model table: id -> (name, #params)
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def _read(fh, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fh.read(size))


def read_cameras_binary(path) -> Dict[int, Camera]:
    cameras = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(fh, "<iiQQ")
            name, n_params = _CAMERA_MODELS[model_id]
            params = np.array(_read(fh, f"<{n_params}d"))
            cameras[cam_id] = Camera(cam_id, name, width, height, params)
    return cameras


def read_images_binary(path) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            im_id = _read(fh, "<i")[0]
            qvec = np.array(_read(fh, "<4d"))
            tvec = np.array(_read(fh, "<3d"))
            cam_id = _read(fh, "<i")[0]
            name = b""
            while True:
                ch = fh.read(1)
                if ch == b"\x00":
                    break
                name += ch
            (n_pts,) = _read(fh, "<Q")
            data = np.array(_read(fh, f"<{3 * n_pts}d")).reshape(n_pts, 3)
            images[im_id] = Image(
                im_id, qvec, tvec, cam_id, name.decode("utf-8"),
                data[:, :2], data[:, 2].astype(np.int64),
            )
    return images


def read_points3d_binary(path) -> Dict[int, Point3D]:
    points = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            pt_id = _read(fh, "<Q")[0]
            xyz = np.array(_read(fh, "<3d"))
            rgb = np.array(_read(fh, "<3B"))
            (error,) = _read(fh, "<d")
            (track_len,) = _read(fh, "<Q")
            track = np.array(_read(fh, f"<{2 * track_len}i")).reshape(track_len, 2)
            points[pt_id] = Point3D(
                pt_id, xyz, rgb, error, track[:, 0], track[:, 1]
            )
    return points


def _model_lines(path):
    """Whitespace-token lists for non-empty, non-comment lines of a COLMAP
    text model file."""
    with open(path, "r") as fh:
        for raw in fh:
            line = raw.strip()
            if line and not line.startswith("#"):
                yield line.split()


def read_cameras_text(path) -> Dict[int, Camera]:
    """cameras.txt: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[] per line."""
    cameras = {}
    for t in _model_lines(path):
        cam_id = int(t[0])
        cameras[cam_id] = Camera(
            cam_id, t[1], int(t[2]), int(t[3]),
            np.array(t[4:], dtype=np.float64),
        )
    return cameras


def read_images_text(path) -> Dict[int, Image]:
    """images.txt: two lines per image — the header line
    (IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME) then the POINTS2D line
    (X Y POINT3D_ID triples; may be empty for images with no keypoints,
    so the second line is consumed raw rather than comment-filtered)."""
    images = {}
    with open(path, "r") as fh:
        while True:
            raw = fh.readline()
            if not raw:
                break
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            t = line.split()
            pts = fh.readline().split()
            data = (
                np.array(pts, dtype=np.float64).reshape(-1, 3)
                if pts else np.zeros((0, 3))
            )
            im_id = int(t[0])
            images[im_id] = Image(
                im_id,
                np.array(t[1:5], dtype=np.float64),
                np.array(t[5:8], dtype=np.float64),
                int(t[8]), t[9],
                data[:, :2], data[:, 2].astype(np.int64),
            )
    return images


def read_points3d_text(path) -> Dict[int, Point3D]:
    """points3D.txt: POINT3D_ID X Y Z R G B ERROR (IMAGE_ID POINT2D_IDX)*
    per line."""
    points = {}
    for t in _model_lines(path):
        pt_id = int(t[0])
        track = np.array(t[8:], dtype=np.int64).reshape(-1, 2)
        points[pt_id] = Point3D(
            pt_id,
            np.array(t[1:4], dtype=np.float64),
            np.array(t[4:7], dtype=np.int64),
            float(t[7]),
            track[:, 0], track[:, 1],
        )
    return points


def model_ext(sparse_dir) -> str:
    """Detect the model encoding present in ``sparse_dir`` (prefer .bin,
    matching COLMAP's own auto-detection order)."""
    sparse_dir = Path(sparse_dir)
    for ext in (".bin", ".txt"):
        if (sparse_dir / f"images{ext}").exists():
            return ext
    raise FileNotFoundError(
        f"no COLMAP model (images.bin/images.txt) under {sparse_dir}"
    )


def read_model(sparse_dir, ext: str | None = None):
    """Read (cameras, images, points3D) with extension dispatch.

    Parity: ``colmap_utils.py:262-269`` (which requires the caller to pass
    ``ext``); here ``ext=None`` auto-detects from the files present."""
    sparse_dir = Path(sparse_dir)
    if ext is None:
        ext = model_ext(sparse_dir)
    if ext == ".txt":
        return (
            read_cameras_text(sparse_dir / "cameras.txt"),
            read_images_text(sparse_dir / "images.txt"),
            read_points3d_text(sparse_dir / "points3D.txt"),
        )
    return (
        read_cameras_binary(sparse_dir / "cameras.bin"),
        read_images_binary(sparse_dir / "images.bin"),
        read_points3d_binary(sparse_dir / "points3D.bin"),
    )


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion to rotation matrix."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def build_visibility_matrix(sparse_dir, i_train,
                            native: bool = True) -> np.ndarray:
    """[len(i_train), n_points3d] binary matrix: train view sees 3D point.

    Images are matched to dataset order by sorting on filename (LLFF loads
    images sorted by name), mirroring the reference's index mapping.
    """
    sparse_dir = Path(sparse_dir)
    ext = model_ext(sparse_dir)
    read_images = read_images_binary if ext == ".bin" else read_images_text
    imdata = read_images(sparse_dir / f"images{ext}")
    ordered = sorted(imdata.values(), key=lambda im: im.name)
    image_id_to_dataset_idx = {im.id: i for i, im in enumerate(ordered)}
    i_train = list(i_train)
    train_rank = {idx: r for r, idx in enumerate(i_train)}

    if native and ext == ".bin":
        # Fast path: single-pass C++ track scan (native/csrc/;
        # binary models only — text models are small enough to parse here).
        from pronerf_tpu_torch.native import colmap_visibility_native

        max_id = max(image_id_to_dataset_idx) if image_id_to_dataset_idx else 0
        rank_map = np.full((max_id + 1,), -1, np.int32)
        for im_id, ds_idx in image_id_to_dataset_idx.items():
            rank_map[im_id] = train_rank.get(ds_idx, -1)
        vis = colmap_visibility_native(
            sparse_dir / "points3D.bin", rank_map, len(i_train)
        )
        if vis is not None:
            return vis

    read_points = read_points3d_binary if ext == ".bin" else read_points3d_text
    pts3d = read_points(sparse_dir / f"points3D{ext}")
    vis = np.zeros((len(i_train), len(pts3d)), dtype=np.float32)
    for col, pt in enumerate(pts3d.values()):
        for im_id in pt.image_ids:
            ds_idx = image_id_to_dataset_idx.get(int(im_id))
            if ds_idx is not None and ds_idx in train_rank:
                vis[train_rank[ds_idx], col] = 1.0
    return vis


def greedy_reference_views(sparse_dir, i_train, num_neighbor: int,
                           native: bool = True) -> np.ndarray:
    """Greedy max-coverage selection of ``num_neighbor`` reference views.

    Repeatedly picks the training view covering the most not-yet-covered 3D
    points, then removes the covered points. Returns dataset indices.
    ``native`` selects how the visibility matrix is read (see
    :func:`build_visibility_matrix`); the pick is the same.
    """
    if num_neighbor is None or num_neighbor < 1:
        raise ValueError(
            "num_neighbor must be a positive int (the reference's release "
            "infer path crashes on its None default; pass the config value)"
        )
    vis = build_visibility_matrix(sparse_dir, i_train, native)
    chosen: List[int] = []
    for _ in range(num_neighbor):
        totals = vis.sum(-1)
        best = int(np.argmax(totals))
        if totals[best] <= 0:
            # All points covered: fall back to any remaining view rather
            # than crashing (reference breakpoints here).
            remaining = [i for i in range(len(i_train)) if i not in chosen]
            best = remaining[0] if remaining else best
        chosen.append(best)
        vis = np.clip(vis - vis[best][None], 0.0, None)
    return np.asarray(i_train)[chosen]
