"""On-disk LLFF dataset fixtures (poses_bounds.npy + images/ + COLMAP
sparse model): the inverse of the loaders, for the tests and
``chip_smoke.py``.

The port's copy of ``pronerf_tpu/utils/fixtures.py``. The files are the
same, except that the images are written by ``utils/png.py`` (unfiltered
PNGs; the pixels are the same as PIL's), so that a capture can be written on
a machine without an imaging package.

The written layout mirrors a real LLFF capture directory: ``poses_bounds.npy``
rows are the flattened 3x5 [stored_pose | hwf] plus [near, far], images live
under ``images/`` (or ``images_{factor}/``, see :func:`write_llff_scene`),
and the COLMAP binary model under ``sparse/0``.
"""

from __future__ import annotations

import pathlib
import struct

import numpy as np

from pronerf_tpu_torch.utils.png import write_png


def write_llff_dataset(root, n: int = 6, H: int = 24, W: int = 32,
                       focal: float = 30.0):
    """Write a minimal on-disk LLFF dataset (poses_bounds.npy + images/)."""
    rng = np.random.default_rng(0)
    (root / "images").mkdir(parents=True)
    rows = []
    for i in range(n):
        # c2w with identity-ish rotation; store with LLFF's [down, right,
        # back] column convention (inverse of the loader's [-y, x, z] remap).
        c2w = np.concatenate(
            [np.eye(3), np.array([[0.1 * i], [0.05 * i], [0.0]])], 1
        )
        stored = np.concatenate(
            [-c2w[:, 1:2], c2w[:, 0:1], c2w[:, 2:]], 1
        )  # invert row remap
        m = np.concatenate([stored, np.array([[H], [W], [focal]])], 1)
        rows.append(np.concatenate([m.flatten(), [1.0, 10.0]]))
        img = (rng.uniform(0, 255, size=(H, W, 3))).astype(np.uint8)
        write_png(root / "images" / f"img_{i:03d}.png", img)
    np.save(root / "poses_bounds.npy", np.stack(rows))


def write_llff_scene(root, scene, stem: str = "img", factor=None):
    """Write a GENERATED scene (``utils.synthetic`` dict) as a full LLFF
    capture directory: raw ``images/`` PNGs + ``poses_bounds.npy`` + a
    geometrically-consistent COLMAP ``sparse/0`` model.

    Unlike :func:`write_llff_dataset` (random tiny fixture), this is the
    fern-scale dress-rehearsal writer: images should be at the RAW capture
    resolution (e.g. 2016x1512) so ``data/llff.py:_minify`` runs for real
    when the loader asks for ``factor=4`` (reference read side:
    ``load_llff.py:12-61,349-421``). The COLMAP points lie on the scene's
    two texture planes (z = -2.5 / -6.0 world) with TRUE projected
    visibility, so the greedy reference-view cover
    (``load_llff.py:499-547`` semantics) selects on real geometry.

    With ``factor``, the images are written straight into
    ``images_{factor}/`` as a minified capture holds them, and
    ``poses_bounds.npy`` holds the raw capture's height, width and focal
    (``factor`` times the scene's), so that the loader at that factor reads
    the scene's own size and focal without PIL.
    """
    root = pathlib.Path(root)
    images = np.asarray(scene["images"])
    poses = np.asarray(scene["poses"])
    H, W, focal = scene["hwf"]
    n = images.shape[0]
    imgdir = root / ("images" if factor is None else f"images_{factor}")
    imgdir.mkdir(parents=True, exist_ok=True)
    scale = 1 if factor is None else factor
    rows = []
    for i in range(n):
        c2w = poses[i]
        stored = np.concatenate(
            [-c2w[:, 1:2], c2w[:, 0:1], c2w[:, 2:]], 1
        )  # inverse of the loader's [-y, x, z] remap
        m = np.concatenate(
            [stored, np.array([[H], [W], [focal]], np.float64) * scale], 1
        )
        bds = scene["bds"][i]
        rows.append(np.concatenate([m.flatten(), bds]))
        img = np.clip(np.round(images[i] * 255.0), 0, 255).astype(np.uint8)
        write_png(imgdir / f"{stem}_{i:03d}.png", img)
    np.save(root / "poses_bounds.npy", np.stack(rows))

    # COLMAP sparse model with true plane geometry + projected visibility.
    rng = np.random.default_rng(11)
    n_points = 600
    pts = np.concatenate(
        [
            np.stack(
                [
                    rng.uniform(-2.0, 2.0, n_points // 2),
                    rng.uniform(-1.5, 1.5, n_points // 2),
                    np.full(n_points // 2, -2.5),
                ],
                -1,
            ),
            np.stack(
                [
                    rng.uniform(-4.0, 4.0, n_points // 2),
                    rng.uniform(-3.0, 3.0, n_points // 2),
                    np.full(n_points // 2, -6.0),
                ],
                -1,
            ),
        ]
    )
    tracks = {p: [] for p in range(n_points)}
    w2cs = []
    for v in range(n):
        R, t = poses[v][:, :3], poses[v][:, 3]
        q = (pts - t) @ R  # camera coords (OpenGL: looks along -z)
        z = -q[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = 0.5 * W + focal * q[:, 0] / z
            vv = 0.5 * H - focal * q[:, 1] / z
        vis = (z > 0.1) & (u >= 0) & (u < W) & (vv >= 0) & (vv < H)
        for p in np.nonzero(vis)[0]:
            tracks[int(p)].append(v + 1)
        # COLMAP w2c: x right, y down, z forward
        Rc = np.diag([1.0, -1.0, -1.0]) @ R.T
        w2cs.append((Rc, -Rc @ t))

    sparse = root / "sparse/0"
    sparse.mkdir(parents=True, exist_ok=True)
    with open(sparse / "images.bin", "wb") as fh:
        fh.write(struct.pack("<Q", n))
        for i in range(n):
            Rc, tc = w2cs[i]
            qvec = _rotmat_to_qvec(Rc)
            fh.write(struct.pack("<i", i + 1))
            fh.write(struct.pack("<4d", *qvec))
            fh.write(struct.pack("<3d", *tc))
            fh.write(struct.pack("<i", 1))
            fh.write(f"{stem}_{i:03d}.png".encode() + b"\x00")
            fh.write(struct.pack("<Q", 0))
    with open(sparse / "points3D.bin", "wb") as fh:
        fh.write(struct.pack("<Q", n_points))
        for p in range(n_points):
            fh.write(struct.pack("<Q", p + 1))
            fh.write(struct.pack("<3d", *pts[p]))
            fh.write(struct.pack("<3B", 128, 128, 128))
            fh.write(struct.pack("<d", 0.5))
            ims = tracks[p]
            fh.write(struct.pack("<Q", len(ims)))
            for im in ims:
                fh.write(struct.pack("<2i", im, 0))
    return root


def _rotmat_to_qvec(R):
    """Rotation matrix -> COLMAP (w, x, y, z) quaternion."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def write_colmap_model(root, n_images: int = 6, n_points: int = 40,
                       ext: str = ".bin"):
    """Write a minimal COLMAP sparse model (inverse of our readers) in
    either encoding: images/points3D ``.bin``, or the full ``.txt`` triple
    (with comment headers and a keypoint-less image, to exercise the text
    parser's skip/empty-line paths)."""
    sparse = root / "sparse/0"
    sparse.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(n_points, 3))
    # view v sees points [0 .. 5*(v+1)) -> later views see more
    tracks = {p: [] for p in range(n_points)}
    for v in range(n_images):
        for p in range(min(5 * (v + 1), n_points)):
            tracks[p].append(v + 1)

    if ext == ".bin":
        with open(sparse / "images.bin", "wb") as fh:
            fh.write(struct.pack("<Q", n_images))
            for i in range(n_images):
                fh.write(struct.pack("<i", i + 1))
                fh.write(struct.pack("<4d", 1, 0, 0, 0))
                fh.write(struct.pack("<3d", 0, 0, 0))
                fh.write(struct.pack("<i", 1))
                fh.write(f"img_{i:03d}.png".encode() + b"\x00")
                fh.write(struct.pack("<Q", 0))
        with open(sparse / "points3D.bin", "wb") as fh:
            fh.write(struct.pack("<Q", n_points))
            for p in range(n_points):
                fh.write(struct.pack("<Q", p + 1))
                fh.write(struct.pack("<3d", *pts[p]))
                fh.write(struct.pack("<3B", 128, 128, 128))
                fh.write(struct.pack("<d", 0.5))
                ims = tracks[p]
                fh.write(struct.pack("<Q", len(ims)))
                for im in ims:
                    fh.write(struct.pack("<2i", im, 0))
        return root

    with open(sparse / "cameras.txt", "w") as fh:
        fh.write("# Camera list with one line of data per camera:\n")
        fh.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        fh.write("1 PINHOLE 32 24 30.0 30.0 16.0 12.0\n")
    with open(sparse / "images.txt", "w") as fh:
        fh.write("# Image list with two lines of data per image:\n")
        fh.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, "
                 "NAME\n#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for i in range(n_images):
            fh.write(f"{i + 1} 1 0 0 0 0 0 0 1 img_{i:03d}.png\n")
            # image 1 keeps an empty keypoint line; others get one dummy
            if i == 0:
                fh.write("\n")
            else:
                fh.write(f"1.5 2.5 {min(i, n_points)}\n")
    with open(sparse / "points3D.txt", "w") as fh:
        fh.write("# 3D point list with one line of data per point:\n")
        fh.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                 "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for p in range(n_points):
            track = " ".join(f"{im} 0" for im in tracks[p])
            xyz = " ".join(repr(float(c)) for c in pts[p])
            fh.write(f"{p + 1} {xyz} 128 128 128 0.5 {track}\n")
    return root
