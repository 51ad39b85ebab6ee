"""The port's data layer against the JAX package's, on the CPU: the PNG
reader (against imageio), the fixtures, the COLMAP readers, the visibility
matrix and the greedy reference views, and the LLFF loaders.

Captures are written by the JAX package's own ``utils/fixtures.py`` (PIL
PNGs, which use the Sub, Up and Paeth row filters) unless a test is about
the port's fixtures. Every numpy output must equal the JAX package's bit for
bit, with its dtype: images, poses, bounds, render poses, ``i_test``,
``i_ref`` and the visibility matrix; for both COLMAP model formats, with
and without ``spherify``, and on the native (host runtime) and the Python
path of each package.
"""

import dataclasses
import struct
import sys
import zlib

import numpy as np
import pytest

from pronerf_tpu.data import colmap as j_colmap
from pronerf_tpu.data import llff as j_llff
from pronerf_tpu.utils import fixtures as j_fix
from pronerf_tpu.utils.synthetic import make_consistent_scene
from pronerf_tpu_torch.data import colmap as t_colmap
from pronerf_tpu_torch.data import llff as t_llff
from pronerf_tpu_torch.utils import fixtures as t_fix
from pronerf_tpu_torch.utils import png


def assert_same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


# ------------------------------------------------------------------ PNG --

def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_filtered_png(path, img, ftypes):
    """An 8-bit RGB / RGBA PNG whose row r is stored with filter
    ``ftypes[r]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, bpp = img.shape
    x = img.astype(np.int32)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c)]
    ft = np.asarray(ftypes, np.uint8)
    rows = np.stack([(x[r] - preds[ft[r]][r]) & 255 for r in range(h)])
    raw = np.concatenate([ft[:, None], rows.astype(np.uint8).reshape(h, -1)],
                         1)
    color = 2 if bpp == 3 else 6
    with open(path, "wb") as fh:
        fh.write(png._SIGNATURE)
        fh.write(png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                                 0, 0, 0)))
        # two IDAT chunks, as encoders split long streams
        z = zlib.compress(raw.tobytes())
        fh.write(png._chunk(b"IDAT", z[:len(z) // 2]))
        fh.write(png._chunk(b"IDAT", z[len(z) // 2:]))
        fh.write(png._chunk(b"IEND", b""))


def _photo(h, w, bpp, seed=0):
    """Smooth ramps, repeated rows, noise and flat bands: rows on which an
    adaptive encoder picks different filters."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 5) % 256, (y * 3 + x) % 256, (x * y) % 256,
                    (x + 2 * y) % 256][:bpp], -1)
    a, b, c, d = (h * k // 5 for k in range(1, 5))
    img[a:b] = img[a - 1]
    img[b:c] = rng.integers(0, 256, (c - b, w, bpp))
    img[d:] = 128
    return img.astype(np.uint8)


@pytest.mark.parametrize("bpp", [3, 4])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
def test_read_png_every_filter_equals_imageio(tmp_path, bpp, ftype):
    import imageio.v2 as imageio

    img = _photo(37, 29, bpp)
    ftypes = (np.random.default_rng(1).integers(0, 5, 37)
              if ftype == "mixed" else [ftype] * 37)
    path = tmp_path / "f.png"
    write_filtered_png(path, img, ftypes)
    got = png.read_png(path)
    assert_same(got, imageio.imread(path))
    assert_same(got, img)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_read_png_of_pil_equals_imageio(tmp_path, mode):
    import imageio.v2 as imageio
    from PIL import Image

    img = _photo(64, 48, len(mode))
    path = tmp_path / "p.png"
    Image.fromarray(img, mode).save(path)
    raw = zlib.decompress(b"".join(_idat_chunks(path.read_bytes())))
    filters = set(np.frombuffer(raw, np.uint8).reshape(64, -1)[:, 0])
    assert {1, 2, 4} <= filters  # PIL's adaptive choice (it never picks 3)
    assert_same(png.read_png(path), imageio.imread(path))
    # and the writer's own (unfiltered) PNGs read back
    png.write_png(tmp_path / "w.png", img[..., :3])
    assert_same(png.read_png(tmp_path / "w.png"), img[..., :3])


def _idat_chunks(data):
    pos = 8
    while pos < len(data):
        n, tag = struct.unpack_from(">I4s", data, pos)
        if tag == b"IDAT":
            yield data[pos + 8:pos + 8 + n]
        pos += 12 + n


def test_other_images_go_through_imageio_or_pil_and_else_raise(
        tmp_path, monkeypatch):
    import imageio.v2 as imageio
    from PIL import Image

    from pronerf_tpu_torch.utils import jpeg

    deep = (np.arange(12 * 10) * 300).astype(np.uint16).reshape(12, 10)
    Image.fromarray(deep).save(tmp_path / "d.png")  # 16-bit gray (I;16)
    with pytest.raises(png.UnsupportedPNG):
        png.read_png(tmp_path / "d.png")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(_write(tmp_path / "x.png", b"GIF89a"))
    Image.fromarray(_photo(16, 12, 4), "CMYK").save(tmp_path / "c.jpg")
    with pytest.raises(jpeg.UnsupportedJPEG, match="CMYK"):
        jpeg.read_jpeg(tmp_path / "c.jpg")
    # files the port's readers do not decode load as imageio loads them
    for name in ("d.png", "c.jpg"):
        want = np.asarray(imageio.imread(tmp_path / name))[..., :3]
        assert_same(t_llff._imread(tmp_path / name), want, name)
    # without imageio, PIL; without either, an error naming the file
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    assert_same(t_llff._imread(tmp_path / "c.jpg"),
                np.asarray(Image.open(tmp_path / "c.jpg").convert("RGB")))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="c.jpg.*CMYK.*imageio or PIL"):
        t_llff._imread(tmp_path / "c.jpg")
    # 8-bit PNGs (RGB, gray) and baseline JPEGs need neither
    rgb = _photo(12, 10, 3)
    png.write_png(tmp_path / "rgb.png", rgb)
    assert_same(t_llff._imread(tmp_path / "rgb.png"), rgb)
    gray = (np.arange(12 * 10) % 256).astype(np.uint8).reshape(12, 10)
    png.write_png(tmp_path / "g.png", gray)  # colour type 0
    assert_same(png.read_png(tmp_path / "g.png"), gray)
    jpeg.write_jpeg(tmp_path / "j.jpg", rgb)
    assert_same(t_llff._imread(tmp_path / "j.jpg"),
                jpeg.decode_jpeg_plain((tmp_path / "j.jpg").read_bytes()))


def _write(path, data):
    path.write_bytes(data)
    return path


# ------------------------------------------------------------- fixtures --

def test_port_fixtures_write_the_jax_files(tmp_path):
    from PIL import Image

    j, t = tmp_path / "j", tmp_path / "t"
    j_fix.write_llff_dataset(j, n=5, H=12, W=16, focal=14.0)
    t_fix.write_llff_dataset(t, n=5, H=12, W=16, focal=14.0)
    sc = make_consistent_scene(seed=0, W=16, H=12, n_views=5)
    j_fix.write_llff_scene(j / "scene", sc)
    t_fix.write_llff_scene(t / "scene", sc)
    for ext in (".bin", ".txt"):
        j_fix.write_colmap_model(j / ext, n_images=5, n_points=30, ext=ext)
        t_fix.write_colmap_model(t / ext, n_images=5, n_points=30, ext=ext)
    files = sorted(p.relative_to(j) for p in j.rglob("*") if p.is_file())
    assert len(files) == 6 + 8 + 2 + 3
    for rel in files:
        if rel.suffix == ".png":  # PIL's encoder and the port's differ
            assert_same(png.read_png(t / rel), np.asarray(Image.open(j / rel)),
                        str(rel))
        else:
            assert (t / rel).read_bytes() == (j / rel).read_bytes(), rel
    for R in (np.eye(3), np.diag([1.0, -1.0, -1.0]),
              np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]),
              np.diag([-1.0, -1.0, 1.0])):
        assert_same(t_fix._rotmat_to_qvec(R), j_fix._rotmat_to_qvec(R))


def test_scene_written_at_a_factor_loads_as_the_minified_capture(tmp_path):
    sc = make_consistent_scene(seed=0, W=24, H=18, n_views=9)
    # the port's capture straight into images_2 (no PIL), the JAX package's
    # minified from its raw images by the JAX loader (PIL, Lanczos): equal
    # poses, bounds and i_ref, and the images the port wrote
    t_fix.write_llff_scene(tmp_path / "t", sc, factor=2)
    assert not (tmp_path / "t" / "images").exists()
    got = t_llff.load_llff_data_infer(tmp_path / "t", factor=2,
                                      num_neighbor=4)
    want = j_llff.load_llff_data_infer(tmp_path / "t", factor=2,
                                       num_neighbor=4)
    for name, g, w in zip(("images", "poses", "bds", "render_poses",
                           "i_test", "i_ref"), got, want):
        assert_same(g, w, name)
    assert got[0].shape == (9, 18, 24, 3)
    assert_same(got[1][0, :, 4], np.array([18, 24, sc["hwf"][2]], np.float32))
    assert_same(got[0], (np.clip(np.round(sc["images"] * 255), 0, 255)
                         .astype(np.uint8) / np.float32(255)).astype(
                             np.float32))


# --------------------------------------------------------------- COLMAP --

@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_colmap_readers_equal_jax(tmp_path, ext):
    j_fix.write_colmap_model(tmp_path, n_images=6, n_points=40, ext=ext)
    sparse = tmp_path / "sparse/0"
    assert t_colmap.model_ext(sparse) == j_colmap.model_ext(sparse) == ext
    if ext == ".bin":
        readers = [("read_images_binary", "images.bin"),
                   ("read_points3d_binary", "points3D.bin")]
    else:
        readers = [("read_cameras_text", "cameras.txt"),
                   ("read_images_text", "images.txt"),
                   ("read_points3d_text", "points3D.txt")]
    for fn, name in readers:
        got = getattr(t_colmap, fn)(sparse / name)
        want = getattr(j_colmap, fn)(sparse / name)
        assert list(got) == list(want), fn
        for k in want:
            g, w = dataclasses.asdict(got[k]), dataclasses.asdict(want[k])
            assert list(g) == list(w)
            for field in w:
                if isinstance(w[field], np.ndarray):
                    assert_same(g[field], w[field], f"{fn} {k} {field}")
                else:
                    assert g[field] == w[field] and type(g[field]) is type(
                        w[field]), f"{fn} {k} {field}"
    assert_same(t_colmap.qvec2rotmat(np.array([0.9, 0.1, -0.3, 0.2])),
                j_colmap.qvec2rotmat(np.array([0.9, 0.1, -0.3, 0.2])))


def test_cameras_binary_reader_equals_jax(tmp_path):
    path = tmp_path / "cameras.bin"
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", 2))
        fh.write(struct.pack("<iiQQ", 1, 1, 40, 32) +
                 struct.pack("<4d", 36.0, 36.5, 20.0, 16.0))
        fh.write(struct.pack("<iiQQ", 3, 0, 8, 6) +
                 struct.pack("<3d", 5.0, 4.0, 3.0))
    got, want = t_colmap.read_cameras_binary(path), \
        j_colmap.read_cameras_binary(path)
    assert list(got) == list(want) == [1, 3]
    for k in want:
        assert (got[k].model, got[k].width, got[k].height) == \
            (want[k].model, want[k].width, want[k].height)
        assert_same(got[k].params, want[k].params)


def _jax_python_path(monkeypatch):
    """Force the JAX package's visibility matrix onto its Python readers."""
    import pronerf_tpu.native

    monkeypatch.setattr(pronerf_tpu.native, "colmap_visibility_native",
                        lambda *a, **k: None)


def _port_python_path(monkeypatch):
    """... and the port's, where no switch reaches it (the loaders)."""
    import pronerf_tpu_torch.native

    monkeypatch.setattr(pronerf_tpu_torch.native, "colmap_visibility_native",
                        lambda *a, **k: None)


@pytest.mark.parametrize("ext", [".bin", ".txt"])
@pytest.mark.parametrize("native", [True, False])
def test_visibility_and_greedy_views_equal_jax(tmp_path, monkeypatch, ext,
                                               native):
    import pronerf_tpu_torch.native as t_native

    j_fix.write_colmap_model(tmp_path, n_images=8, n_points=50, ext=ext)
    if not native:
        _jax_python_path(monkeypatch)
    sparse = tmp_path / "sparse/0"
    i_train = [0, 1, 2, 4, 5, 7]
    calls = t_native.colmap_visibility_native.calls
    got = t_colmap.build_visibility_matrix(sparse, i_train, native=native)
    assert_same(got, j_colmap.build_visibility_matrix(sparse, i_train))
    took_native = t_native.colmap_visibility_native.calls > calls
    assert took_native == (native and ext == ".bin"
                           and t_native.is_available())
    for n in (1, 3, 6):
        assert_same(
            t_colmap.greedy_reference_views(sparse, i_train, n, native),
            j_colmap.greedy_reference_views(sparse, i_train, n))
    with pytest.raises(ValueError, match="num_neighbor"):
        t_colmap.greedy_reference_views(sparse, i_train, None)
    with pytest.raises(FileNotFoundError):
        t_colmap.model_ext(tmp_path)


# ----------------------------------------------------------------- LLFF --

@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A capture of the consistent scene written by the JAX package's
    fixtures: raw PIL PNGs, poses_bounds.npy, a binary COLMAP model."""
    root = tmp_path_factory.mktemp("llff") / "scene"
    j_fix.write_llff_scene(root, make_consistent_scene(seed=0, W=40, H=30,
                                                       n_views=9))
    return root


@pytest.mark.parametrize("spherify", [False, True])
@pytest.mark.parametrize("native", [True, False])
def test_load_llff_data_infer_equals_jax(capture, monkeypatch, spherify,
                                         native):
    if not native:
        _jax_python_path(monkeypatch)
        _port_python_path(monkeypatch)
    got = t_llff.load_llff_data_infer(capture, factor=1, spherify=spherify,
                                      num_neighbor=4, llffhold=8)
    want = j_llff.load_llff_data_infer(capture, factor=1, spherify=spherify,
                                       num_neighbor=4, llffhold=8)
    for name, g, w in zip(("images", "poses", "bds", "render_poses",
                           "i_test", "i_ref"), got, want):
        assert_same(g, w, name)
    assert got[0].shape == (9, 30, 40, 3) and len(got[5]) == 4


@pytest.mark.parametrize("spherify,path_zflat", [(False, False),
                                                 (False, True), (True, False)])
def test_load_llff_data_equals_jax(capture, spherify, path_zflat):
    got = t_llff.load_llff_data(capture, factor=1, spherify=spherify,
                                path_zflat=path_zflat)
    want = j_llff.load_llff_data(capture, factor=1, spherify=spherify,
                                 path_zflat=path_zflat)
    for name, g, w in zip(("images", "poses", "bds", "render_poses"),
                          got[:4], want[:4]):
        assert_same(g, w, name)
    assert got[4] == want[4] and type(got[4]) is type(want[4])


def test_minify_equals_jax(tmp_path):
    """images_{factor} made by each package from the same raw images (PIL,
    Lanczos) loads the same."""
    sc = make_consistent_scene(seed=1, W=40, H=30, n_views=6)
    for name in ("j", "t"):
        j_fix.write_llff_scene(tmp_path / name, sc)
    got = t_llff.load_llff_data(tmp_path / "t", factor=2)
    want = j_llff.load_llff_data(tmp_path / "j", factor=2)
    assert got[0].shape == (6, 15, 20, 3)
    for name, g, w in zip(("images", "poses", "bds", "render_poses"),
                          got[:4], want[:4]):
        assert_same(g, w, name)
    assert got[4] == want[4]


def test_pose_helpers_equal_jax():
    rng = np.random.default_rng(3)
    poses = np.concatenate([
        np.linalg.qr(rng.normal(size=(7, 3, 3)))[0]
        @ np.diag([1.0, 1.0, -1.0])[None],
        rng.normal(0, 0.3, (7, 3, 1)) + np.array([0, 0, 2.0])[:, None],
        np.tile(np.array([[30.0], [40.0], [35.0]]), (7, 1, 1))], -1)
    bds = rng.uniform(1.0, 8.0, (7, 2))
    for fn in ("poses_avg", "recenter_poses"):
        assert_same(getattr(t_llff, fn)(poses), getattr(j_llff, fn)(poses),
                    fn)
    for g, w in zip(t_llff.spherify_poses(poses, bds),
                    j_llff.spherify_poses(poses, bds)):
        assert_same(g, w, "spherify_poses")
    for zflat in (False, True):
        assert_same(t_llff._spiral_from_poses(poses.copy(), bds, zflat),
                    j_llff._spiral_from_poses(poses.copy(), bds, zflat))
    c2w = j_llff.poses_avg(poses)
    assert_same(t_llff.render_path_spiral(c2w, c2w[:3, 1], [0.1, 0.2, 0.3],
                                          4.0, 0.5, 2, 7),
                j_llff.render_path_spiral(c2w, c2w[:3, 1], [0.1, 0.2, 0.3],
                                          4.0, 0.5, 2, 7))


def test_a_missing_capture_raises_naming_it(tmp_path):
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "nowhere")):
        t_llff.load_llff_data(tmp_path / "nowhere", factor=1)
    j_fix.write_llff_dataset(tmp_path / "short", n=3, H=8, W=10)
    (tmp_path / "short" / "images" / "img_002.png").unlink()
    with pytest.raises(ValueError, match="2 images in images but 3 poses"):
        t_llff.load_llff_data(tmp_path / "short", factor=1)
