"""The port's Lanczos resize (``pronerf_tpu_torch/utils/resize.py``) and the
LLFF loader's ``_minify`` that uses it, against PIL and the JAX package's
``_minify`` on the CPU.

Tolerance: none. The resize is PIL's integer arithmetic, so the output must
equal PIL's ``Image.resize(..., LANCZOS)`` bit for bit; ``_minify`` with PIL
unimportable must write the same pixels as the JAX package's ``_minify``
with PIL, and the loader must return the same images and poses.
"""

import sys

import numpy as np
import pytest
from PIL import Image

from pronerf_tpu.data import llff as j_llff
from pronerf_tpu_torch.data import llff as t_llff
from pronerf_tpu_torch.utils.fixtures import write_llff_dataset
from pronerf_tpu_torch.utils.png import read_png, write_png
from pronerf_tpu_torch.utils.resize import coefficients, resize_lanczos


def pil_resize(img, width, height):
    return np.asarray(Image.fromarray(img).resize((width, height),
                                                  Image.LANCZOS))


def block_pil(monkeypatch):
    """Make ``import PIL`` / ``from PIL import Image`` and ``import
    imageio`` / ``import imageio.v2`` raise ImportError."""
    for name in ("PIL", "PIL.Image", "imageio", "imageio.v2"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        from PIL import Image  # noqa: F401
    with pytest.raises(ImportError):
        import imageio.v2  # noqa: F401


# (W, H, factor): the fern raw capture at factor 4, and a small odd size at
# factors 4, 8 and 2 (2 lands on halves, which round() takes to even)
SIZES = [(2016, 1512, 4), (37, 53, 4), (37, 53, 8), (37, 53, 2)]


@pytest.mark.parametrize("W,H,factor", SIZES)
@pytest.mark.parametrize("content", ["noise", "smooth"])
def test_resize_equals_pil_lanczos_bit_for_bit(W, H, factor, content):
    rng = np.random.default_rng(W * H + factor)
    if content == "noise":
        img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    else:
        y, x = np.mgrid[0:H, 0:W]
        img = np.stack([127 + 120 * np.sin(x / (7 + 3 * c))
                        * np.cos(y / (11 + c)) for c in range(3)], -1)
        img = img.astype(np.uint8)
    w, h = round(W / factor), round(H / factor)
    got = resize_lanczos(img, w, h)
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, pil_resize(img, w, h))


@pytest.mark.parametrize("size", [(40, 29), (17, 13), (37, 9)])
def test_resize_one_axis_or_up_equals_pil(size):
    """A pass whose size stays is skipped, as PIL skips it; enlarging keeps
    the filter's unscaled support."""
    img = np.random.default_rng(3).integers(0, 256, (13, 17, 3),
                                            dtype=np.uint8)
    np.testing.assert_array_equal(resize_lanczos(img, *size),
                                  pil_resize(img, *size))


def test_resize_weights_are_normalised_fixed_point():
    start, weights = coefficients(2016, 504)
    assert weights.shape == (504, 25)
    assert start[0] == 0 and start[-1] + 25 >= 2016 - 1
    # each window sums to one in 22-bit fixed point, up to its rounding
    assert np.abs(weights.sum(1) - (1 << 22)).max() <= weights.shape[1]


def test_resize_rejects_other_images():
    with pytest.raises(ValueError):
        resize_lanczos(np.zeros((4, 4), np.uint8), 2, 2)
    with pytest.raises(ValueError):
        resize_lanczos(np.zeros((4, 4, 3), np.float32), 2, 2)


def raw_capture(root, H=53, W=37):
    write_llff_dataset(root, n=3, H=H, W=W, focal=30.0)
    return root


def test_minify_without_pil_writes_jax_minify_pixels(tmp_path, monkeypatch):
    jroot = raw_capture(tmp_path / "jax")
    troot = raw_capture(tmp_path / "port")
    jout = j_llff._minify(jroot, 4)  # PIL
    block_pil(monkeypatch)
    tout = t_llff._minify(troot, 4)
    jfiles = sorted(p.name for p in jout.iterdir())
    assert sorted(p.name for p in tout.iterdir()) == jfiles
    assert jfiles == ["img_000.png", "img_001.png", "img_002.png"]
    for name in jfiles:
        got = read_png(tout / name)
        assert got.shape == (13, 9, 3)
        np.testing.assert_array_equal(got, read_png(jout / name))


def test_load_llff_data_from_raw_without_pil_equals_jax(tmp_path,
                                                        monkeypatch):
    """The whole loader at factor 4 from a capture holding only ``images/``:
    the port with PIL unimportable, JAX with PIL."""
    jroot = raw_capture(tmp_path / "jax", H=72, W=96)
    troot = raw_capture(tmp_path / "port", H=72, W=96)
    want = j_llff._load_data(jroot, factor=4)
    block_pil(monkeypatch)
    got = t_llff._load_data(troot, factor=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert got[2].shape == (18, 24, 3, 3)


def test_minify_keeps_an_existing_set(tmp_path, monkeypatch):
    root = raw_capture(tmp_path / "c")
    (root / "images_4").mkdir()
    write_png(root / "images_4" / "x.png", np.zeros((2, 2, 3), np.uint8))
    block_pil(monkeypatch)
    assert t_llff._minify(root, 4) == root / "images_4"
    assert [p.name for p in (root / "images_4").iterdir()] == ["x.png"]
