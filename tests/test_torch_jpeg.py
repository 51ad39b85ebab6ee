"""The port's JPEG reader and writer (``pronerf_tpu_torch/utils/jpeg.py``,
the native decoder ``native/csrc/jpeg_decode.cpp``) against PIL
(libjpeg-turbo), and the LLFF loaders on JPEG captures against the JAX
package's, on the CPU.

Tolerance: none. Each decode is held to PIL's (what ``imageio.v2.imread``
returns) bit for bit, on the plain path and, where g++ builds the host
runtime, on the native path; the loaders with PIL and imageio unimportable
must return the JAX loaders' images and poses bit for bit. The writer's
files must decode to the same pixels in PIL and in the port; their
distance to the encoder's input is a sanity bound only (PSNR >= 35 dB on
smooth content).
"""

import hashlib
import io
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from pronerf_tpu.data import llff as j_llff
from pronerf_tpu_torch import native
from pronerf_tpu_torch.data import llff as t_llff
from pronerf_tpu_torch.utils import jpeg
from pronerf_tpu_torch.utils.fixtures import write_llff_scene
from pronerf_tpu_torch.utils.png import read_png, write_png
from pronerf_tpu_torch.utils.synthetic import make_consistent_scene
from test_torch_resize import block_pil

FIXTURES = Path(__file__).resolve().parent / "torch_jpeg_fixtures"
PSNR_DB = 35.0


def content(h, w, seed, noise=25.0, gray=False):
    """Colour bands with noise (stuffed 0xFF bytes at high quality)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([127 + 100 * np.sin(x / (3 + c) + y / (5 + 2 * c))
                    for c in range(3)], -1) + rng.normal(0, noise, (h, w, 3))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


def encode(img, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **opts)
    return buf.getvalue()


def pil_decode(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im if im.mode == "L" else im.convert("RGB"))


def decoders():
    """The plain decoder and, where the host runtime builds, the native
    one."""
    out = [("plain", jpeg.decode_jpeg_plain)]
    if native.is_available():
        out.append(("native", native.decode_jpeg_native))
    return out


def assert_decodes_as_pil(data: bytes):
    want = pil_decode(data)
    for name, fn in decoders():
        got = fn(data)
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    return want


def psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


# ------------------------------------------------------------- the grid --

@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("size", [(1, 1), (8, 8), (16, 16), (9, 17),
                                  (48, 64), (77, 101)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("mode", ["baseline", "optimize", "progressive"])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0"])
def test_decode_equals_pil(sampling, mode, size, quality):
    h, w = size
    opts = {"quality": quality, "subsampling": sampling}
    if mode != "baseline":
        opts[mode] = True
    assert_decodes_as_pil(encode(content(h, w, h * w + quality), **opts))


# ------------------------------------------------------ beyond the grid --

def _exif6():
    exif = Image.Exif()
    exif[0x0112] = 6  # orientation: rotate 90 degrees
    return exif.tobytes()


CASES = {
    "gray": lambda: encode(content(45, 61, 1, gray=True), quality=90),
    "gray_progressive": lambda: encode(content(17, 31, 2, gray=True),
                                       quality=70, progressive=True),
    "restart_every_block": lambda: encode(
        content(24, 40, 3), quality=90, subsampling="4:2:0",
        restart_marker_blocks=1),
    "restart_every_4_blocks": lambda: encode(
        content(77, 101, 4), quality=90, subsampling="4:4:4",
        restart_marker_blocks=4),
    "restart_progressive": lambda: encode(
        content(30, 50, 5), quality=80, subsampling="4:2:2",
        restart_marker_blocks=4, progressive=True),
    "restart_every_row": lambda: encode(
        content(40, 33, 6), quality=85, restart_marker_rows=1),
    "custom_qtables": lambda: encode(
        content(48, 64, 7), qtables=[list(range(1, 65)), [3] * 64]),
    "exif_orientation_6": lambda: encode(content(30, 50, 8), quality=90,
                                         exif=_exif6()),
    "com_and_app_segments": lambda: encode(
        content(29, 37, 9), quality=70, comment=b"a comment",
        icc_profile=b"\0" * 300),
    "noise_quality_100": lambda: encode(
        np.random.default_rng(10).integers(0, 256, (77, 101, 3),
                                           dtype=np.uint8),
        quality=100, subsampling="4:4:4"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_other_forms_equal_pil(case):
    data = CASES[case]()
    if case == "noise_quality_100":
        assert data.count(b"\xff\x00") > 10  # stuffed bytes
    if case.startswith("restart"):
        assert b"\xff\xd0" in data and b"\xff\xdd" in data
    if case == "exif_orientation_6":  # ignored, as imageio ignores it
        assert pil_decode(data).shape == (30, 50, 3)
    assert_decodes_as_pil(data)


def _truncated():
    data = encode(content(48, 64, 11), quality=90)
    return data[:len(data) // 2]


def _patched(old: bytes, new: bytes, **opts):
    data = encode(content(24, 32, 12), quality=90, **opts)
    i = data.index(old)
    return data[:i] + new + data[i + len(old):]


def _progressive_cut():
    """A progressive file whose AC refinement scans were dropped, EOI
    kept: libjpeg would smooth its blocks."""
    data = encode(content(24, 32, 13), quality=90, progressive=True)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    return data[:sos[4]] + b"\xff\xd9"


UNSUPPORTED = {
    "cmyk": (lambda: encode_mode(np.random.default_rng(14).integers(
        0, 256, (20, 20, 4), dtype=np.uint8), "CMYK"), "CMYK"),
    "truncated": (_truncated, "truncated"),
    "no_eoi": (lambda: encode(content(16, 16, 15), quality=90)[:-2],
               "truncated"),
    "sof9": (lambda: _patched(b"\xff\xc0", b"\xff\xc9"), "arithmetic"),
    "rgb_adobe_transform_0": (lambda: encode(content(16, 16, 16),
                                             keep_rgb=True), "RGB"),
    "sampling_4x1": (lambda: _patched(b"\x01\x22\x00", b"\x01\x41\x00",
                                      subsampling="4:2:0"), "sampling"),
    "height_0_dnl": (lambda: _patched(b"\xff\xc0\x00\x11\x08\x00\x18",
                                      b"\xff\xc0\x00\x11\x08\x00\x00"),
                     "height of 0"),
    "progressive_incomplete": (_progressive_cut, "incomplete"),
    "not_a_jpeg": (lambda: b"GIF89a" + bytes(100), "not a JPEG"),
}


def encode_mode(arr, mode):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "JPEG", quality=90)
    return buf.getvalue()


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_files_raise(case, tmp_path):
    make, match = UNSUPPORTED[case]
    data = make()
    for name, fn in decoders():
        with pytest.raises(jpeg.UnsupportedJPEG, match=match):
            fn(data)
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    with pytest.raises(jpeg.UnsupportedJPEG, match="x.jpg"):
        jpeg.read_jpeg(path)


def test_every_prefix_of_a_file_raises():
    """A file cut anywhere never returns pixels."""
    data = encode(content(24, 40, 17), quality=80, progressive=True)
    for cut in range(0, len(data) - 1, 7):
        for name, fn in decoders():
            with pytest.raises(jpeg.UnsupportedJPEG):
                fn(data[:cut])


def assert_raise_or_pil(data: bytes) -> bool:
    """Both paths raise UnsupportedJPEG on ``data``, or both return PIL's
    pixels; True where they return them."""
    got = []
    for _, fn in decoders():
        try:
            got.append(fn(data))
        except jpeg.UnsupportedJPEG:
            got.append(None)
    assert all((g is None) == (got[0] is None) for g in got)
    if got[0] is None:
        return False
    want = pil_decode(data)
    for g in got:
        np.testing.assert_array_equal(g, want)
    return True


def test_native_and_plain_agree_on_corrupted_files():
    """A byte changed in the entropy-coded data: both paths raise, or both
    return PIL's pixels."""
    if not native.is_available():
        pytest.skip("g++ cannot build the host runtime here")
    data = encode(content(40, 48, 18), quality=90, subsampling="4:2:0")
    rng = np.random.default_rng(19)
    start = data.index(b"\xff\xda") + 14
    for _ in range(100):
        bad = bytearray(data)
        bad[rng.integers(start, len(data) - 2)] = rng.integers(0, 256)
        assert_raise_or_pil(bytes(bad))


def _header_ranges(data: bytes) -> list:
    """[start, end) of each marker segment (marker bytes included, the
    entropy-coded data after each SOS left out)."""
    out, pos = [], 2
    while data[pos + 1] != 0xD9:
        marker = data[pos + 1]
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((pos, end))
        pos = end
        if marker == 0xDA:
            while not (data[pos] == 0xFF and data[pos + 1] not in
                       (0x00, *range(0xD0, 0xD8))):
                pos += 1
    return out


def _segment_at(data: bytes, marker: int, nth: int = 0) -> int:
    """The offset of the nth segment with this marker."""
    return [a for a, _ in _header_ranges(data)
            if data[a + 1] == marker][nth]


def _with(data: bytes, at: int, new: bytes) -> bytes:
    return data[:at] + new + data[at + len(new):]


def _overfull_dht(nth, into=0, n=3, **opts):
    """The nth DHT's code counts with n codes moved to length into + 1
    from the length that has the most."""
    data = encode(content(24, 32, 22), quality=90, **opts)
    at = _segment_at(data, 0xC4, nth) + 5
    counts = list(data[at:at + 16])
    big = int(np.argmax(counts))
    counts[big] -= n
    counts[into] += n
    return _with(data, at, bytes(counts))


def _selector(table: int, nth_scan: int = 0, **opts):
    """The nth scan's first component names Huffman table (table)."""
    data = encode(content(24, 32, 23), quality=90, **opts)
    at = _segment_at(data, 0xDA, nth_scan) + 6
    return _with(data, at, bytes([table]))


def _ac_scan_selector(table: int):
    """A progressive file's first AC scan names AC table (table)."""
    data = encode(content(24, 32, 24), quality=90, progressive=True)
    scans = [a for a, _ in _header_ranges(data) if data[a + 1] == 0xDA]
    at = next(a for a in scans if data[a + 5 + 2 * data[a + 4]] > 0)  # Ss
    return _with(data, at + 6, bytes([table]))


def _frame(height: int, width: int, tq: int = 0):
    data = encode(content(24, 32, 25), quality=90)
    at = _segment_at(data, 0xC0)
    return _with(_with(data, at + 5, height.to_bytes(2, "big")
                       + width.to_bytes(2, "big")),
                 at + 12, bytes([tq]) if tq else data[at + 12:at + 13])


BAD_HEADERS = {
    # three 1-bit codes: filling the third wrote past the table before
    "dht_three_1bit_codes": (lambda: _overfull_dht(0), "bad Huffman table"),
    # two 1-bit codes: the second is all ones
    "dht_all_ones_code": (lambda: _overfull_dht(0, n=2), "bad Huffman "
                                                         "table"),
    "dht_overfull_ac": (lambda: _overfull_dht(1, into=1, n=4),
                        "bad Huffman table"),
    "dht_overfull_progressive": (lambda: _overfull_dht(
        2, n=3, progressive=True), "bad Huffman table"),
    "dht_class_2": (lambda: (lambda d: _with(
        d, _segment_at(d, 0xC4) + 4, b"\x20"))(
        encode(content(24, 32, 26), quality=90)), "DHT"),
    "sos_dc_table_5": (lambda: _selector(0x50), "Huffman table 5"),
    "sos_ac_table_4": (lambda: _selector(0x04), "Huffman table 4"),
    "sos_ac_table_15": (lambda: _selector(0xFF), "Huffman table 15"),
    "progressive_dc_table_9": (lambda: _selector(0x90, progressive=True),
                               "Huffman table 9"),
    "progressive_ac_table_7": (lambda: _ac_scan_selector(0x07),
                               "Huffman table 7"),
    "sof_65535_a_side": (lambda: _frame(65535, 65535), "65500"),
    "sof_65501x1": (lambda: _frame(1, 65501), "65500"),
    "sof_past_pils_limit": (lambda: _frame(20000, 20000), "PIL refuses"),
    "sof_more_blocks_than_bits": (lambda: _frame(4000, 4000), "truncated"),
    "sof_quant_table_5": (lambda: _frame(24, 32, tq=5), "component"),
    "dqt_table_4": (lambda: (lambda d: _with(
        d, _segment_at(d, 0xDB) + 4, b"\x04"))(
        encode(content(24, 32, 27), quality=90)), "quantisation table"),
    # a bright block's DC (325) dequantised by 255 instead of 3
    "dqt_past_16_bits": (lambda: (lambda d: _with(
        d, _segment_at(d, 0xDB) + 5, b"\xff"))(
        encode(np.full((16, 16, 3), 250, np.uint8), quality=90)),
        "16 bits"),
}
# files PIL returns pixels for: libjpeg pads missing data (a warning PIL
# drops), and its SIMD IDCT saturates past 16 bits where the C IDCT, the
# port's model, does not; the port raises on both
PIL_DECODES = {"sof_more_blocks_than_bits", "dqt_past_16_bits"}


@pytest.mark.parametrize("case", sorted(BAD_HEADERS))
def test_bad_headers_raise_on_both_paths(case):
    """Tables, selectors and frame sizes out of range: PIL raises, and both
    decoders raise UnsupportedJPEG (none reads or writes past a table or
    allocates for a size the data cannot hold)."""
    make, match = BAD_HEADERS[case]
    data = make()
    if case in PIL_DECODES:
        pil_decode(data)
    else:
        with pytest.raises(Exception):
            pil_decode(data)
    for name, fn in decoders():
        with pytest.raises(jpeg.UnsupportedJPEG, match=match):
            fn(data)


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_native_and_plain_agree_on_corrupted_headers(progressive):
    """A byte changed in a marker segment (frame, tables, scan headers,
    lengths): both paths raise, or both return PIL's pixels."""
    if not native.is_available():
        pytest.skip("g++ cannot build the host runtime here")
    data = encode(content(24, 32, 28), quality=90, subsampling="4:2:0",
                  progressive=progressive)
    spots = [i for a, b in _header_ranges(data) for i in range(a + 2, b)]
    rng = np.random.default_rng(29)
    decoded = 0
    for _ in range(60):
        bad = bytearray(data)
        bad[spots[rng.integers(len(spots))]] = rng.integers(0, 256)
        decoded += assert_raise_or_pil(bytes(bad))
    assert 0 < decoded < 60


# -------------------------------------------------------- the reader --

def needs_runtime():
    if not native.is_available():
        pytest.skip("g++ cannot build the host runtime here")


def test_read_jpeg_takes_the_native_path_when_it_loads(tmp_path,
                                                       monkeypatch):
    needs_runtime()
    path = tmp_path / "v.jpg"
    path.write_bytes(encode(content(21, 33, 20), quality=90))
    calls = native.decode_jpeg_native.calls
    np.testing.assert_array_equal(jpeg.read_jpeg(path),
                                  pil_decode(path.read_bytes()))
    assert native.decode_jpeg_native.calls == calls + 1
    # without the library it raises (the plain decoder is the reference,
    # too slow for a camera view), so the loader goes on to imageio or PIL
    monkeypatch.setattr(native, "_load", lambda: None)
    with pytest.raises(jpeg.UnsupportedJPEG, match="v.jpg.*g\\+\\+"):
        jpeg.read_jpeg(path)
    assert native.decode_jpeg_native.calls == calls + 1
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(t_llff._imread(path), want)
    block_pil(monkeypatch)
    with pytest.raises(ImportError, match="v.jpg.*did not build.*imageio"):
        t_llff._imread(path)


# ------------------------------------------------------ conformance set --

MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())


def test_conformance_manifest_is_pils_decode():
    """The committed manifest holds PIL's decode of the committed files
    (``scripts/torch_make_jpeg_fixtures.py`` wrote both)."""
    names = sorted(p.name for p in FIXTURES.glob("*.jpg"))
    assert names == sorted(MANIFEST["files"]) and len(names) >= 10
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 100_000
    for name in names:
        img = pil_decode((FIXTURES / name).read_bytes())
        entry = MANIFEST["files"][name]
        assert list(img.shape) == entry["shape"], name
        assert hashlib.sha256(img.tobytes()).hexdigest() == entry["sha256"]


@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_conformance_files_decode_to_the_manifest(name):
    data = (FIXTURES / name).read_bytes()
    entry = MANIFEST["files"][name]
    for path, fn in decoders():
        img = fn(data)
        assert list(img.shape) == entry["shape"], path
        assert hashlib.sha256(img.tobytes()).hexdigest() == entry["sha256"], \
            path


# ------------------------------------------------------------ the writer --

def smooth(h, w):
    y, x = np.mgrid[0:h, 0:w]
    return np.clip(np.stack([127 + 100 * np.sin(x / (7 + 3 * c))
                             * np.cos(y / (11 + c)) for c in range(3)], -1),
                   0, 255).astype(np.uint8)


@pytest.mark.parametrize("size", [(1, 1), (9, 17), (48, 64), (77, 101)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("quality", [75, 95])
def test_write_jpeg_decodes_the_same_in_pil(tmp_path, size, quality):
    img = smooth(*size)
    path = tmp_path / "w.jpg"
    jpeg.write_jpeg(path, img, quality=quality)
    want = assert_decodes_as_pil(path.read_bytes())
    np.testing.assert_array_equal(jpeg.read_jpeg(path), want)
    assert psnr(want, img) >= PSNR_DB


@pytest.mark.parametrize("quality", [10, 50, 90, 95, 100])
def test_write_jpeg_tables_are_libjpegs(tmp_path, quality):
    """The writer's DQT and DHT segments equal PIL's baseline 4:2:0 file's
    at the same quality: Annex K scaled by ``jpeg_quality_scaling``, and
    the standard Huffman tables."""
    img = smooth(16, 16)

    def tables(data):
        out, pos = [], 2
        while data[pos + 1] != 0xDA:
            n = int.from_bytes(data[pos + 2:pos + 4], "big")
            if data[pos + 1] in (0xDB, 0xC4, 0xC0):
                out.append(data[pos:pos + 2 + n])
            pos += 2 + n
        return out

    jpeg.write_jpeg(tmp_path / "w.jpg", img, quality=quality)
    mine = tables((tmp_path / "w.jpg").read_bytes())
    pils = tables(encode(img, quality=quality, subsampling="4:2:0"))
    assert sorted(mine) == sorted(pils)


def test_write_jpeg_rejects_other_arrays(tmp_path):
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 3), np.float32),
                np.zeros((4, 4, 4), np.uint8)):
        with pytest.raises(ValueError, match="write_jpeg"):
            jpeg.write_jpeg(tmp_path / "x.jpg", bad)


# ------------------------------------------------------------ the loaders --

@pytest.fixture(scope="module")
def jpeg_capture(tmp_path_factory):
    """A raw capture of JPEGs (the consistent scene, ``images/`` only,
    binary COLMAP) written by the port's fixtures: one copy for each
    package, since ``_minify`` writes into it."""
    root = tmp_path_factory.mktemp("jpeg_capture")
    sc = make_consistent_scene(seed=0, W=44, H=36, n_views=6)
    write_llff_scene(root / "port", sc, image_format="jpeg")
    shutil.copytree(root / "port", root / "jax")
    return root


def test_write_llff_scene_writes_jpegs(jpeg_capture):
    names = sorted(p.name for p in (jpeg_capture / "port/images").iterdir())
    assert names == [f"img_{i:03d}.jpg" for i in range(6)]
    raw = (jpeg_capture / "port/sparse/0/images.bin").read_bytes()
    assert b"img_000.jpg\0" in raw and b".png" not in raw


@pytest.mark.parametrize("factor", [1, 4])
def test_load_data_of_jpegs_without_pil_equals_jax(jpeg_capture, factor,
                                                   monkeypatch):
    needs_runtime()
    want = j_llff._load_data(jpeg_capture / "jax", factor=factor)
    block_pil(monkeypatch)
    got = t_llff._load_data(jpeg_capture / "port", factor=factor)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert got[2].shape == ((36, 44, 3, 6) if factor == 1 else
                            (9, 11, 3, 6))


@pytest.mark.parametrize("factor", [1, 4])
def test_load_llff_data_of_jpegs_without_pil_equals_jax(jpeg_capture, factor,
                                                        monkeypatch):
    needs_runtime()
    want = j_llff.load_llff_data(jpeg_capture / "jax", factor=factor)
    block_pil(monkeypatch)
    got = t_llff.load_llff_data(jpeg_capture / "port", factor=factor)
    for name, g, w in zip(("images", "poses", "bds", "render_poses"),
                          got[:4], want[:4]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), name)
    assert got[4] == want[4]


# ------------------------------------------- _minify on grayscale sources --

@pytest.mark.parametrize("fmt", ["jpg", "png"])
def test_minify_of_a_gray_source_equals_jax(tmp_path, monkeypatch, fmt):
    """A grayscale source becomes RGB with gray copied into each channel,
    as PIL's ``convert("RGB")`` in the JAX package's ``_minify`` makes it
    (the port raised on such a source before)."""
    if fmt == "jpg":
        needs_runtime()
    gray = content(48, 64, 21, gray=True)
    for name in ("jax", "port"):
        (tmp_path / name / "images").mkdir(parents=True)
        src = tmp_path / name / "images" / f"v.{fmt}"
        if fmt == "jpg":
            src.write_bytes(encode(gray, quality=90))
        else:
            write_png(src, gray)
    jout = j_llff._minify(tmp_path / "jax", 4)
    block_pil(monkeypatch)
    tout = t_llff._minify(tmp_path / "port", 4)
    got, want = read_png(tout / "v.png"), read_png(jout / "v.png")
    assert got.shape == (12, 16, 3)
    np.testing.assert_array_equal(got, want)
    # the loader's _imread keeps the reference's [..., :3] on gray images
    monkeypatch.undo()
    src = tmp_path / "port" / "images" / f"v.{fmt}"
    want = j_llff._imread(src)
    block_pil(monkeypatch)
    np.testing.assert_array_equal(t_llff._imread(src), want)
    assert want.shape == (48, 3)


def test_block_pil_blocks_imageio_too(monkeypatch):
    block_pil(monkeypatch)
    with pytest.raises(ImportError):
        import imageio.v2  # noqa: F401
    assert sys.modules["imageio"] is None
