"""Write the JPEG conformance set ``tests/torch_jpeg_fixtures/``: small
files written by PIL (libjpeg-turbo) in every form the port's reader
(``pronerf_tpu_torch/utils/jpeg.py``) decodes, and ``manifest.json`` with
each file's shape and the sha256 of PIL's decode (what
``imageio.v2.imread`` returns).

``python scripts/torch_make_jpeg_fixtures.py [--out DIR]``. Needs PIL; the
files are committed, so the machine that checks them against the manifest
(``chip_smoke.py`` phase ``jpeg``) needs none. ``tests/test_torch_jpeg.py``
checks the committed manifest against PIL's decode of the committed files.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "torch_jpeg_fixtures"

# name: (height, width, gray, PIL save options)
FILES = {
    "base_444_17x9.jpg": (9, 17, False, {"quality": 90, "subsampling": 0}),
    "base_422_101x77.jpg": (77, 101, False, {"quality": 75,
                                             "subsampling": 1}),
    "base_420_64x48.jpg": (48, 64, False, {"quality": 95, "subsampling": 2}),
    "base_420_1x1.jpg": (1, 1, False, {"quality": 90, "subsampling": 2}),
    "opt_420_33x21.jpg": (21, 33, False, {"quality": 50, "subsampling": 2,
                                          "optimize": True}),
    "prog_444_64x48.jpg": (48, 64, False, {"quality": 90, "subsampling": 0,
                                           "progressive": True}),
    "prog_422_37x29.jpg": (29, 37, False, {"quality": 95, "subsampling": 1,
                                           "progressive": True}),
    "prog_420_101x77.jpg": (77, 101, False, {"quality": 85,
                                             "subsampling": 2,
                                             "progressive": True}),
    "rst1_420_40x24.jpg": (24, 40, False, {"quality": 90, "subsampling": 2,
                                           "restart_marker_blocks": 1}),
    "rst4_prog_444_50x30.jpg": (30, 50, False, {
        "quality": 80, "subsampling": 0, "progressive": True,
        "restart_marker_blocks": 4}),
    "gray_61x45.jpg": (45, 61, True, {"quality": 90}),
    "gray_prog_31x17.jpg": (17, 31, True, {"quality": 70,
                                           "progressive": True}),
}


def content(h: int, w: int, gray: bool, seed: int) -> np.ndarray:
    """Smooth colour bands with noise (so that 0xFF bytes get stuffed)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([127 + 100 * np.sin(x / (3 + c) + y / (5 + 2 * c))
                    for c in range(3)], -1) + rng.normal(0, 25, (h, w, 3))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


def pil_decode(data: bytes) -> np.ndarray:
    """What ``imageio.v2.imread`` returns: PIL's RGB, or its L plane."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im if im.mode == "L" else im.convert("RGB"))


def digest(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def main(argv=None) -> int:
    import PIL
    from PIL import Image, features

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    manifest = {"pil": PIL.__version__,
                "libjpeg_turbo": features.version_feature("libjpeg_turbo"),
                "files": {}}
    for seed, (name, (h, w, gray, opts)) in enumerate(sorted(FILES.items())):
        buf = io.BytesIO()
        Image.fromarray(content(h, w, gray, seed)).save(buf, "JPEG", **opts)
        data = buf.getvalue()
        (args.out / name).write_bytes(data)
        img = pil_decode(data)
        manifest["files"][name] = {"shape": list(img.shape),
                                   "sha256": digest(img), "pil_options": opts}
    (args.out / "manifest.json").write_text(
        json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in args.out.iterdir())
    print(f"wrote {len(FILES)} files and manifest.json to {args.out} "
          f"({total} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
