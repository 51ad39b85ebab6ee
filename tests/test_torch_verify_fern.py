"""The port's fern-parity protocol (``pronerf_tpu_torch/tools/verify_fern.py``)
against the JAX package's ``scripts/verify_fern.py``, on the CPU: the two
cases of ``tests/test_verify_fern.py`` run on the port with ``--device
cpu``, the fixture directory equal to the one JAX's ``build_fixture``
writes, and the same flags.
"""

import importlib.util
import io
import json
import pathlib
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from pronerf_tpu_torch.tools import verify_fern as vf
from pronerf_tpu_torch.utils.png import read_png

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _load_jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_verify_fern", REPO / "scripts/verify_fern.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_verify_fern_fixture_protocol(tmp_path, capsys):
    vf.main(["--fixture", "--basedir", str(tmp_path),
             "--s1-steps", "2", "--s2-steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "verify_fern summary" in out
    assert "Mean Test PSNR" in out
    assert "held-out PSNR" in out
    # machine-readable trailer
    line = [ln for ln in out.splitlines() if ln.startswith('{"verify_fern"')]
    assert line
    payload = json.loads(line[-1])["verify_fern"]
    assert payload["fixture"] is True
    assert payload["psnr"] == payload["psnr"]  # finite, not NaN
    assert (payload["s1_steps"], payload["s2_steps"]) == (2, 2)
    assert payload["lpips"] is None or payload["lpips"] >= 0
    assert sorted(p.name for p in (tmp_path / "verify_s2").glob("*.ckpt"))


def test_verify_fern_missing_data_message(tmp_path):
    try:
        vf.main(["--datadir", str(tmp_path / "nope"),
                 "--basedir", str(tmp_path), "--device", "cpu"])
    except SystemExit as e:
        assert "poses_bounds.npy" in str(e)
    else:
        raise AssertionError("expected SystemExit on missing capture")


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def test_fixture_directory_equals_jax_build_fixture(tmp_path):
    jroot = _load_jax_script().build_fixture(tmp_path / "jax")
    troot = vf.build_fixture(tmp_path / "port")
    assert _files(troot) == _files(jroot)
    assert len([f for f in _files(troot) if f.endswith(".png")]) == 8
    for name in _files(jroot):
        if name.endswith(".png"):  # PIL's encoding against the port's
            np.testing.assert_array_equal(read_png(troot / name),
                                          read_png(jroot / name), name)
        else:
            assert (troot / name).read_bytes() == \
                (jroot / name).read_bytes(), name
    # written once: a second call keeps the files
    stamp = (troot / "poses_bounds.npy").stat().st_mtime_ns
    vf.build_fixture(troot)
    assert (troot / "poses_bounds.npy").stat().st_mtime_ns == stamp


def _options(main):
    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(SystemExit):
        main(["--help"])
    return set(re.findall(r"(--[a-z0-9][a-z0-9-]*)", buf.getvalue()))


def test_flags_are_jax_flags_and_device():
    jax_flags = _options(_load_jax_script().main)
    assert "--fixture" in jax_flags and "--no-use-trt" in jax_flags
    assert _options(vf.main) == jax_flags | {"--device"}
