"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program either. Module names are compared
by their top-level name as a whole: ``pronerf_tpu_torch`` begins with
``pronerf_tpu`` and is not the JAX package."""

import ast
import subprocess
import sys

import pytest

import harness

JAX = {"jax", "jaxlib", "flax", "pronerf_tpu"}
PORT = "pronerf_tpu_torch"


def sources():
    return sorted(p for p in harness.BENCH.rglob("*.py")
                  if "_cache" not in p.parts and "tests" not in p.parts)


def imported_tops(path):
    """Top-level names of every module ``path`` imports (relative imports
    stay inside the benchmark)."""
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_whole_names_tell_the_port_from_the_jax_package():
    assert PORT.split(".")[0] not in JAX
    assert "pronerf_tpu.models".split(".")[0] in JAX


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(
    p.relative_to(harness.BENCH)))
def test_no_source_imports_jax(path):
    tops = imported_tops(path)
    assert not tops & JAX, tops & JAX
    if "reference" in path.relative_to(harness.BENCH).parts:
        assert PORT not in tops


def test_a_run_loads_no_jax_and_the_reference_no_port():
    """In a fresh process: every driver, metric reader and reference module
    loaded, and the port's modules the drivers call, hold no JAX; the
    reference alone holds no module of the port."""
    code = f"""
import sys
sys.path[:0] = [{str(harness.BENCH)!r}, {str(harness.ROOT)!r}]
import reference.msgpack, reference.scene, reference.pronerf
bad = sorted(m for m in sys.modules if m.split('.')[0] == {PORT!r})
assert not bad, bad
import harness
for kind in ('traffic', 'metrics'):
    for p in sorted((harness.BENCH / kind).glob('*.py')):
        harness.load_module(kind, p.stem)
import pronerf_tpu_torch.render.renderer, pronerf_tpu_torch.convert
import pronerf_tpu_torch.train.fast_loop, pronerf_tpu_torch.render.raygen
bad = harness.forbidden_loaded()
assert not bad, bad
print('ok')
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")
