"""The port stands on its own: importing it (and ``chip_smoke``) loads
nothing of JAX or of the JAX package, and its entry points do not quietly run
on the CPU when no card is there."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def port_modules():
    import pronerf_tpu_torch

    return ["pronerf_tpu_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(pronerf_tpu_torch.__path__,
                                              "pronerf_tpu_torch."))


def test_port_has_the_expected_modules():
    mods = port_modules()
    for want in ("config", "convert", "ops.warp", "ops.composite",
                 "models.mlp", "models.pronerf", "models.pronerf_t",
                 "kernels.build", "kernels.fused_minmax",
                 "kernels.fused_nerf", "kernels.fused_nerf_q",
                 "kernels.packing", "render.raygen", "render.renderer",
                 "render.infer", "utils.synthetic", "utils.profiling",
                 "utils.logging", "train.state", "train.stage1",
                 "train.stage2", "train.checkpoint", "train.loop",
                 "data", "data.llff", "data.colmap", "native", "cli",
                 "tools.ckpt", "utils.fixtures", "utils.png",
                 "models.donerf", "utils.gif", "train.fast_loop",
                 "render.export", "parallel", "parallel.launch",
                 "parallel.data_parallel", "parallel.multi_scene",
                 "parallel.render_parallel", "train.multi_loop"):
        assert f"pronerf_tpu_torch.{want}" in mods


def test_importing_the_port_loads_no_jax_in_a_fresh_process():
    """... nor ``msgpack`` or an imaging package, and builds nothing: no
    library of the kernels or of the host runtime was loaded or built."""
    code = (
        "import importlib, sys\n"
        f"mods = {port_modules()!r} + ['chip_smoke']\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'pronerf_tpu', 'triton', "
        "'msgpack', 'PIL', 'imageio'))\n"
        "assert not bad, bad\n"
        "import pronerf_tpu_torch.native as n\n"
        "assert n._lib is None and not n._tried and not n.build_info\n"
        "from pronerf_tpu_torch.kernels import build\n"
        "assert not build._loaded\n"
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n"
        "print('ok', len(mods))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("ok")


def test_no_port_source_names_the_jax_package_in_an_import():
    import re

    pat = re.compile(
        r"^\s*(from|import)\s+(jax|flax|optax|msgpack|pronerf_tpu)\b", re.M)
    files = list((ROOT / "pronerf_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        assert not pat.search(f.read_text()), f


def test_entry_points_default_to_the_card_and_raise_without_one():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    import numpy as np

    from pronerf_tpu_torch.config import Config
    from pronerf_tpu_torch.models.pronerf import RenderStatics
    from pronerf_tpu_torch.render.infer import run_inference
    from pronerf_tpu_torch.render.raygen import prepare_scene, rays_for_pose
    from pronerf_tpu_torch.render.renderer import (
        make_frame_renderer,
        render_path,
    )

    K = np.array([[20.0, 0, 8], [0, 20.0, 6], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)[:3]
    with pytest.raises(RuntimeError, match="CUDA"):
        make_frame_renderer(RenderStatics.infer(), 12, 16, K)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_path([pose], {}, {}, RenderStatics.infer(), 12, 16, K)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_inference(Config(datadir="synthetic"))
    with pytest.raises(RuntimeError, match="CUDA"):
        prepare_scene(np.zeros((1, 12, 16, 3), np.float32), pose[None], K)
    with pytest.raises(RuntimeError, match="CUDA"):
        rays_for_pose(12, 16, K, pose)
    from pronerf_tpu_torch.train.loop import run_training

    with pytest.raises(RuntimeError, match="CUDA"):
        run_training(Config(datadir="synthetic"), 1)
    from pronerf_tpu_torch.render.export import load_exported_renderer
    from pronerf_tpu_torch.render.infer import (
        run_export,
        run_inference_from_export,
    )

    with pytest.raises(RuntimeError, match="CUDA"):
        run_export(Config(datadir="synthetic"))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_inference_from_export(Config(datadir="synthetic"), "nowhere")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_exported_renderer("nowhere")
    from pronerf_tpu_torch.parallel.data_parallel import make_ray_mesh
    from pronerf_tpu_torch.parallel.render_parallel import (
        make_sharded_frame_renderer,
    )
    from pronerf_tpu_torch.train.multi_loop import (
        launch_multi_training,
        run_multi_training,
    )

    with pytest.raises(RuntimeError, match="CUDA"):
        run_multi_training(Config(), ["synthetic0", "synthetic1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_multi_training(Config(), ["synthetic0", "synthetic1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_sharded_frame_renderer(RenderStatics.infer(), 12, 16, K,
                                    make_ray_mesh())


def test_chip_smoke_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
