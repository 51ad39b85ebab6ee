"""The spiral video in the port, on the CPU: the GIF89a writer and reader of
``utils/gif.py``, ``render.renderer.save_video`` with and without imageio,
``run_render_path`` and ``cli render-path --device cpu`` on an LLFF capture
(frames held against the JAX package's ``run_render_path`` on the same
checkpoint), and the trainer's ``i_video`` spiral (written at the JAX
trainer's steps, its frames the render of the run's weights).

Palette bound: the writer maps each channel to the nearest level of a
6 x 7 x 6 cube, so a written pixel is within 25 (red, blue) and 21 (green)
steps of 255 of its 8-bit value (``PALETTE_MAX_ERR``), and it is exactly
the palette colour of that value. Frames against JAX: the f32 render bounds
of tests/test_torch_render.py (5e-5; depth is not in a video).
"""

import sys

import numpy as np
import pytest
import torch

import jax

from pronerf_tpu.models import init_pronerf_params as j_init
from pronerf_tpu.train import checkpoint as j_ckpt
from pronerf_tpu_torch.ops.metrics import to8b
from pronerf_tpu_torch.utils import gif

torch.set_num_threads(2)


def frames_of(seed=0, n=3, H=30, W=44):
    """Smooth gradients and one frame of noise, uint8 [n + 1, H, W, 3]."""
    yy, xx = np.mgrid[0:H, 0:W]
    out = [np.stack([(xx * 255 // W + 10 * k) % 256, yy * 255 // H,
                     ((xx + yy) * 3 + k) % 256], -1).astype(np.uint8)
           for k in range(n)]
    out.append(np.random.default_rng(seed).integers(0, 256, (H, W, 3),
                                                    dtype=np.uint8))
    return np.stack(out)


def hide_imageio(monkeypatch):
    for name in ("imageio", "imageio.v2"):
        monkeypatch.setitem(sys.modules, name, None)


@pytest.mark.parametrize("fps,delay", [(30, 3), (20, 5), (1, 100)])
def test_gif_round_trip_within_the_palette_bound(tmp_path, fps, delay):
    frames = frames_of()
    path = gif.write_gif(tmp_path / "v.gif", frames, fps)
    raw = (tmp_path / "v.gif").read_bytes()
    assert path == str(tmp_path / "v.gif") and raw[:6] == b"GIF89a"
    assert b"NETSCAPE2.0" in raw and raw[-1:] == b"\x3b"
    got, delays = gif.read_gif(path)
    assert got.shape == frames.shape and delays == [delay] * len(frames)
    want = gif.palette()[gif.quantize(frames)]
    np.testing.assert_array_equal(got, want)
    err = np.abs(got.astype(int) - frames).max(axis=(0, 1, 2))
    assert gif.PALETTE_MAX_ERR == (25, 21, 25)
    assert tuple(err) == gif.PALETTE_MAX_ERR  # the noise frame reaches it
    # a frame of uniform colour, and the largest table (a 4,096-code clear)
    flat = np.full((1, 64, 80, 3), 77, np.uint8)
    noisy = np.random.default_rng(2).integers(0, 256, (1, 120, 160, 3),
                                              dtype=np.uint8)
    for f in (flat, noisy):
        gif.write_gif(tmp_path / "f.gif", f, fps)
        np.testing.assert_array_equal(gif.read_gif(tmp_path / "f.gif")[0],
                                      gif.palette()[gif.quantize(f)])


def test_gif_agrees_with_pil_both_ways(tmp_path):
    """PIL decodes the writer's files to the same frames, and the reader
    decodes PIL's (sub-rectangles, transparency) as PIL does."""
    from PIL import Image

    def pil_frames(path):
        im = Image.open(path)
        out = []
        for i in range(im.n_frames):
            im.seek(i)
            out.append(np.asarray(im.convert("RGB")))
        return np.stack(out)

    frames = frames_of(n=4)
    gif.write_gif(tmp_path / "own.gif", frames, 30)
    np.testing.assert_array_equal(pil_frames(tmp_path / "own.gif"),
                                  gif.read_gif(tmp_path / "own.gif")[0])
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(tmp_path / "pil.gif", save_all=True,
                 append_images=imgs[1:], duration=40, loop=0, optimize=True)
    got, delays = gif.read_gif(tmp_path / "pil.gif")
    np.testing.assert_array_equal(got, pil_frames(tmp_path / "pil.gif"))
    assert delays == [4] * len(got)


def test_save_video_with_imageio_as_jax_and_without(tmp_path, monkeypatch):
    from pronerf_tpu.render.renderer import save_video as j_save_video
    from pronerf_tpu_torch.render.renderer import save_video

    frames = frames_of().astype(np.float32) / 255.0
    # with imageio: the JAX package's calls (mp4; a GIF where no mp4
    # backend is installed), so the two write the same file
    got = save_video(frames, tmp_path / "port.mp4", fps=30)
    want = j_save_video(frames, tmp_path / "jax.mp4", fps=30)
    assert got.rsplit(".", 1)[1] == want.rsplit(".", 1)[1]
    if got.endswith(".gif"):
        np.testing.assert_array_equal(gif.read_gif(got)[0],
                                      gif.read_gif(want)[0])
    # without imageio: the port's own GIF writer, beside the asked path
    hide_imageio(monkeypatch)
    own = save_video(frames, tmp_path / "own.mp4", fps=30)
    assert own == str(tmp_path / "own.gif")
    f8 = np.stack([to8b(f) for f in frames])
    np.testing.assert_array_equal(gif.read_gif(own)[0],
                                  gif.palette()[gif.quantize(f8)])


@pytest.fixture(scope="module")
def llff_root(tmp_path_factory):
    from pronerf_tpu.utils.fixtures import (
        write_colmap_model,
        write_llff_dataset,
    )

    root = tmp_path_factory.mktemp("llff_video")
    write_llff_dataset(root, n=8, H=32, W=40, focal=36.0)
    write_colmap_model(root, n_images=8, n_points=50)
    return root


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX checkpoint of the release widths, read by both packages."""
    jparams = jax.tree_util.tree_map(np.asarray,
                                     j_init(jax.random.PRNGKey(3)))
    path = tmp_path_factory.mktemp("ckpt") / "000001.ckpt"
    return j_ckpt.save_checkpoint(path, {
        "global_step": np.int32(1), "network_fn": jparams["nerf"],
        "mmr_network_fn": jparams["sampler"],
        "refine_net": jparams["refine"]})


def test_run_render_path_matches_jax(llff_root, jax_ckpt, tmp_path,
                                     monkeypatch):
    import pronerf_tpu.render.renderer as j_renderer
    import pronerf_tpu_torch.render.infer as t_infer
    from pronerf_tpu import config as j_config
    from pronerf_tpu.render.infer import run_render_path as j_run_render_path
    from pronerf_tpu_torch.config import Config

    kw = dict(datadir=str(llff_root), factor=1, basedir=str(tmp_path),
              ft_path=jax_ckpt, tile_rays=0)
    path = "configs/llff/fern/fern_trt.txt"
    seen = {"jax": [], "port": []}

    def recorder(name, fn):
        def record(frames, out, fps=30):
            seen[name].append((np.asarray(frames), fps))
            return fn(frames, out, fps=fps)
        return record

    monkeypatch.setattr(j_renderer, "save_video",
                        recorder("jax", j_renderer.save_video))
    monkeypatch.setattr(t_infer, "save_video",
                        recorder("port", t_infer.save_video))
    j_run_render_path(j_config.Config.from_file(path, expname="j", **kw),
                      n_frames=3, fps=12)
    cfg = Config.from_file(path, expname="t", **kw)
    out = t_infer.run_render_path(cfg, n_frames=3, fps=12, device="cpu")
    assert out.startswith(str(tmp_path / "t" / "render_path."))
    (want, jfps), (got, fps) = seen["jax"][0], seen["port"][0]
    assert got.shape == want.shape == (3, 32, 40, 3) and fps == jfps == 12
    np.testing.assert_allclose(got, want, atol=5e-5)
    # the port's own writer where there is no imageio: frame for frame the
    # palette colour of the rendered frame
    hide_imageio(monkeypatch)
    own = t_infer.run_render_path(cfg.replace(expname="t2"), n_frames=3,
                                  fps=12, device="cpu")
    frames, delays = gif.read_gif(own)
    assert own.endswith(".gif") and delays == [8] * 3
    np.testing.assert_array_equal(
        frames, gif.palette()[gif.quantize(np.stack([to8b(f) for f in got]))])


def test_cli_render_path_on_cpu(llff_root, jax_ckpt, tmp_path, capsys,
                                monkeypatch):
    """The verb with the JAX flags and the serving defaults, through the
    fused kernels' plain versions; the GIF of the port's own writer (as on
    a machine without imageio)."""
    from pronerf_tpu_torch.cli import main

    hide_imageio(monkeypatch)
    out = main(["render-path", "--device", "cpu", "--use-trt", "--n-frames",
                "2", "--fps", "10", "--checkpoint", jax_ckpt, "--",
                "--datadir", str(llff_root), "--factor", "1", "--basedir",
                str(tmp_path), "--expname", "rp"])
    log = capsys.readouterr().out
    assert "[SERVING] --use-trt defaults: tile_rays=0 use_pallas=True" in log
    assert f"Saved render path video: {out} (2 frames)" in log
    frames, delays = gif.read_gif(out)
    assert out == str(tmp_path / "rp" / "render_path.gif")
    assert frames.shape == (2, 32, 40, 3) and delays == [10, 10]


def test_run_training_writes_the_spiral_video(tmp_path, monkeypatch):
    """i_video = 2 inside a 4-step stage-1 run: videos at steps 2 and 4 (the
    JAX rule ``i % i_video == 0 and i > start + 1``, the JAX trainer's file
    names); the frames at step 4 are the render of the final weights."""
    import pronerf_tpu.render.renderer as j_renderer
    import pronerf_tpu_torch.train.loop as t_loop
    from pronerf_tpu import config as j_config
    from pronerf_tpu.train.loop import run_training as j_run_training
    from pronerf_tpu_torch.config import Config
    from pronerf_tpu_torch.render.infer import load_params_for_inference
    from pronerf_tpu_torch.render.renderer import render_path
    from pronerf_tpu_torch.train.checkpoint import latest_checkpoint

    seen = []

    def record(frames, out, fps=30):
        seen.append(np.asarray(frames))
        return save(frames, out, fps=fps)

    save = t_loop.save_video
    monkeypatch.setattr(t_loop, "save_video", record)
    small = dict(datadir="synthetic:24x18x9", N_rand=64, netdepth=3,
                 netwidth=32, mmnetdepth=2, mmnetwidth=32, i_print=1,
                 i_weights=1000, i_img=0, i_testset=0, i_video=2,
                 tile_rays=0, basedir=str(tmp_path), max_steps=4)
    path = "configs/llff/fern/fern_epi.txt"
    state, exp = t_loop.run_training(
        Config.from_file(path, expname="t", **small), 1, device="cpu")
    names = sorted(p.name.rsplit(".", 1)[0] for p in exp.glob("spiral_*"))
    assert names == ["spiral_000002", "spiral_000004"] and len(seen) == 2
    data = t_loop.load_training_data(Config.from_file(path, **small))
    i_train = data["i_train"]
    from pronerf_tpu_torch.render.raygen import prepare_scene

    scene = prepare_scene(data["images"][i_train], data["poses"][i_train],
                          data["K"], device="cpu")
    cfg = Config.from_file(path, expname="t", **small)
    params = load_params_for_inference(latest_checkpoint(exp), cfg, "cpu")
    direct = render_path(data["render_poses"], params, scene,
                         t_loop._eval_statics(cfg, 1), data["H"], data["W"],
                         data["K"], tile_rays=0, device="cpu")["rgbs1"]
    assert seen[1].shape == (4, 18, 24, 3)
    np.testing.assert_array_equal(seen[1], direct)
    assert not np.array_equal(seen[0], seen[1])
    # the JAX trainer writes its videos at the same steps
    j_written = []
    monkeypatch.setattr(j_renderer, "save_video", lambda frames, out, fps=30:
                        j_written.append(out.name) or str(out))
    j_run_training(j_config.Config.from_file(path, expname="j", **small), 1)
    assert j_written == ["spiral_000002.mp4", "spiral_000004.mp4"]
