"""The port's command line (``python -m pronerf_tpu_torch.cli``) on a real
on-disk LLFF capture, on the CPU (``--device cpu``): the mirror of
tests/test_cli_llff.py::test_full_llff_workflow (train-stage1 ->
train-stage2 from its checkpoint -> infer / eval with greedy COLMAP
reference views), and the JAX command line and the port's, from one seed,
config and capture, training on the same ray pool with the same batches and
host draws step for step, and serving from the same reference views.
"""

import numpy as np
import pytest
import torch

from pronerf_tpu_torch.cli import main
from pronerf_tpu_torch.train import checkpoint as t_ckpt

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def llff_root(tmp_path_factory):
    from pronerf_tpu.utils.fixtures import (
        write_colmap_model,
        write_llff_dataset,
    )

    root = tmp_path_factory.mktemp("llff_ds")
    write_llff_dataset(root, n=8, H=32, W=40, focal=36.0)
    write_colmap_model(root, n_images=8, n_points=50)
    return root


def _common(root, basedir, expname, small=False, tile=True):
    args = [
        "--",
        "--datadir", str(root),
        "--factor", "1",
        "--basedir", str(basedir),
        "--expname", expname,
        "--N_rand", "128",
        "--i_print", "1",
        "--i_weights", "2",
        "--i_testset", "0",
    ]
    if tile:
        args += ["--tile_rays", "512"]
    if small:
        args += ["--netdepth", "3", "--netwidth", "32", "--mmnetdepth", "2",
                 "--mmnetwidth", "32"]
    return args


def test_full_llff_workflow(llff_root, tmp_path, capsys):
    cpu = ["--device", "cpu"]
    main(["train-stage1", "--no-reload", "--max-steps", "2"] + cpu
         + _common(llff_root, tmp_path, "s1"))
    s1 = sorted((tmp_path / "s1").glob("*.ckpt"))[-1]
    main(["train-stage2", "--no-reload", "--max-steps", "2",
          "--pretrain-path", str(s1)] + cpu
         + _common(llff_root, tmp_path, "s2"))
    s2 = sorted((tmp_path / "s2").glob("*.ckpt"))[-1]
    assert t_ckpt.load_checkpoint(s2)["global_step"] == 2
    capsys.readouterr()
    result = main(["infer", "--render-test", "--max-images", "1",
                   "--checkpoint", str(s2)] + cpu
                  + _common(llff_root, tmp_path, "inf"))
    out = capsys.readouterr().out
    assert "Mean Test PSNR" in out and f"Loading weights from {s2}" in out
    assert result["rgbs1"].shape == (1, 32, 40, 3)
    assert np.all(np.isfinite(result["psnrs"]))
    assert list((tmp_path / "inf" / "renderonly_test").glob("*.png"))
    assert (tmp_path / "inf" / "args.txt").exists()
    # eval with the serving defaults: bf16, whole frame, the kernels' plain
    # versions on CPU tensors; the same frame as the explicit flags give
    result = main(["eval", "--use-trt", "--max-images", "1", "--checkpoint",
                   str(s2)] + cpu
                  + _common(llff_root, tmp_path, "ev", tile=False))
    out = capsys.readouterr().out
    assert "[SERVING] --use-trt defaults: tile_rays=0 use_pallas=True" in out
    assert "Mean Test PSNR" in out and np.all(np.isfinite(result["rgbs1"]))
    explicit = main(["eval", "--use-trt", "--max-images", "1",
                     "--checkpoint", str(s2)] + cpu
                    + _common(llff_root, tmp_path, "ev2", tile=False)
                    + ["--tile_rays", "0", "--use_pallas", "True"])
    assert "[SERVING]" not in capsys.readouterr().out
    np.testing.assert_array_equal(explicit["rgbs1"], result["rgbs1"])


def _spy(monkeypatch, module, name, record):
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        record.append(out)
        return out

    monkeypatch.setattr(module, name, wrapped)


def _spy_steps(monkeypatch, module, record):
    """Record each stage-1 step's batch, ids and host draws."""
    make = module.make_stage1_steps

    def make_spied(*args, **kwargs):
        def spied(step):
            def run(state, scene, batch, bids, controls, lr):
                record.append({
                    "batch": np.asarray(batch), "bids": np.asarray(bids),
                    "lr": lr,
                    **{k: np.asarray(controls[k]) for k in (
                        "n_mult", "dir_expand", "dir_jitter",
                        "neighbor_subset")}})
                return step(state, scene, batch, bids, controls, lr)
            return run
        return tuple(spied(s) for s in make(*args, **kwargs))

    monkeypatch.setattr(module, "make_stage1_steps", make_spied)


def test_jax_and_port_command_lines_pick_the_same_pool_and_views(
        llff_root, tmp_path, monkeypatch):
    import pronerf_tpu.cli as j_cli
    import pronerf_tpu.render.infer as j_infer
    import pronerf_tpu.train.loop as j_loop
    import pronerf_tpu_torch.native as t_native
    import pronerf_tpu_torch.render.infer as t_infer
    import pronerf_tpu_torch.train.loop as t_loop

    monkeypatch.setenv("PRONERF_XLA_CACHE", "off")
    seen = {k: [] for k in ("j_pool", "t_pool", "j_steps", "t_steps",
                            "j_data", "t_data")}
    _spy(monkeypatch, j_loop, "build_ray_pool", seen["j_pool"])
    _spy(monkeypatch, t_loop, "build_ray_pool", seen["t_pool"])
    _spy_steps(monkeypatch, j_loop, seen["j_steps"])
    _spy_steps(monkeypatch, t_loop, seen["t_steps"])
    _spy(monkeypatch, j_infer, "load_inference_data", seen["j_data"])
    _spy(monkeypatch, t_infer, "load_inference_data", seen["t_data"])

    pool_calls = t_native.build_ray_pool_native.calls
    for run, name, extra in ((j_cli.main, "jax", []),
                             (main, "port", ["--device", "cpu"])):
        run(["train-stage1", "--no-reload", "--max-steps", "3"] + extra
            + _common(llff_root, tmp_path, f"{name}_s1", small=True))
        ckpt = sorted((tmp_path / f"{name}_s1").glob("*.ckpt"))[-1]
        run(["infer", "--render-test", "--max-images", "1", "--checkpoint",
             str(ckpt)] + extra
            + _common(llff_root, tmp_path, f"{name}_inf", small=True))
    if t_native.is_available():  # the JAX trainer took its native pool too
        assert t_native.build_ray_pool_native.calls == pool_calls + 1
    (jp, jids), (tp, tids) = seen["j_pool"][0], seen["t_pool"][0]
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tids, jids)
    assert len(seen["j_steps"]) == len(seen["t_steps"]) == 3
    for i, (j, t) in enumerate(zip(seen["j_steps"], seen["t_steps"])):
        assert j.keys() == t.keys()
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], err_msg=f"{i} {k}")
    jd, td = seen["j_data"][0], seen["t_data"][0]
    assert len(td["i_ref"]) == 4
    for k in ("i_ref", "i_test", "images", "poses", "render_poses", "K"):
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    assert (td["H"], td["W"], td["focal"]) == (jd["H"], jd["W"], jd["focal"])


def test_verbs_not_ported_and_bad_input_raise(llff_root, tmp_path,
                                              monkeypatch):
    # render-path is ported (tests/test_torch_video.py), and so are export
    # and export-trt (tests/test_torch_export.py): export-trt's --onnx-only
    # prints the JAX package's note and exports all the same
    paths = main(["export-trt", "--onnx-only", "--use-trt", "--height", "16",
                  "--width", "20", "--device", "cpu"]
                 + _common(llff_root, tmp_path, "trt")
                 + ["--mmnetdepth", "2", "--ft_path", ""])
    assert paths["executable"].name == "render_frame.pt2"
    assert all(p.exists() for p in paths.values())
    with pytest.raises(FileNotFoundError, match="no_such_checkpoint"):
        main(["export", "--checkpoint", str(tmp_path / "no_such_checkpoint"),
              "--device", "cpu"] + _common(llff_root, tmp_path, "exp"))
    # train-multi is ported too (tests/test_torch_multi_scene.py): both
    # stages run on the CPU with --device cpu
    states, names, exp = main(
        ["train-multi", "--no-reload", "--max-steps", "1", "--device", "cpu",
         "--scenes", f"{llff_root},{llff_root}"]
        + _common(llff_root, tmp_path, "multi", small=True))
    assert names == [llff_root.name] * 2 and len(states) == 2
    states, _, _ = main(
        ["train-multi", "--stage", "2", "--no-reload", "--max-steps", "1",
         "--pretrain-path", str(exp), "--device", "cpu", "--scenes",
         f"{llff_root},{llff_root}"]
        + _common(llff_root, tmp_path, "multi2", small=True))
    assert [s["global_step"] for s in states] == [1, 1]
    with pytest.raises(SystemExit):
        main(["train-stage1", "--no-such-flag"])
    with pytest.raises(SystemExit, match="Unknown config flag --no_such"):
        main(["train-stage1", "--device", "cpu", "--", "--no_such", "1"])
    # a missing capture raises, naming it, before anything is written
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "nowhere")):
        main(["train-stage1", "--device", "cpu", "--", "--datadir",
              str(tmp_path / "nowhere"), "--basedir", str(tmp_path)])
    # the card is the default
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["eval", "--use-trt"] + _common(llff_root, tmp_path, "card"))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["train-multi", "--max-steps", "1"]
             + _common(llff_root, tmp_path, "card_multi"))


def test_infer_timing_reps_prints_the_jax_summary_lines(llff_root, tmp_path,
                                                        capsys):
    """``infer --timing-reps`` ends with the JAX command line's two lines,
    in its order: the median of the timed eager frames under its own name
    (how it was timed in the bracket), then ``Median render ms/frame``, the
    steady-state frame of ``render_path``'s scan."""
    result = main(["infer", "--use-trt", "--max-images", "1",
                   "--timing-reps", "2", "--device", "cpu"]
                  + _common(llff_root, tmp_path, "timing")
                  + ["--ft_path", ""])
    out = capsys.readouterr().out.splitlines()
    ms = float(np.median(result["times_ms"]))
    ams = result["amortized_ms"]
    assert len(result["times_ms"]) == 2 and ams > 0
    assert out[-2:] == [
        "Median per-dispatch ms/frame (host clock around one eager frame on "
        f"cpu): {ms:.3f}",
        f"Median render ms/frame: {ams:.3f} "
        f"({32 * 40 / ams * 1e3 / 1e6:.2f} Mrays/s, steady-state)"]
    # the steady-state figure is the one of render_path's scan line
    scan = [ln for ln in out if ln.startswith(
        "Steady-state render ms/frame (scan x2 minus ")]
    assert len(scan) == 1 and scan[0].endswith(f": {ams:.3f}")
    assert sum(ln.startswith("Median") for ln in out) == 2
