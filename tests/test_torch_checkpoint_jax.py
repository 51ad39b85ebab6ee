"""Checkpoints of the JAX package in the port, on the CPU.

The JAX trainer (``pronerf_tpu.train.loop.run_training``) writes real
stage-1 and stage-2 checkpoints at small widths (2 steps of stage 1 without
weight decay, 2 of stage 2 with it, so that both of optax's state forms
occur; the JAX trainer bootstraps stage 2 only from a stage 1 of the same
weight decay, so this stage 2 starts from its own init); the port reads
them:

- the msgpack decoder equals flax's ``msgpack_restore``, tree and dtypes;
- every net tensor equals its JAX leaf bit for bit (``w`` transposed), and
  so do Adam's moments and counts, under the port's parameter names;
- the port's trainer bootstraps stage 2 from a JAX stage-1 expdir and
  resumes a JAX expdir (global step, nets, both optimizers);
- a frame served by the port from a JAX checkpoint equals the JAX render of
  the same checkpoint, within the f32 bounds of tests/test_torch_render.py
  (5e-5 on colours, 5e-4 on depth).
"""

import shutil

import msgpack
import numpy as np
import pytest
import torch

import jax
from flax import serialization

from pronerf_tpu import config as j_config
from pronerf_tpu.train import checkpoint as j_ckpt
from pronerf_tpu.train.loop import run_training as j_run_training
from pronerf_tpu_torch.config import Config
from pronerf_tpu_torch.render.infer import load_params_for_inference
from pronerf_tpu_torch.train import checkpoint as t_ckpt
from pronerf_tpu_torch.train.loop import run_training

torch.set_num_threads(2)

SMALL = dict(datadir="synthetic:24x18x9", N_rand=64, netdepth=3, netwidth=32,
             mmnetdepth=2, mmnetwidth=32, i_print=1, i_weights=1000,
             i_img=0, i_testset=0, i_video=0, tile_rays=0)


def cfgs(stage, basedir, **kw):
    """(JAX Config, port Config) of a release config at small widths."""
    name = "fern_epi.txt" if stage == 1 else "fern_refine.txt"
    path = f"configs/llff/fern/{name}"
    # stage 2 without the config's pretrain_path (a reference checkpoint)
    # unless one is given
    kw = SMALL | {"basedir": str(basedir), "expname": f"s{stage}",
                  "pretrain_path": ""} | kw
    return (j_config.Config.from_file(path, **kw),
            Config.from_file(path, **kw))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX expdirs of stage 1 (2 steps, no weight decay) and stage 2 (2
    steps, weight decay 1e-3)."""
    base = tmp_path_factory.mktemp("jax")
    jcfg1, _ = cfgs(1, base, max_steps=2, weight_decay=0.0)
    _, exp1 = j_run_training(jcfg1, 1)
    jcfg2, _ = cfgs(2, base, max_steps=2, weight_decay=1e-3)
    _, exp2 = j_run_training(jcfg2, 2)
    return {"base": base, 1: exp1, 2: exp2,
            "ckpt1": j_ckpt.latest_checkpoint(exp1),
            "ckpt2": j_ckpt.latest_checkpoint(exp2)}


def expected_net(tree):
    """The port's state_dict of a JAX net pytree, by name: path a.0.b +
    'w' -> 'a.0.b.weight' (transposed), 'b' -> '.bias'."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + [str(k)])
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + [str(i)])
        else:
            name = ".".join(path[:-1])
            out[name + (".weight" if path[-1] == "w" else ".bias")] = (
                t.T if path[-1] == "w" else t)

    walk(tree, [])
    return out


def flatten(tree, prefix=""):
    if isinstance(tree, dict):
        return {name: leaf for k, v in tree.items()
                for name, leaf in flatten(v, f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree}


def assert_tensors_equal(got: dict, want: dict, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k]
        assert g.dtype == torch.float32 and w.dtype == np.float32, (what, k)
        assert tuple(g.shape) == w.shape, (what, k)
        assert np.array_equal(g.numpy(), w), (what, k)


@pytest.mark.parametrize("stage", [1, 2])
def test_jax_checkpoints_load_bit_for_bit(jax_run, stage):
    path = jax_run[f"ckpt{stage}"]
    data = open(path, "rb").read()
    # the decoder against flax's
    want_tree = serialization.msgpack_restore(data)
    got_tree = t_ckpt.msgpack_restore(data)
    same = jax.tree_util.tree_map(
        lambda a, b: np.asarray(a).dtype == np.asarray(b).dtype
        and np.array_equal(a, b), got_tree, want_tree)
    assert jax.tree_util.tree_structure(got_tree) == \
        jax.tree_util.tree_structure(want_tree)
    assert all(jax.tree_util.tree_leaves(same))

    raw = j_ckpt.load_checkpoint(path)  # lists restored
    ck = t_ckpt.load_checkpoint(path)
    assert ck["format"] == t_ckpt.JAX_FORMAT
    assert set(ck) == set(raw) | {"format"}
    assert ck["global_step"] == int(raw["global_step"]) == 2
    nets = [k for k in raw if k in ("network_fn", "network_fine",
                                    "mmr_network_fn", "refine_net")]
    opts = [k for k in raw if k in ("optimizer", "s_optimizer",
                                    "optimizer_state_dict", "optimizer_nerf")]
    assert len(nets) == 3 + (stage == 2) and len(opts) == 2
    for k in nets:
        assert_tensors_equal(ck[k], expected_net(raw[k]), k)
    for k in opts:
        adam = raw[k]
        if isinstance(adam, list):  # optax.chain(add_decayed_weights, adam)
            assert stage == 2 and adam[0] == {}
            adam = adam[1]
        assert ck[k]["count"] == int(adam["count"])
        for part in ("mu", "nu"):
            tree = adam[part]
            if "nerf" in tree:
                want = {f"{net}.{n}": v for net in ("nerf", "sampler",
                                                    "refine")
                        for n, v in expected_net(tree[net]).items()}
            else:
                want = {f"nerf.{n}": v for n, v in expected_net(tree).items()}
            assert_tensors_equal(ck[k][part], want, f"{k}.{part}")
    # the trained moments are not zero: the comparison saw real values
    stepped = "s_optimizer" if stage == 1 else "optimizer_state_dict"
    assert ck[stepped]["count"] >= 1
    assert any(v.abs().sum() > 0 for v in ck[stepped]["nu"].values())
    # the inference loader takes the NeRF of the stage
    _, tcfg = cfgs(2, jax_run["base"], expname="serve")
    params = load_params_for_inference(path, tcfg, "cpu")
    nerf = "network_fine" if stage == 2 else "network_fn"
    assert torch.equal(params["nerf"].pts[0].weight,
                       ck[nerf]["pts.0.weight"])


def test_msgpack_decoder_covers_what_flax_writes(tmp_path, monkeypatch):
    # every type a state dict can hold, packed as flax packs it
    tree = {"i": [0, 127, 128, 65536, 2**40, -1, -33, -129, -2**40],
            "f": 1.5, "t": True, "n": None, "s": "x" * 40, "b": b"\x00\x01",
            "scalar": np.float32(2.5), "arr": np.arange(6, dtype=np.int16),
            "nested": {str(k): np.full((2, k), k, np.float64)
                       for k in range(20)}}
    data = serialization.msgpack_serialize(tree)
    got, want = t_ckpt.msgpack_restore(data), serialization.msgpack_restore(
        data)
    assert got.keys() == want.keys()
    assert got["i"] == want["i"] and got["s"] == want["s"]
    assert got["f"] == 1.5 and got["t"] is True and got["n"] is None
    assert got["b"] == b"\x00\x01"
    assert type(got["scalar"]) is np.float32 and got["scalar"] == 2.5
    for k in ("arr",):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    for k, v in want["nested"].items():
        np.testing.assert_array_equal(got["nested"][k], v)
    # flax's chunked form of a large array
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    big = {"w": np.arange(300, dtype=np.float32).reshape(20, 15)}
    data = serialization.msgpack_serialize(big)
    assert b"__msgpack_chunked_array__" in data
    np.testing.assert_array_equal(t_ckpt.msgpack_restore(data)["w"],
                                  big["w"])
    # what flax does not write for a checkpoint raises
    with pytest.raises(ValueError, match="ext type 2"):
        t_ckpt.msgpack_restore(msgpack.packb(msgpack.ExtType(2, b"xx")))
    with pytest.raises(ValueError, match="after the object"):
        t_ckpt.msgpack_restore(msgpack.packb({"a": 1}) + b"\x00")


def test_unmappable_jax_layouts_raise_naming_the_key(tmp_path):
    import jax.numpy as jnp

    for state, key in (
            ({"global_step": jnp.int32(1), "explore_net": {"w": 1.0}},
             "explore_net"),
            ({"global_step": jnp.int32(1),
              "network_fn": {"w": jnp.ones((2, 2))}}, "network_fn"),
            ({"optimizer": {"mu": {}, "nu": {}}}, "optimizer")):
        path = j_ckpt.save_checkpoint(tmp_path / f"{key}.ckpt", state)
        with pytest.raises(ValueError, match=f"'{key}'"):
            t_ckpt.load_checkpoint(path)
    (tmp_path / "x.ckpt").write_bytes(b"\x00\x01")
    with pytest.raises(ValueError, match="neither"):
        t_ckpt.load_checkpoint(tmp_path / "x.ckpt")


def test_port_trainer_bootstraps_and_resumes_from_jax_expdirs(jax_run,
                                                              tmp_path,
                                                              capsys):
    raw1 = t_ckpt.load_checkpoint(jax_run["ckpt1"])
    # stage 2 from the JAX stage-1 expdir, no step: the nets it starts from
    _, tcfg = cfgs(2, tmp_path, max_steps=0, pretrain_path=str(jax_run[1]))
    _, exp = run_training(tcfg, 2, device="cpu")
    start = t_ckpt.load_checkpoint(t_ckpt.latest_checkpoint(exp))
    for port_key, jax_key in (("network_fine", "network_fn"),
                              ("mmr_network_fn", "mmr_network_fn"),
                              ("refine_net", "refine_net")):
        for k, v in raw1[jax_key].items():
            assert torch.equal(start[port_key][k], v), (port_key, k)

    # auto-resume of each JAX expdir: step, nets and both optimizers, as
    # the port's checkpoint of the resumed state before a step shows
    for stage in (1, 2):
        base = tmp_path / f"resume{stage}"
        shutil.copytree(jax_run[stage], base / f"s{stage}")
        wd = 0.0 if stage == 1 else 1e-3
        before = t_ckpt.load_checkpoint(jax_run[f"ckpt{stage}"])
        _, exp = run_training(cfgs(stage, base, max_steps=0,
                                   weight_decay=wd)[1], stage, device="cpu")
        resumed = t_ckpt.load_checkpoint(t_ckpt.latest_checkpoint(exp))
        assert resumed.pop("format") == t_ckpt.FORMAT
        want, got = flatten(before), flatten(resumed)
        assert set(got) == set(want) - {"format"}
        for k, v in got.items():
            assert (torch.equal(v, want[k]) if torch.is_tensor(v)
                    else v == want[k]), (stage, k)
        _, tcfg = cfgs(stage, base, max_steps=2, weight_decay=wd)
        capsys.readouterr()
        state, _ = run_training(tcfg, stage, device="cpu")
        assert "Reloading from" in capsys.readouterr().out
        assert state["global_step"] == 4
        if stage == 1:
            counts = {"opt_nerf": "optimizer", "opt_s": "s_optimizer"}
            steps = {"opt_nerf": 1, "opt_s": 1}
        else:
            counts = {"opt": "optimizer_state_dict",
                      "opt_nerf": "optimizer_nerf"}
            steps = {"opt": 2, "opt_nerf": 0}
        for opt, key in counts.items():
            assert state[opt]["count"] == before[key]["count"] + steps[opt]


def test_frame_from_jax_checkpoint_equals_jax_render(jax_run, tmp_path):
    from pronerf_tpu.render.infer import run_inference as j_run_inference
    from pronerf_tpu_torch.render.infer import run_inference

    kw = dict(basedir=str(tmp_path), ft_path=jax_run["ckpt2"], use_trt=False,
              use_pallas=False, tile_rays=0, max_images=1,
              **{k: SMALL[k] for k in ("datadir", "netdepth", "netwidth",
                                       "mmnetdepth", "mmnetwidth")})
    path = "configs/llff/fern/fern_trt.txt"
    want = j_run_inference(j_config.Config.from_file(path, expname="j", **kw))
    got = run_inference(Config.from_file(path, expname="t", **kw),
                        device="cpu")
    for key, atol in (("rgbs1", 5e-5), ("rgbs0", 5e-5), ("depths", 5e-4)):
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape == ((1, 18, 24) + g.shape[3:]), key
        np.testing.assert_allclose(g, w, atol=atol, err_msg=key)
    # and the trained weights matter: not the frame of random ones
    rand = run_inference(Config.from_file(path, expname="r",
                                          **(kw | {"ft_path": ""})),
                         device="cpu")
    assert not np.allclose(rand["rgbs1"], got["rgbs1"], atol=1e-3)


def test_ckpt_tool_reads_both_formats(jax_run, tmp_path, capsys):
    from pronerf_tpu_torch.tools.ckpt import main

    main(["show", "-v", jax_run["ckpt2"]])
    out = capsys.readouterr().out
    assert t_ckpt.JAX_FORMAT in out and "global_step: 2" in out
    assert "network_fine" in out and "pts.0.weight" in out
    # the JAX checkpoint re-saved in the port's format diffs to 0
    port = t_ckpt.save_checkpoint(tmp_path / "000002.ckpt",
                                  t_ckpt.load_checkpoint(jax_run["ckpt2"]))
    main(["show", port])
    assert t_ckpt.FORMAT in capsys.readouterr().out
    main(["diff", jax_run["ckpt2"], port])
    out = capsys.readouterr().out
    assert "global_step: 2 -> 2" in out
    assert out.count("max|delta| = 0.000e+00") == 6
    main(["diff", jax_run["ckpt1"], port])
    out = capsys.readouterr().out
    assert "optimizer_nerf         only in B" in out
    assert "s_optimizer            only in A" in out
