"""The NeRF kernels' positional encoding, taken from the f32 query points.

The JAX package's Pallas kernels (``fused_nerf._forward``,
``fused_nerf_q._forward_q``) round the points to the pack dtype before
``bx_t . x``; its XLA serving path encodes the f32 points and rounds after
(``models/mlp.py:nerf_mlp_apply``). The port's kernels and plain versions
encode as the XLA path does. The port's other kernel tests hold it to JAX's
kernels with that one line repaired (``torch_jax_pe``); this file shows

- that the repaired copies differ from JAX's functions in that line only;
- that the repair changes nothing else: on points that are already
  bf16-exact, the port equals the UNPATCHED JAX kernels at the tolerances of
  ``test_torch_kernels.py`` and ``test_torch_kernels_q.py``;
- what it is worth on trained weights: the JAX package's full-schedule
  checkpoint (``results/soak/s2/370000.ckpt``, read by the port's own
  msgpack decoder) served on a crop of a held-out view of
  ``synthetic:504x378x17`` through four paths.

Tolerances on the crop (32 full-width rows of held-out view 8, 16,128 rays;
PSNR of rgb1 against the view):
- the port's kernel path within 0.1 dB of JAX's XLA bf16 path and of the
  port's own kernel-free path (measured 0.019 dB: the kernel path and the
  XLA path round the same values at the same points, but the kernel's
  panels sum in another order, and a sum on a bf16 boundary moves a point's
  raw output by a unit; on the three whole views the means are 0.009 dB
  apart), and the mean difference of their rgb1 within 5e-4 (measured
  1.5e-4; the unrepaired kernel 1.6e-3);
- JAX's repaired Pallas path within 0.2 dB of its XLA path (measured
  0.052 dB; interpret mode sums its bf16 products in yet another order);
- JAX's unrepaired Pallas path at least 1 dB below its XLA path (measured
  2.50 dB here, 3.6 dB on the whole views): the reference's fault, held so
  that a change on either side shows;
- rgb0 (the sampler's colours, before any NeRF kernel) within 0.01 dB on all
  four paths (measured 5e-5 dB): the repair touches no MinMax kernel.
"""

import dataclasses
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_jax_pe
from pronerf_tpu import config as j_config
from pronerf_tpu.kernels import fused_nerf as j_fn
from pronerf_tpu.kernels import fused_nerf_q as j_fq
from pronerf_tpu.models import render_rays as j_render_rays
from pronerf_tpu.render import infer as j_infer
from pronerf_tpu.render import prepare_scene as j_prepare_scene
from pronerf_tpu.render.raygen import rays_for_pose as j_rays_for_pose
from pronerf_tpu.train import loop as j_loop
from pronerf_tpu_torch.config import Config
from pronerf_tpu_torch.kernels import fused_nerf as t_fn
from pronerf_tpu_torch.kernels import fused_nerf_q as t_fq
from pronerf_tpu_torch.models.pronerf import render_rays
from pronerf_tpu_torch.render import infer as t_infer
from test_torch_kernels import (
    BF16_COMP,
    BF16_LOGITS,
    j_vcon_t,
    nerf_inputs,
    nerf_nets,
)
from test_torch_kernels_q import LAST_BIT, MAX_OVER_STD, SHARE_DIFFERENT
from test_torch_kernels_q import inputs as q_inputs
from test_torch_kernels_q import j_vcon_t as q_vcon_t
from test_torch_kernels_q import nets as q_nets
from test_torch_kernels_q import sweep

# The suite runs several workers side by side; two threads a worker keep
# PyTorch's CPU kernels from crowding the other workers' tests.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "results/soak/s2/370000.ckpt"
TRT = ROOT / "configs/llff/fern/fern_trt.txt"
SPEC = "synthetic:504x378x17"
VIEW, ROWS = 1, 32   # held-out view i_test[1] = 8, 32 rows about the middle

PSNR_TO_XLA_DB = 0.1
MEAN_RGB_TO_XLA = 5e-4
PATCHED_JAX_TO_XLA_DB = 0.2
FAULT_DB = 1.0
RGB0_DB = 0.01


def T(a):
    return torch.from_numpy(np.array(a))


def bf16_exact(a):
    return T(a).to(torch.bfloat16).float().numpy()


# ------------------------------------------------------ the JAX copies --

def _body(fn):
    """Source lines of ``fn`` after its docstring, comments stripped."""
    lines = inspect.getsource(fn).splitlines()
    doc = fn.__doc__
    start = next(i for i, ln in enumerate(lines) if ln.strip().startswith(
        ('"""', "'''"))) if doc else 0
    end = start + (doc.count("\n") + 1 if doc else 0)
    return [ln.split("#")[0].rstrip() for ln in lines[end:]
            if ln.split("#")[0].strip()]


@pytest.mark.parametrize("name,module", [("_forward", j_fn),
                                         ("_forward_q", j_fq)])
def test_reference_copies_differ_from_jax_in_the_pe_line_only(name, module):
    jax_body = _body(getattr(module, name))
    copy = _body(getattr(torch_jax_pe, name))
    # the copy binds the module's helpers on its first line
    assert copy[0].lstrip().startswith("_mm")
    copy = copy[1:]
    assert len(copy) == len(jax_body)
    differ = [(a.strip(), b.strip()) for a, b in zip(jax_body, copy) if a != b]
    assert len(differ) == 1
    jax_line, copy_line = differ[0]
    assert jax_line.startswith("xb = _mm")
    assert copy_line == "xb = pe_args(pts3)"


def test_the_patch_is_undone_on_exit():
    saved = j_fn._forward, j_fq._forward_q
    with torch_jax_pe.f32_pe():
        assert j_fn._forward is torch_jax_pe._forward
        assert j_fq._forward_q is torch_jax_pe._forward_q
    assert (j_fn._forward, j_fq._forward_q) == saved


# ------------------------------------- nothing else changed by the repair --

@pytest.mark.parametrize("n", [64, 50])
def test_raw_on_bf16_exact_points_equals_the_unpatched_jax_kernel(n):
    jp, net = nerf_nets()
    inp = nerf_inputs(n)
    pts = bf16_exact(inp["pts24_t"])
    vcon = np.asarray(j_vcon_t(jp, inp["dirs"], jnp.bfloat16))
    want = j_fn.fused_nerf_raw_t(
        j_fn.pack_nerf_params(jp, jnp.bfloat16), jnp.asarray(pts),
        jnp.asarray(vcon), rays_per_block=32, interpret=True)
    got = t_fn.fused_nerf_raw_t(
        t_fn.pack_nerf_params(net, torch.bfloat16), T(pts), T(vcon))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=BF16_LOGITS)


def test_composite_on_bf16_exact_points_equals_the_unpatched_jax_kernel():
    jp, net = nerf_nets(seed=4)
    inp = nerf_inputs(64, seed=5)
    pts = bf16_exact(inp["pts24_t"])
    vcon = np.asarray(j_vcon_t(jp, inp["dirs"], jnp.bfloat16))
    dnorm = np.linalg.norm(inp["rays_d"], axis=-1)[None, :].astype(np.float32)
    aux = [np.ascontiguousarray(inp[k].T) for k in ("z", "mm_add", "mm_mul")]
    want = j_fn.fused_nerf_composite_t(
        j_fn.pack_nerf_params(jp, jnp.bfloat16), jnp.asarray(pts),
        jnp.asarray(vcon), *(jnp.asarray(a) for a in aux), jnp.asarray(dnorm),
        rays_per_block=32, interpret=True)
    got = t_fn.fused_nerf_composite_t(
        t_fn.pack_nerf_params(net, torch.bfloat16), T(pts), T(vcon),
        *(T(a) for a in aux), T(dnorm))
    for k in ("rgb", "depth", "acc", "weights"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=BF16_COMP, err_msg=k)
    np.testing.assert_allclose(got["sigma"].numpy(), np.asarray(want["sigma"]),
                               atol=BF16_LOGITS)


def test_int8_on_bf16_exact_points_equals_the_unpatched_jax_kernel():
    from pronerf_tpu_torch import convert

    jp, _ = q_nets()
    pts_s, dirs_s = sweep()
    j_ranges = j_fq.calibrate_nerf_ranges(jp, pts=jnp.asarray(pts_s),
                                          dirs=jnp.asarray(dirs_s))
    j_packed = j_fq.pack_nerf_params_int8(jp, ranges=j_ranges)
    packed = convert.packed_q_from_numpy(
        jax.tree_util.tree_map(np.asarray, j_packed))
    pts24_t, dirs = q_inputs(128, seed=128)
    pts = bf16_exact(pts24_t)
    vcon = q_vcon_t(jp, dirs)
    want = np.asarray(j_fq.fused_nerf_raw_tq(
        j_packed, jnp.asarray(pts), jnp.asarray(vcon), rays_per_block=32,
        interpret=True))
    got = t_fq.fused_nerf_raw_tq(packed, T(pts), T(vcon)).numpy()
    diff, std = np.abs(got - want), want.std()
    assert (diff > LAST_BIT * std).mean() <= SHARE_DIFFERENT
    assert diff.max() <= MAX_OVER_STD * std


def test_plain_versions_encode_the_f32_points():
    """The sin/cos arguments are 2^k x of the f32 point, exactly; the bf16
    point's are not (the fault this file is about)."""
    pts = T(nerf_inputs(16)["pts24_t"]).T.reshape(16, 8, 3)
    bx = t_fn.pack_nerf_params(nerf_nets()[1], torch.bfloat16)["bx_t"]
    got = t_fn.pe_args(pts, bx)
    want = torch.cat([torch.ldexp(pts, torch.tensor(k)) for k in range(10)],
                     dim=-1)
    assert torch.equal(got, want)
    rounded = t_fn.pe_args(pts.to(torch.bfloat16).float(), bx)
    assert (rounded[..., 27:] - want[..., 27:]).abs().max() > 0.5


# --------------------------------------------- the trained checkpoint ----

@pytest.fixture(scope="module")
def trained():
    """The crop rendered through the four paths, and its ground truth."""
    cfg = Config.from_file(TRT, datadir=SPEC, use_trt=True, use_pallas=True,
                           tile_rays=0)
    jcfg = j_config.Config.from_file(TRT, datadir=SPEC, use_trt=True,
                                     use_pallas=True, tile_rays=0)
    data = t_infer.load_inference_data(cfg)
    H, W = data["H"], data["W"]
    i = data["i_test"][VIEW]
    pose = data["poses"][i]
    r0 = H // 2 - ROWS // 2
    jrays = {k: np.asarray(v).reshape(H, W, -1)[r0:r0 + ROWS]
             .reshape(ROWS * W, *v.shape[1:])
             for k, v in j_rays_for_pose(H, W, data["K"], pose).items()}
    gt = data["images"][i][r0:r0 + ROWS].reshape(-1, 3).astype(np.float64)

    params = t_infer.load_params_for_inference(str(CKPT), cfg, "cpu")
    scene = t_infer._serving_scene(cfg, data, "cpu")
    rays = {k: T(v) for k, v in jrays.items()}
    controls = {"target_t": T(np.asarray(pose[:3, 3], np.float32))}

    jparams = j_loop.load_params_for_inference(
        str(CKPT), j_loop._init_params(jcfg, jax.random.PRNGKey(jcfg.seed)))
    ref = data["i_ref"]
    jscene = j_prepare_scene(data["images"][ref], data["poses"][ref],
                             data["K"], pack_corners="u8")
    jcontrols = {"rng": jax.random.PRNGKey(0),
                 "target_t": jnp.asarray(pose[:3, 3])}

    def jax_path(use_pallas):
        statics = j_infer._infer_statics(
            dataclasses.replace(jcfg, use_pallas=use_pallas), use_bf16=True)
        out = j_render_rays(jparams, jrays, jscene, jcontrols, statics)
        return {k: np.asarray(v, np.float32) for k, v in out.items()}

    def port_path(use_pallas):
        statics = t_infer._infer_statics(cfg.replace(use_pallas=use_pallas),
                                         use_bf16=True)
        with torch.no_grad():
            out = render_rays(params, rays, scene, controls, statics)
        return {k: v.numpy() for k, v in out.items()}

    outs = {"jax_xla": jax_path(False), "jax_pallas": jax_path(True),
            "port_kernels": port_path(True), "port_xla": port_path(False)}
    with torch_jax_pe.f32_pe():
        outs["jax_pallas_f32_pe"] = jax_path(True)

    def psnr(x):
        return float(-10.0 * np.log10(np.mean((x.astype(np.float64) - gt)**2)))

    return {name: {"psnr1": psnr(o["rgb1"]), "psnr0": psnr(o["rgb0"]),
                   "rgb1": o["rgb1"]} for name, o in outs.items()}


@pytest.mark.parametrize("ref", ["jax_xla", "port_xla"])
def test_trained_kernel_path_matches_the_xla_path(trained, ref):
    got, want = trained["port_kernels"], trained[ref]
    assert abs(got["psnr1"] - want["psnr1"]) <= PSNR_TO_XLA_DB, (
        got["psnr1"], want["psnr1"])
    assert np.abs(got["rgb1"] - want["rgb1"]).mean() <= MEAN_RGB_TO_XLA


def test_trained_jax_pallas_path_is_below_by_the_fault(trained):
    xla, pallas = trained["jax_xla"]["psnr1"], trained["jax_pallas"]["psnr1"]
    assert pallas <= xla - FAULT_DB, (pallas, xla)
    assert trained["port_kernels"]["psnr1"] >= pallas + FAULT_DB
    # the repaired reference the other kernel tests use recovers it
    patched = trained["jax_pallas_f32_pe"]["psnr1"]
    assert abs(patched - xla) <= PATCHED_JAX_TO_XLA_DB, (patched, xla)


def test_trained_sampler_colours_are_the_same_on_every_path(trained):
    psnr0 = [v["psnr0"] for v in trained.values()]
    assert max(psnr0) - min(psnr0) <= RGB0_DB, psnr0
