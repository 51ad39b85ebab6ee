"""The NeRF kernel's inputs as one op (``pronerf_tpu_torch/kernels/
query_prep.py``, ``pronerf::query_prep``) on the CPU, where it runs its plain
version, the chain ``query_inputs_chain``; the kernel itself is held to the
chain on the card by ``tests/test_torch_query_prep_card.py``.

- the op is registered with its schema, passes ``torch.library.opcheck`` and
  its fake implementation gives the outputs' shapes;
- its CPU implementation equals the lines ``render_rays`` ran before the op
  (the refine epilogue, the query points, the view term, the composite's
  transposed rows, the norm and the mean) bit for bit, on logits with NaN,
  +-inf and saturating magnitudes, for the NeRF MLP's 128 view rows and
  DoNeRF's 4;
- ``render_rays`` with ``use_kernels`` takes the op wherever the MinMax
  kernel ran the refine net and S <= 32, and its frames equal those of the
  chain; S > 32, another view encoding and every training route keep the
  chain;
- the kernel-free path takes the offsets' tanh only where it reads it;
- ``differences``, the contract the card tests read, reads 0 on the chain
  and counts a planted fault.
"""

import dataclasses

import pytest
import torch

from pronerf_tpu_torch.kernels import query_prep as qp
from pronerf_tpu_torch.models import pronerf
from pronerf_tpu_torch.models.pronerf import (
    RenderStatics,
    init_pronerf_params,
    render_rays,
)
from pronerf_tpu_torch.ops.encoding import positional_encoding
from pronerf_tpu_torch.ops.sampling import bin_constrain
from pronerf_tpu_torch.render.raygen import prepare_scene, rays_for_pose
from pronerf_tpu_torch.render.renderer import make_frame_renderer
from pronerf_tpu_torch.utils.profiling import COUNTERS
from pronerf_tpu_torch.utils.synthetic import make_scene

torch.set_num_threads(2)

ROWS = {"nerf": 128, "donerf": 4}


def old_chain(refine_out, depth_values, mm_add, mm_mul, ndc_o, ndc_d,
              viewdirs, view_w, S, near, far, offset_scale, add_offsets):
    """The lines of ``render_rays``' steps 4 to 6 before the op, on the
    route that composites in the NeRF kernel."""
    refine_sig = torch.sigmoid(refine_out[:, :S])
    refine_rgb = torch.sigmoid(refine_out[:, 4 * S:])
    z_vals = bin_constrain(depth_values, refine_sig, near, far)
    d_pe = positional_encoding(viewdirs, 4)
    vcon_t = (view_w.to(torch.bfloat16).float()
              @ d_pe.to(torch.bfloat16).float().T)
    n_rays = ndc_o.shape[0]
    pts24_t = (
        ndc_o.T[None, :, :]
        + ndc_d.T[None, :, :] * z_vals.T[:, None, :]
    ).reshape(3 * S, n_rays)
    if add_offsets:
        pts24_t = pts24_t + offset_scale * torch.tanh(
            refine_out[:, S: 4 * S].T
        )
    pts24_t = pts24_t.float().contiguous()
    dnorm = torch.linalg.norm(ndc_d, dim=-1)[None, :]
    return (refine_rgb, pts24_t, vcon_t, z_vals.T.float().contiguous(),
            mm_add.T.float().contiguous(), mm_mul.T.float().contiguous(),
            dnorm.float().contiguous(), torch.mean(z_vals.detach(), dim=-1))


def op_inputs(n, S, rows, seed=0, special=True):
    """The op's tensor inputs at ``n`` rays: a refine output laid out as the
    MinMax kernel's ([N, 8-padded 4 S + 3], sliced), sorted depths in
    [0, 1], corrections, rays and the view columns of a [rows, 283]
    weight; with ``special``, NaN, +-inf, +-1e30 and saturating values
    planted among the logits, the depths and the corrections."""
    g = torch.Generator().manual_seed(seed)
    width = 4 * S + 3
    refine = torch.randn(n, -(-width // 8) * 8, generator=g) * 3
    depth = torch.sort(torch.rand(n, S, generator=g), dim=-1).values
    mm_add = torch.randn(n, S, generator=g)
    mm_mul = torch.rand(n, S, generator=g)
    if special:
        values = torch.tensor([float("nan"), float("inf"), -float("inf"),
                               1e30, -1e30, 100.0, -110.0, 0.0, -0.0])
        pick = torch.rand(n, width, generator=g) < 0.08
        idx = torch.randint(len(values), (n, width), generator=g)
        refine[:, :width] = torch.where(pick, values[idx],
                                        refine[:, :width])
        for k, v in enumerate(values.tolist()):  # each one at least once
            refine[k % n, k % width] = v
        depth[::5, -1] = float("nan")
        mm_add[::3, 0] = float("nan")
        mm_mul[1::4, -1] = float("inf")
    rays = [torch.randn(n, 3, generator=g) for _ in range(2)]
    dirs = torch.nn.functional.normalize(torch.randn(n, 3, generator=g),
                                         dim=-1)
    view_w = (torch.randn(rows, 283, generator=g) * 0.1)[:, 256:]
    return (refine[:, :width], depth, mm_add, mm_mul, *rays, dirs, view_w)


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


SCHEMA = ("pronerf::query_prep(Tensor refine_out, Tensor depth_values, "
          "Tensor mm_add, Tensor mm_mul, Tensor ndc_o, Tensor ndc_d, Tensor "
          "viewdirs, Tensor view_w, SymInt n_samples, float near, float far, "
          "float offset_scale, bool add_offsets, SymInt multires_views) -> "
          "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")


@pytest.mark.parametrize("arch", list(ROWS))
@pytest.mark.parametrize("S", [8, 16])
def test_op_is_registered_and_passes_opcheck(S, arch):
    op = torch.ops.pronerf.query_prep.default
    assert op is qp.query_prep_op
    assert str(op._schema) == SCHEMA
    ins = op_inputs(13, S, ROWS[arch], seed=S, special=False)
    torch.library.opcheck(op, (*ins, S, 0.0, 1.0, 1e-2, True, 4))
    torch.library.opcheck(op, (*ins, S, 1e-6, 1.0, 1e-2, False, 4))
    assert qp.query_inputs.launches == 0  # no launch on the CPU


@pytest.mark.parametrize("S", [8, 16])
def test_fake_implementation_gives_the_shapes(S):
    from torch._subclasses.fake_tensor import FakeTensorMode

    n, rows = 37, ROWS["nerf"]
    with FakeTensorMode() as mode:
        ins = [mode.from_tensor(t) for t in op_inputs(n, S, rows,
                                                       special=False)]
        outs = qp.query_prep_op(*ins, S, 0.0, 1.0, 1e-2, True, 4)
    shapes = [(n, 3), (3 * S, n), (rows, n), (S, n), (S, n), (S, n),
              (1, n), (n,)]
    assert [tuple(o.shape) for o in outs] == shapes
    assert all(o.dtype == torch.float32 and o.is_contiguous() for o in outs)


@pytest.mark.parametrize("arch", list(ROWS))
@pytest.mark.parametrize("S", [8, 16])
@pytest.mark.parametrize("n", [1, 7, 4099])
def test_cpu_op_equals_the_old_chain_bit_for_bit(n, S, arch):
    ins = op_inputs(n, S, ROWS[arch], seed=n + S)
    got = qp.query_inputs(*ins, S, 0.0, 1.0, 1e-2, True, 4)
    want = old_chain(*ins, S, 0.0, 1.0, 1e-2, True)
    for name, g, w in zip(qp.OUTPUTS, got, want):
        assert g.dtype == torch.float32 and g.is_contiguous(), name
        assert same_bits(g, w), name
    z_t = got[3]
    # the inputs hold what they are meant to: NaN and saturated sigmoids
    if n > 1000:
        assert bool(torch.isnan(z_t).any()) and bool(torch.isnan(got[0]).any())
        assert bool((got[0] == 0.0).any()) and bool((got[0] == 1.0).any())


@pytest.mark.parametrize("add_offsets", [True, False])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (1e-6, 1.0), (2.0, 6.0)],
                         ids=["stage2", "stage1", "near2_far6"])
def test_cpu_op_equals_the_old_chain_at_other_statics(bounds, add_offsets):
    S, (near, far) = 8, bounds
    ins = op_inputs(517, S, ROWS["nerf"], seed=3)
    got = qp.query_inputs(*ins, S, near, far, 2e-2, add_offsets, 4)
    want = old_chain(*ins, S, near, far, 2e-2, add_offsets)
    for name, g, w in zip(qp.OUTPUTS, got, want):
        assert same_bits(g, w), name


def test_differences_read_zero_on_the_chain_and_count_a_planted_fault():
    S = 8
    ins = op_inputs(301, S, ROWS["nerf"], seed=5)
    want = qp.query_inputs_chain(*ins, S, 0.0, 1.0, 1e-2, True, 4)
    view_w, dirs = ins[7], ins[6]
    clean = qp.differences(want, want, view_w, dirs, S)
    assert all(v == 0 for k, v in clean.items() if not k.endswith("_exact"))
    assert clean["vcon_t_exact"] == clean["depth0_exact"] == 1.0
    got = [t.clone() for t in want]
    r, c = torch.isfinite(got[1]).nonzero()[0].tolist()
    got[1][r, c] = torch.nextafter(got[1][r, c], torch.tensor(2.0))
    got[2][3, 4] = torch.nextafter(got[2][3, 4], torch.tensor(9.0))  # 1 ulp
    got[2][0, 0] += 1e-3  # far past the sum's bound
    got[7][9] = float("nan")
    d = qp.differences(got, want, view_w, dirs, S)
    assert d["pts24_t"] == 1 and d["vcon_t"] == 1
    assert d["vcon_t_exact"] < 1.0
    assert d["depth0"] == int(not torch.isnan(want[7][9]))


def test_view_contribution_takes_the_net_or_its_weight():
    for arch in ROWS:
        kw = dict(netarch="donerf", netdepth=4, netwidth=32) \
            if arch == "donerf" else {}
        net = init_pronerf_params(torch.Generator().manual_seed(1),
                                  mmnetdepth=2, **kw)["nerf"]
        d_pe = positional_encoding(
            torch.nn.functional.normalize(torch.randn(11, 3), dim=-1), 4)
        w = pronerf.view_weight(net, 27)
        assert tuple(w.shape) == (ROWS[arch], 27)
        assert torch.equal(pronerf.view_contribution(net, d_pe,
                                                     torch.bfloat16),
                           pronerf.view_contribution(w, d_pe,
                                                     torch.bfloat16))


@pytest.mark.parametrize("case", ["S", "octaves", "rows", "dtype",
                                  "depths", "rays"])
def test_the_launch_refuses_what_the_kernel_does_not_take(case):
    S = 8
    ins = list(op_inputs(5, S, ROWS["nerf"], special=False))
    qp._check_launch(ins[0], ins[1:7], ins[7], S, 4)
    octaves = 4
    if case == "S":
        S = qp.MAX_SAMPLES + 1
    elif case == "octaves":
        octaves = 3
    elif case == "rows":
        ins[7] = torch.randn(qp.MAX_VIEW_ROWS + 1, 27)
    elif case == "dtype":
        ins[0] = ins[0].double()
    elif case == "depths":
        ins[1] = ins[1][:, :-1]
    else:
        ins[6] = ins[6][:-1]
    with pytest.raises(ValueError):
        qp._check_launch(ins[0], ins[1:7], ins[7], S, octaves)


def _frame_setup(netarch="nerf", S=8, **over):
    sc = make_scene(n_views=5, H=10, W=12, seed=3)
    src = [0, 2, 3, 4]
    scene = prepare_scene(sc["images"][src], sc["poses"][src], sc["K"],
                          device="cpu")
    kw = dict(mmnetdepth=2, N_samples=S)
    if netarch == "donerf":
        kw |= dict(netarch="donerf", netdepth=4, netwidth=32)
    kw |= {k: v for k, v in over.items() if k == "multires_views"}
    params = init_pronerf_params(torch.Generator().manual_seed(3), **kw)
    statics = RenderStatics.infer(compute_dtype="bfloat16", use_kernels=True,
                                  netarch=netarch, N_samples=S, **over)
    return sc, scene, params, statics


def _spy(monkeypatch):
    calls = []
    real = qp.query_inputs

    def spy(*a):
        calls.append(a[8])
        return real(*a)

    monkeypatch.setattr(qp, "query_inputs", spy)
    return calls


@pytest.mark.parametrize("S", [8, 16])
@pytest.mark.parametrize("form", ["default", "int8", "raw_route", "donerf"])
def test_render_rays_with_kernels_on_the_cpu_is_unchanged(form, S,
                                                          monkeypatch):
    sc, scene, params, statics = _frame_setup(
        "donerf" if form == "donerf" else "nerf", S)
    statics = dataclasses.replace(statics, **{
        "int8": {"quant": "int8"}, "raw_route": {"clamp_raw": True}}.get(
            form, {}))
    H, W = sc["images"].shape[1:3]
    c2w = sc["poses"][1][:3, :4]
    calls = _spy(monkeypatch)
    got = make_frame_renderer(statics, H, W, sc["K"], 0, device="cpu")(
        params, scene, c2w)
    assert calls == [S]
    monkeypatch.setattr(pronerf, "_prep_on_kernel", lambda *a: False)
    want = make_frame_renderer(statics, H, W, sc["K"], 0, device="cpu")(
        params, scene, c2w)
    assert calls == [S]
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("over", [{"N_samples": 40}, {"multires_views": 2}],
                         ids=["S40", "two_octaves"])
def test_what_the_kernel_does_not_take_keeps_the_chain(over, monkeypatch):
    S = over.get("N_samples", 8)
    sc, scene, params, statics = _frame_setup(
        S=S, **{k: v for k, v in over.items() if k != "N_samples"})
    calls = _spy(monkeypatch)
    H, W = sc["images"].shape[1:3]
    out = make_frame_renderer(statics, H, W, sc["K"], 0, device="cpu")(
        params, scene, sc["poses"][1][:3, :4])
    assert calls == []
    assert bool(torch.isfinite(out["rgb1"]).all())


def _raise(*a, **kw):
    raise AssertionError("a training route reached the query-prep op")


def _training_case(stage, S=8):
    sc = make_scene(n_views=5, H=6, W=8, seed=4)
    scene = prepare_scene(sc["images"], sc["poses"], sc["K"], device="cpu")
    params = init_pronerf_params(torch.Generator().manual_seed(4),
                                 netdepth=3, netwidth=32, mmnetdepth=2,
                                 mmnetwidth=32, N_samples=S)
    statics = getattr(RenderStatics, stage)(N_samples=S)
    rays = rays_for_pose(6, 8, sc["K"], torch.as_tensor(sc["poses"][2]),
                         device="cpu")
    rays["pose_id"] = torch.full((48,), 2)
    controls = {"neighbor_subset": [0, 1, 2, 3], "n_mult": 2,
                "dir_expand": True, "dir_jitter": False,
                "rng": torch.Generator().manual_seed(4)}
    return params, rays, scene, controls, statics


@pytest.mark.parametrize("stage", ["stage1_nerf", "stage1_sampler", "stage2"])
def test_training_routes_never_call_the_op(stage, monkeypatch):
    monkeypatch.setattr(qp, "query_inputs", _raise)
    monkeypatch.setattr(qp, "query_prep_op", _raise)
    before = COUNTERS["query_prep_launches"]
    params, *rest = _training_case(stage)
    out = render_rays(params, *rest)
    out["rgb1"].sum().backward()
    assert params["nerf"].parameters().__next__().grad is not None
    assert COUNTERS["query_prep_launches"] == before


@pytest.mark.parametrize("stage,calls", [("stage1_nerf", 0),
                                         ("stage1_sampler", 1),
                                         ("stage2", 1)])
def test_the_offsets_tanh_runs_only_where_it_is_read(stage, calls,
                                                     monkeypatch):
    """The kernel-free path adds the refine net's point offsets with
    ``add_offsets`` only: the stage-1 NeRF step, which leaves them out,
    takes no tanh at all."""
    seen = []
    real = torch.tanh
    monkeypatch.setattr(torch, "tanh",
                        lambda x: seen.append(tuple(x.shape)) or real(x))
    params, rays, scene, controls, statics = _training_case(stage)
    render_rays(params, rays, scene, controls, statics)
    assert len(seen) == calls
