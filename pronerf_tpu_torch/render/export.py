"""The exported frame renderer: the counterpart of
``pronerf_tpu/render/export.py`` (``jax.export`` of the whole frame, the
stand-in for the reference's ONNX -> TensorRT engines).

The whole frame pipeline (sampler -> warp -> refine -> NeRF -> compositing,
over its ray tiles) is traced once with ``torch.export`` and saved as a
``.pt2`` program, beside the params and the prepared reference-view scene in
the port's checkpoint form and a JSON manifest with the JAX package's keys
(the resolved ``RenderStatics`` included, so a non-default model rebuilds
exactly). Serving loads the program and runs it eagerly.

The four CUDA kernels are ``torch.library`` ops (``pronerf::fused_minmax``,
``pronerf::fused_nerf_raw``, ``pronerf::fused_nerf_composite``,
``pronerf::fused_nerf_raw_q``), so the traced program names them; on the
card they launch the kernels (and count the launches), on the CPU they run
the plain versions. The program's inputs are tensors only: the nets'
parameters (bound to the nets with ``torch.func.functional_call`` inside the
traced body, so no weight is stored in the program), the kernel panels and
blobs, which ``call`` packs outside the program once per parameter set, the
scene and the pose. Tensors the frame makes on a device are fixed in the
program at export, so a program runs on the device type it was traced on
(``platforms`` in the manifest); loading it for another raises.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

# the kernel modules register the ops a saved program names
from pronerf_tpu_torch.kernels import fused_minmax  # noqa: F401
from pronerf_tpu_torch.kernels import fused_nerf  # noqa: F401
from pronerf_tpu_torch.kernels import fused_nerf_q  # noqa: F401
from pronerf_tpu_torch.kernels.packing import pack_serving_params
from pronerf_tpu_torch.models.pronerf import RenderStatics, init_pronerf_params
from pronerf_tpu_torch.render.renderer import (
    make_frame_renderer,
    resolve_gather_statics,
)
from pronerf_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from pronerf_tpu_torch.utils.tensors import as_f32, resolve_device

NETS = ("nerf", "sampler", "refine")


def expected_artifact_paths(export_dir) -> dict:
    """The files an export writes."""
    export_dir = Path(export_dir)
    return {
        "executable": export_dir / "render_frame.pt2",
        "params": export_dir / "params.ckpt",
        "manifest": export_dir / "manifest.json",
    }


def _statics_to_json(statics: RenderStatics) -> dict:
    d = dataclasses.asdict(statics)
    for k, v in d.items():
        if isinstance(v, tuple):
            d[k] = list(v)
    return d


def statics_from_manifest(manifest: dict) -> RenderStatics:
    """Rebuild the exported program's RenderStatics from its manifest."""
    d = dict(manifest["statics"])
    for k in ("netskips", "mmnetskips"):
        d[k] = tuple(d[k])
    return RenderStatics(**d)


def _program_inputs(packed) -> dict:
    """The packed params as the program takes them: each net's parameters
    and buffers by name, then the kernel panels (and blobs), tensors only,
    in one fixed order."""
    out = {net: {k: v.detach() for k, v in packed[net].state_dict().items()}
           for net in NETS}
    for key in sorted(k for k in packed if k not in NETS):
        out[key] = packed[key]
    return out


class _Nets(torch.nn.Module):
    """The three nets around the frame body, so that ``functional_call``
    can bind their parameters to the program's inputs."""

    def __init__(self, params, frame):
        super().__init__()
        self.nets = torch.nn.ModuleDict({k: params[k] for k in NETS})
        self.frame = frame

    def forward(self, packed, scene, c2w):
        return self.frame(dict(packed, **self.nets), scene, c2w)


class _Program(torch.nn.Module):
    """``(inputs, scene, c2w) -> frame``: the module ``torch.export``
    traces. The nets are held outside the module's own state (not
    registered), so the program stores no weight: every parameter arrives
    in ``inputs``."""

    def __init__(self, params, frame):
        super().__init__()
        object.__setattr__(self, "_nets", _Nets(params, frame))

    def forward(self, inputs, scene, c2w):
        state = {f"nets.{net}.{k}": v for net in NETS
                 for k, v in inputs[net].items()}
        rest = {k: v for k, v in inputs.items() if k not in NETS}
        return torch.func.functional_call(self._nets, state,
                                          (rest, scene, c2w))


def export_renderer(params, scene, export_dir, H: int, W: int, K,
                    tile_rays: int = 8192, statics: RenderStatics | None = None,
                    compute_dtype=None, unroll: bool = False, arch=None,
                    device="cuda"):
    """Trace + save the frame renderer for (H, W) on ``device``; bundle the
    params (``arch``: the nets' init arguments, to rebuild them) and the
    scene. ``statics`` as the model serves (default: inference statics of
    ``compute_dtype``); ``gather_tiles = -1`` and ``tile_rays = 0`` are
    resolved first, as ``make_frame_renderer`` resolves them, so the
    manifest records the program's exact statics. ``unroll`` is recorded
    for the JAX manifest's keys (the port's tile loop is always traced out).
    Returns the artifact paths."""
    device = resolve_device(device)
    if statics is None:
        statics = RenderStatics.infer(compute_dtype=compute_dtype)
    resolved_tile = H * W if (not tile_rays or tile_rays >= H * W) \
        else tile_rays
    statics = resolve_gather_statics(statics, H, W, resolved_tile)
    renderer = make_frame_renderer(statics, H, W, K, tile_rays, device)
    packed = pack_serving_params(params, statics)
    c2w = torch.eye(3, 4, dtype=torch.float32, device=device)
    with torch.no_grad():
        program = torch.export.export(
            _Program(params, renderer.frame),
            (_program_inputs(packed), scene, c2w), strict=False)

    # the example inputs would be saved in the program (the scene and the
    # packed params, again): params.ckpt holds them once
    program.example_inputs = None
    paths = expected_artifact_paths(export_dir)
    Path(export_dir).mkdir(parents=True, exist_ok=True)
    torch.export.save(program, paths["executable"])
    save_checkpoint(paths["params"], {
        "params": {net: params[net].state_dict() for net in NETS},
        "arch": arch or {},
        "scene": {k: v.cpu() if torch.is_tensor(v) else v
                  for k, v in scene.items()},
    })
    paths["manifest"].write_text(json.dumps({
        "H": H,
        "W": W,
        "K": np.asarray(K).tolist(),
        "tile_rays": tile_rays,
        "unroll": unroll,
        "compute_dtype": statics.compute_dtype or "float32",
        "statics": _statics_to_json(statics),
        "platforms": [device.type],
    }, indent=2))
    return paths


def load_exported_renderer(export_dir, device="cuda"):
    """Load an exported renderer onto ``device`` (the card by default).

    Returns ``(call, params, scene, manifest)``; ``call(params, scene,
    c2w)`` runs the program on the bundled (or other) params of the same
    nets, the scene and a [3, 4] pose, under ``torch.no_grad()``, packing
    the params once per parameter set outside the program. ``export_dir``
    is the directory or any artifact path in it. A program traced on
    another device type raises."""
    device = resolve_device(device)
    export_dir = Path(export_dir)
    if export_dir.suffix in {".pt2", ".ckpt", ".json"} or export_dir.is_file():
        export_dir = export_dir.parent
    paths = expected_artifact_paths(export_dir)
    manifest = json.loads(paths["manifest"].read_text())
    if manifest["platforms"] != [device.type]:
        raise ValueError(
            f"{paths['executable']} was exported for {manifest['platforms']}"
            f" and cannot run on {device.type}: export it there")
    statics = statics_from_manifest(manifest)
    bundle = load_checkpoint(paths["params"])
    arch = dict(netarch=statics.netarch, N_samples=statics.N_samples,
                N_point_ray_enc=statics.N_point_ray_enc,
                num_neighbor=statics.num_neighbor, multires=statics.multires,
                multires_views=statics.multires_views)
    arch.update(bundle.get("arch") or {})
    params = init_pronerf_params(torch.Generator().manual_seed(0),
                                 device=device, **arch)
    with torch.no_grad():
        for net in NETS:
            params[net].load_state_dict(bundle["params"][net])
    scene = {k: v.to(device) if torch.is_tensor(v) else v
             for k, v in bundle["scene"].items()}
    program = torch.export.load(paths["executable"]).module()
    packed_for = {}

    @torch.no_grad()
    def call(params, scene, c2w):
        if packed_for.get("source") is not params:
            packed_for["source"] = params
            packed_for["inputs"] = _program_inputs(
                pack_serving_params(params, statics))
        return program(packed_for["inputs"], scene, as_f32(c2w, device))

    return call, params, scene, manifest
