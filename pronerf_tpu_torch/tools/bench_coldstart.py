"""Serving start-to-first-frame wall time on the card at the fern serving
config, by phase: ``python -m pronerf_tpu_torch.tools.bench_coldstart
[--no-cache] [--res HxW]``.

The twin of the JAX package's ``scripts/bench_coldstart.py``. The reference
deserializes TRT engines in seconds (``trt_infer_v2.py:149-165``); the JAX
package reads its XLA cache (``PRONERF_XLA_CACHE``); the port's counterpart
is the build directory of its CUDA kernels (``kernels/build.py``: a warm
directory holds the built libraries, which load by ``dlopen``; a cold one
makes ``nvcc`` build every source). The serving frame is ``bench.py``'s:
504x378, bf16, whole frame in one tile, the fused kernels. Phases, each the
wall time since the last (the first since the process started, read from
``/proc/self/stat``):

  imports           : the interpreter, torch and the port's modules
  cuda_init         : the first CUDA context (JAX's ``backend``)
  host_build        : synthetic scene (u8-packed), params and pose on the host
  device_put        : scene, params and pose to the card, synchronised
  kernel_load       : ``kernels/build.py:load`` of every source, and the
                      renderer made (JAX's ``trace`` + ``compile``): an
                      ``nvcc`` build on a cold cache, a ``dlopen`` on a warm
                      one
  touch_inputs      : one trivial kernel reading every input, and a readback
  first_frame       : the first frame (its params packed for the kernels)
                      and its readback
  steady            : one more frame and its readback (on the card the
                      renderer's second call: its CUDA graph of the
                      frame warmed up, captured and replayed)
  reload_first_frame: a second renderer in the same process, its first frame

JAX's ``reload_compile`` has no counterpart (``PHASES_ABSENT`` says why).
``--no-cache`` builds into a fresh temporary directory (through
``PRONERF_KERNEL_CACHE``), removed after its size is read. ``--device cpu``
runs the frames' plain versions, for the tests; it has no CUDA context and
no kernels, so those phases are absent there.
"""

from __future__ import annotations

import os
import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.time() - _process_age_s()

PHASES = ("imports", "cuda_init", "host_build", "device_put", "kernel_load",
          "touch_inputs", "first_frame", "steady", "reload_first_frame")
# the JAX script's phases, by the name of their counterpart here
JAX_PHASES = {"imports": "imports", "backend": "cuda_init",
              "host_build": "host_build", "device_put": "device_put",
              "trace": "kernel_load", "compile": "kernel_load",
              "touch_inputs": "touch_inputs", "first_frame": "first_frame",
              "steady": "steady", "reload_compile": None,
              "reload_first_frame": "reload_first_frame"}
PHASES_ABSENT = {
    "reload_compile": "no counterpart: the kernels are shared libraries "
    "loaded once a process (kernel_load); a second renderer loads nothing "
    "and only packs its params, which reload_first_frame holds",
}
CPU_ABSENT = {
    "cuda_init": "on the CPU: no CUDA context",
    "kernel_load": "on the CPU: the plain versions run, no kernel is loaded",
}


def _dir_bytes(path) -> int:
    from pathlib import Path

    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m pronerf_tpu_torch.tools.bench_coldstart",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-cache", action="store_true", dest="no_cache",
                    help="build the kernels into a fresh temporary directory")
    ap.add_argument("--res", default="378x504",
                    help="HxW of the frame (as the JAX script takes it)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default: the CUDA card; raises "
                         "without one)")
    args = ap.parse_args(argv)
    H, W = (int(v) for v in args.res.split("x"))
    on_card = args.device == "cuda"
    phases = {}
    t_prev = T_START

    def mark(name):
        nonlocal t_prev
        now = time.time()
        phases[name] = round(now - t_prev, 2)
        t_prev = now

    import json
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pronerf_tpu_torch import bench
    from pronerf_tpu_torch.kernels import build
    from pronerf_tpu_torch.models.pronerf import init_pronerf_params
    from pronerf_tpu_torch.render.raygen import prepare_scene
    from pronerf_tpu_torch.render.renderer import make_frame_renderer
    from pronerf_tpu_torch.utils.profiling import readback
    from pronerf_tpu_torch.utils.synthetic import make_scene
    from pronerf_tpu_torch.utils.tensors import resolve_device

    mark("imports")

    device = resolve_device(args.device)
    if on_card:
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
        mark("cuda_init")

    cfg, statics = bench.bench_config()
    sc = make_scene(n_views=17, H=H, W=W, focal=0.8 * W, seed=0)
    scene_host = prepare_scene(sc["images"], sc["poses"], sc["K"],
                               device="cpu")
    params_host = init_pronerf_params(torch.Generator().manual_seed(0))
    c2w_host = torch.from_numpy(np.asarray(sc["poses"][0], np.float32))
    mark("host_build")

    scene = {k: v.to(device) if torch.is_tensor(v) else v
             for k, v in scene_host.items()}
    params = {k: v.to(device) for k, v in params_host.items()}
    c2w = c2w_host.to(device)
    readback(c2w)
    mark("device_put")

    cache_dir = None
    if on_card:
        if args.no_cache:
            os.environ[build.CACHE_ENV] = tempfile.mkdtemp(
                prefix="pronerf_kernels_")
        cache_dir = build.build_dir()
        for name in build.sources():
            build.load(name)
    renderer = make_frame_renderer(statics, H, W, sc["K"],
                                   tile_rays=cfg.tile_rays, device=device)
    if on_card:
        mark("kernel_load")

    inputs = [v for v in scene.values() if torch.is_tensor(v)] + [
        p for net in params.values() for p in net.parameters()] + [c2w]
    with torch.no_grad():
        readback(sum(x.reshape(-1)[0].float() for x in inputs))
    mark("touch_inputs")

    out = renderer(params, scene, c2w)
    readback(out["rgb1"])
    if not torch.isfinite(out["rgb1"]).all():
        raise SystemExit("bench_coldstart: the first frame is not finite")
    mark("first_frame")

    readback(renderer(params, scene, c2w + 1e-7)["rgb1"])
    mark("steady")

    again = make_frame_renderer(statics, H, W, sc["K"],
                                tile_rays=cfg.tile_rays, device=device)
    readback(again(params, scene, c2w + 2e-7)["rgb1"])
    mark("reload_first_frame")

    total = time.time() - T_START
    cache_bytes = _dir_bytes(cache_dir) if cache_dir else None
    if on_card and args.no_cache:
        shutil.rmtree(cache_dir, ignore_errors=True)
    result = {
        "res": f"{W}x{H}",
        "total_s": round(total, 1),
        "phases_s": phases,
        "phases_absent": PHASES_ABSENT | ({} if on_card else CPU_ABSENT),
        "cache": str(cache_dir) if cache_dir else None,
        "cache_mb": round(cache_bytes / 1e6, 1) if cache_bytes else None,
        "cold": bool(on_card and args.no_cache),
        "device_kind": bench.card_name(device),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
