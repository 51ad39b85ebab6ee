"""Process groups of the port: what a JAX device mesh is to the JAX package.

- ``init_group``: the default ``torch.distributed`` process group, over
  NCCL for CUDA tensors and gloo for CPU tensors. The backend follows the
  device, never a fallback: a CUDA run where NCCL cannot start raises.
  Every group gets a timeout, so a rendezvous that hangs fails. Without an
  ``init_method`` it is a world of one (its store in this process), as on
  a machine with one card, where the collectives still run through NCCL;
- ``world``: ``(rank, world size)`` of the default group, ``(0, 1)``
  without one: every entry point then behaves as a world of one;
- ``spawn``: start ranks as processes of their own (``spawn`` start
  method: each imports only what its target needs), join each by a
  deadline, and raise if one failed or outlived it.

Nothing here reads an environment variable or a cluster's layout: the
caller gives the address, the world size and the rank.
"""

from __future__ import annotations

import multiprocessing
import time
from datetime import timedelta

import torch
import torch.distributed as dist

GROUP_TIMEOUT_S = 60


def backend_for(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_group(device, world_size: int = 1, rank: int = 0,
               init_method: str | None = None,
               timeout_s: float = GROUP_TIMEOUT_S):
    """Initialise the default process group for ``device``'s backend.
    ``init_method`` is a ``file://`` or ``tcp://`` address; without one,
    ``world_size`` must be 1. Returns the backend's name."""
    device = torch.device(device)
    rendezvous = {"init_method": init_method}
    if init_method is None:
        if world_size != 1:
            raise ValueError("a world of more than one needs an init_method")
        rendezvous = {"store": dist.HashStore()}  # in this process
    backend = backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(device.index if device.index is not None
                              else rank)
    dist.init_process_group(
        backend, world_size=world_size, rank=rank,
        timeout=timedelta(seconds=timeout_s), **rendezvous)
    return backend


def close_group():
    """Destroy the default process group, if there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def world() -> tuple[int, int]:
    """``(rank, world size)`` of the default group; ``(0, 1)`` without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _rank_main(target, rank, world_size, init_method, args):
    target(rank, world_size, init_method, *args)


def spawn(target, world_size: int, init_method: str, args=(),
          deadline_s: float = 120.0):
    """Run ``target(rank, world_size, init_method, *args)`` in
    ``world_size`` spawned processes. ``target`` must be importable by
    name from a module that the children can import (it and ``args`` are
    pickled). Each process is joined by ``deadline_s`` seconds from the
    start; one still alive then is terminated, and a ``TimeoutError``
    raised; a non-zero exit raises ``RuntimeError``."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world_size, init_method, args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
        for p in alive:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
    if alive:
        raise TimeoutError(f"{len(alive)} of {world_size} ranks outlived "
                           f"the {deadline_s} s deadline")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks exited with codes {codes}")
