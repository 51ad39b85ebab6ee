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
  method: each imports only what its target needs), join them (by a
  deadline, if given), and raise if one failed or outlived it; the others
  are stopped as soon as one fails;
- ``local_ranks``: the ranks a run takes on this machine by default (one
  a visible card; one process on the CPU), the port's form of "all local
  devices";
- ``spawn_local``: ``spawn`` with a ``file://`` rendezvous in a temporary
  directory and no deadline, for a command-line run of several ranks.

Nothing here reads an environment variable or a cluster's layout: the
caller gives the address, the world size and the rank.
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import tempfile
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
          deadline_s: float | None = 120.0):
    """Run ``target(rank, world_size, init_method, *args)`` in
    ``world_size`` spawned processes. ``target`` must be importable by
    name from a module that the children can import (it and ``args`` are
    pickled). The ranks are joined by ``deadline_s`` seconds from the
    start (``None``: no deadline); ranks still alive then are terminated,
    and a ``TimeoutError`` raised. A rank that exits non-zero stops the
    others at once (a peer would otherwise wait in a collective until the
    group's timeout) and raises ``RuntimeError``."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world_size, init_method, args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    end = None if deadline_s is None else time.monotonic() + deadline_s
    try:
        running = list(procs)
        while running:
            left = None if end is None else max(0.0, end - time.monotonic())
            ready = multiprocessing.connection.wait(
                [p.sentinel for p in running], left)
            if not ready:
                break  # the deadline passed
            for p in [p for p in running if p.sentinel in ready]:
                p.join()
                running.remove(p)
            if any(p.exitcode for p in procs if p not in running):
                break
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
        for p in alive:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
    codes = [p.exitcode for p in procs]
    failed = [c for c, p in zip(codes, procs) if p not in alive and c]
    if failed:
        raise RuntimeError(f"ranks exited with codes {codes}")
    if alive:
        raise TimeoutError(f"{len(alive)} of {world_size} ranks outlived "
                           f"the {deadline_s} s deadline")


def local_ranks(device) -> int:
    """The ranks a run on ``device`` takes by default: one a visible card
    for CUDA, one process on the CPU."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def spawn_local(target, world_size: int, args=()):
    """``spawn`` on this machine with a ``file://`` rendezvous in a
    temporary directory (removed after) and no join deadline: a run lasts
    as long as it trains, and a hung collective fails by the group's
    timeout (``GROUP_TIMEOUT_S``)."""
    with tempfile.TemporaryDirectory(prefix="pronerf_ranks_") as tmp:
        spawn(target, world_size, f"file://{tmp}/rendezvous", args,
              deadline_s=None)
