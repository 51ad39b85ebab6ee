"""Checkpoints in the port's own format: ``torch.save`` of a dict under the
reference's logical key names, every tensor on the CPU.

- stage 1 saves {global_step, network_fn, mmr_network_fn, refine_net,
  optimizer, s_optimizer} to ``basedir/expname/%06d.ckpt``;
- stage 2 saves {global_step, network_fn (an untrained copy, for the
  layout), network_fine (the trained NeRF), mmr_network_fn, refine_net,
  optimizer_state_dict, optimizer_nerf};
- a net is its module's ``state_dict`` (``nn.Linear`` weights [out, in]); an
  optimizer is {count, mu, nu} with the moments keyed by parameter name;
  ``global_step`` is a Python int;
- the write is atomic (a temporary file, then ``os.replace``); the read is
  ``torch.load(..., weights_only=True)``.

The JAX package writes flax msgpack instead. Those files are told apart by
their first bytes (``torch.save`` writes a zip archive) and refused with an
error that names the reader still to come (ROADMAP A.11), so a JAX
checkpoint is never misread.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

CKPT_SUFFIX = ".ckpt"
FORMAT = "pronerf_tpu_torch/1"
_ZIP_MAGIC = b"PK\x03\x04"


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().to("cpu")
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def save_checkpoint(path, ckpt: dict) -> str:
    """Write ``ckpt`` (a dict of ints, tensors and dicts of them) to
    ``path``, atomically."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(dict(_to_cpu(ckpt), format=FORMAT), tmp)
    os.replace(tmp, path)
    return str(path)


def load_checkpoint(path, device="cpu") -> dict:
    """Read a checkpoint written by :func:`save_checkpoint`, tensors on
    ``device``. A JAX msgpack checkpoint raises ``NotImplementedError``."""
    path = Path(path)
    with open(path, "rb") as fh:
        head = fh.read(4)
    if head != _ZIP_MAGIC:
        raise NotImplementedError(
            f"{path} is not a checkpoint of pronerf_tpu_torch (no torch.save "
            "archive): a checkpoint of the JAX package (flax msgpack) needs "
            "the msgpack reader, ROADMAP A.11; until then weights cross "
            "through convert.params_from_numpy")
    ckpt = torch.load(path, map_location=device, weights_only=True)
    if ckpt.get("format") != FORMAT:
        raise ValueError(f"{path}: unknown checkpoint format "
                         f"{ckpt.get('format')!r}")
    return ckpt


def latest_checkpoint(expdir) -> str | None:
    """Newest checkpoint in an experiment dir (auto-resume semantics)."""
    expdir = Path(expdir)
    if not expdir.is_dir():
        return None
    ckpts = sorted(f for f in os.listdir(expdir) if f.endswith(CKPT_SUFFIX))
    return str(expdir / ckpts[-1]) if ckpts else None


def checkpoint_path(expdir, step: int) -> str:
    return str(Path(expdir) / f"{step:06d}{CKPT_SUFFIX}")
