"""Checkpoints: the port's own format, and a reader of the JAX package's.

The port writes ``torch.save`` of a dict under the reference's logical key
names, every tensor on the CPU:

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

The JAX package writes flax msgpack of the same keys (``pronerf_tpu/train/
checkpoint.py``): its pytrees, ``w`` stored [in, out], lists as ``{'0': ...}``
maps, optax's ``ScaleByAdamState`` (inside a ``chain`` when weight decay is
on) with the moments as pytrees of the params. :func:`load_checkpoint` tells
the two apart by their first bytes (``torch.save`` writes a zip archive,
flax a msgpack map) and returns a JAX checkpoint in the port's form: the nets
through ``convert`` (each ``w`` transposed), the moments under the port's
parameter names, every value bit for bit. The msgpack decoder is written
here (:func:`msgpack_restore`); no ``msgpack`` package is needed.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path

import numpy as np
import torch

CKPT_SUFFIX = ".ckpt"
FORMAT = "pronerf_tpu_torch/1"
JAX_FORMAT = "pronerf_tpu/flax-msgpack"
_ZIP_MAGIC = b"PK\x03\x04"


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().to("cpu")
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def _to_device(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
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
    """A checkpoint of either package, in the port's form (see the module
    docstring), tensors on ``device``. ``format`` says which file it was:
    :data:`FORMAT` or :data:`JAX_FORMAT`."""
    path = Path(path)
    data = path.read_bytes()
    if data[:4] == _ZIP_MAGIC:
        ckpt = torch.load(path, map_location=device, weights_only=True)
        if ckpt.get("format") != FORMAT:
            raise ValueError(f"{path}: unknown checkpoint format "
                             f"{ckpt.get('format')!r}")
        return ckpt
    if data[:1] and (0x80 <= data[0] <= 0x8F or data[0] in (0xDE, 0xDF)):
        ckpt = from_jax_state(relistify(msgpack_restore(data)), path)
        return _to_device(ckpt, device)
    raise ValueError(f"{path}: neither a torch.save archive nor a flax "
                     "msgpack map")


def latest_checkpoint(expdir) -> str | None:
    """Newest checkpoint in an experiment dir (auto-resume semantics)."""
    expdir = Path(expdir)
    if not expdir.is_dir():
        return None
    ckpts = sorted(f for f in os.listdir(expdir) if f.endswith(CKPT_SUFFIX))
    return str(expdir / ckpts[-1]) if ckpts else None


def checkpoint_path(expdir, step: int) -> str:
    return str(Path(expdir) / f"{step:06d}{CKPT_SUFFIX}")


# ------------------------------------------------ flax msgpack, decoded --

# fixed-width headers: first byte -> (struct format of the header, kind)
_HEADS = {
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xC7: (">Bb", "ext"), 0xC8: (">Hb", "ext"), 0xC9: (">Ib", "ext"),
    0xCA: (">f", "value"), 0xCB: (">d", "value"),
    0xCC: (">B", "value"), 0xCD: (">H", "value"), 0xCE: (">I", "value"),
    0xCF: (">Q", "value"), 0xD0: (">b", "value"), 0xD1: (">h", "value"),
    0xD2: (">i", "value"), 0xD3: (">q", "value"),
    0xD4: (">b", "fixext1"), 0xD5: (">b", "fixext2"), 0xD6: (">b", "fixext4"),
    0xD7: (">b", "fixext8"), 0xD8: (">b", "fixext16"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
}
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _decode(buf: bytes, pos: int):
    """(object, next position) of the msgpack object at ``pos``."""
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _decode_map(buf, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _decode_array(buf, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return buf[pos:pos + n].decode("utf-8"), pos + n
    if b in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[b], pos
    if b not in _HEADS:
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at {pos - 1}")
    fmt, kind = _HEADS[b]
    head = struct.unpack_from(fmt, buf, pos)
    pos += struct.calcsize(fmt)
    if kind == "value":
        return head[0], pos
    if kind == "map":
        return _decode_map(buf, pos, head[0])
    if kind == "array":
        return _decode_array(buf, pos, head[0])
    if kind.startswith("fixext"):
        n, code = int(kind[6:]), head[0]
    elif kind == "ext":
        n, code = head
    else:
        n = head[0]
    body = buf[pos:pos + n]
    if len(body) != n:
        raise ValueError("msgpack: truncated data")
    pos += n
    if kind == "str":
        return body.decode("utf-8"), pos
    if kind == "bin":
        return bytes(body), pos
    return _decode_ext(code, body), pos


def _decode_map(buf, pos, n):
    out = {}
    for _ in range(n):
        k, pos = _decode(buf, pos)
        out[k], pos = _decode(buf, pos)
    return out, pos


def _decode_array(buf, pos, n):
    out = []
    for _ in range(n):
        v, pos = _decode(buf, pos)
        out.append(v)
    return out, pos


def _decode_ext(code: int, body: bytes):
    """flax's ext types: 1 an ndarray, 3 a numpy scalar, each packed as the
    msgpack triple (shape, dtype name, C-order bytes)."""
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"msgpack: ext type {code} is not one flax writes "
                         "for a checkpoint (1 ndarray, 3 numpy scalar)")
    (shape, name, data), _ = _decode(body, 0)
    name = name.decode() if isinstance(name, bytes) else name
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"msgpack: array dtype {name!r} has no numpy "
                         "dtype") from None
    arr = np.frombuffer(data, dtype=dtype).reshape(shape).copy()
    return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(tree):
    """flax's form of an array over its chunk size: {'__msgpack_chunked_
    array__': True, 'shape': {'0': ...}, 'chunks': {'0': flat, ...}}."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """The pytree of dicts, lists, scalars and numpy arrays that flax's
    ``serialization.msgpack_serialize`` wrote to ``data``."""
    tree, end = _decode(data, 0)
    if end != len(data):
        raise ValueError(f"msgpack: {len(data) - end} bytes after the object")
    return _unchunk(tree)


def relistify(tree):
    """Undo flax ``to_state_dict``'s list -> {'0': ...} conversion."""
    if isinstance(tree, dict):
        out = {k: relistify(v) for k, v in tree.items()}
        if out and all(isinstance(k, str) and k.isdigit() for k in out):
            idx = sorted(out, key=int)
            if [int(k) for k in idx] == list(range(len(idx))):
                return [out[k] for k in idx]
        return out
    return tree


# ------------------------------------- the JAX layout in the port's form --

_NERF_KEYS = ("network_fn", "network_fine")
_MINMAX_KEYS = ("mmr_network_fn", "refine_net")
_OPT_KEYS = ("optimizer", "s_optimizer", "optimizer_state_dict",
             "optimizer_nerf")


def _adam_state(tree):
    """The ScaleByAdamState of an optax state: itself, or the one non-empty
    element of a ``chain`` (weight decay keeps no state)."""
    if isinstance(tree, dict) and {"count", "mu", "nu"} <= set(tree):
        return tree
    if isinstance(tree, list):
        found = [t for t in tree if t]
        if len(found) == 1:
            return _adam_state(found[0])
    raise ValueError("no Adam state (count, mu, nu)")


def _named_moments(tree) -> dict:
    """A moment pytree (of all three nets, or of the NeRF alone) as
    {'<net>.<parameter name>': tensor}, the port's optimizer keys."""
    from pronerf_tpu_torch.convert import (
        params_from_numpy,
        radiance_from_numpy,
    )
    from pronerf_tpu_torch.train.state import named_params

    if isinstance(tree, dict) and set(tree) == {"nerf", "sampler", "refine"}:
        nets = params_from_numpy(tree)
    else:
        nets = {"nerf": radiance_from_numpy(tree)}
    return {k: v.detach() for k, v in named_params(nets).items()}


def from_jax_state(tree: dict, path="") -> dict:
    """A JAX checkpoint's pytree (numpy leaves, lists restored) in the
    port's checkpoint form. A key or a layout it cannot map raises
    ``ValueError`` naming the key."""
    from pronerf_tpu_torch.convert import (
        minmax_from_numpy,
        radiance_from_numpy,
    )

    out = {"format": JAX_FORMAT}
    for key, value in tree.items():
        try:
            if key == "global_step":
                out[key] = int(value)
            elif key in _NERF_KEYS:
                out[key] = _net_state(radiance_from_numpy(value))
            elif key in _MINMAX_KEYS:
                out[key] = _net_state(minmax_from_numpy(value))
            elif key in _OPT_KEYS:
                adam = _adam_state(value)
                out[key] = {"count": int(adam["count"]),
                            "mu": _named_moments(adam["mu"]),
                            "nu": _named_moments(adam["nu"])}
            else:
                raise ValueError("not a key of the JAX trainer's checkpoints")
        except (KeyError, IndexError, TypeError, ValueError) as e:
            raise ValueError(f"{path}: JAX checkpoint key {key!r}: the port "
                             f"cannot map its layout ({type(e).__name__}: "
                             f"{e})") from e
    return out


def _net_state(module) -> dict:
    return {k: v.detach() for k, v in module.state_dict().items()}
