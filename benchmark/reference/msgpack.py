"""A frozen reader of flax's msgpack checkpoints (the JAX trainer's
``*.ckpt``): the pytree of dicts, lists, scalars and numpy arrays it holds.

It follows the msgpack specification and flax's two ext types (1 an
ndarray, 3 a numpy scalar, each the triple (shape, dtype name, C-order
bytes)); lists stored as ``{'0': ...}`` maps are made lists again. It
imports nothing of the program: the benchmark reads the weights with it and
hands the same arrays to the program and to the reference.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

# first byte -> (struct format of the fixed-width header, kind)
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


def _decode(buf: bytes, pos: int):
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _items(buf, pos, b & 0x0F, True)
    if 0x90 <= b <= 0x9F:
        return _items(buf, pos, b & 0x0F, False)
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
    if kind in ("map", "array"):
        return _items(buf, pos, head[0], kind == "map")
    if kind.startswith("fixext"):
        n, code = int(kind[6:]), head[0]
    elif kind == "ext":
        n, code = head
    else:
        n, code = head[0], None
    body = buf[pos:pos + n]
    if len(body) != n:
        raise ValueError("msgpack: truncated data")
    pos += n
    if kind == "str":
        return body.decode("utf-8"), pos
    if kind == "bin":
        return bytes(body), pos
    return _ext(code, body), pos


def _items(buf, pos, n, is_map):
    if is_map:
        out = {}
        for _ in range(n):
            k, pos = _decode(buf, pos)
            out[k], pos = _decode(buf, pos)
        return out, pos
    out = []
    for _ in range(n):
        v, pos = _decode(buf, pos)
        out.append(v)
    return out, pos


def _ext(code, body):
    if code not in (1, 3):
        raise ValueError(f"msgpack: ext type {code} is not one flax writes")
    (shape, name, data), _ = _decode(body, 0)
    name = name.decode() if isinstance(name, bytes) else name
    arr = np.frombuffer(data, dtype=np.dtype(name)).reshape(shape).copy()
    return arr[()] if code == 3 else arr


def _restore(tree):
    """flax's chunked arrays joined, ``{'0': ...}`` maps made lists."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    out = {k: _restore(v) for k, v in tree.items()}
    if out and all(isinstance(k, str) and k.isdigit() for k in out):
        idx = sorted(out, key=int)
        if [int(k) for k in idx] == list(range(len(idx))):
            return [out[k] for k in idx]
    return out


def read_checkpoint(path) -> dict:
    """The pytree a flax msgpack checkpoint file holds."""
    data = Path(path).read_bytes()
    tree, end = _decode(data, 0)
    if end != len(data):
        raise ValueError(f"{path}: {len(data) - end} bytes after the object")
    return _restore(tree)


def adam_state(tree):
    """The (count, mu, nu) of an optax state: itself, or the one non-empty
    element of a ``chain`` (weight decay keeps no state)."""
    if isinstance(tree, dict) and {"count", "mu", "nu"} <= set(tree):
        return tree
    if isinstance(tree, list):
        found = [t for t in tree if t]
        if len(found) == 1:
            return adam_state(found[0])
    raise ValueError("no Adam state (count, mu, nu)")
