"""Checkpoint inspection tool: ``python -m pronerf_tpu_torch.tools.ckpt
show X`` / ``diff A B``.

Counterpart of ``pronerf_tpu/tools/ckpt.py``, over a checkpoint of either
package (``train/checkpoint.load_checkpoint`` reads both into the port's
form): summarize nets and optimizer state, or diff two snapshots (max
|delta| per entry; a JAX and a port checkpoint of the same state diff to 0).
"""

from __future__ import annotations

import argparse

import numpy as np

from pronerf_tpu_torch.train.checkpoint import load_checkpoint


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, np.asarray(tree)


def show(path: str, verbose: bool = False):
    ckpt = load_checkpoint(path)
    print(f"checkpoint: {path} ({ckpt['format']})")
    if "global_step" in ckpt:
        print(f"global_step: {int(np.asarray(ckpt['global_step']))}")
    for key, sub in ckpt.items():
        if key in ("global_step", "format"):
            continue
        leaves = list(_leaves(sub))
        n_params = sum(a.size for _, a in leaves)
        print(f"  {key:22s} {len(leaves):4d} arrays  {n_params:>10,d} params")
        if verbose:
            for name, a in leaves:
                print(f"    {name:50s} {str(a.shape):18s} {a.dtype}")


def diff(path_a: str, path_b: str):
    a = load_checkpoint(path_a)
    b = load_checkpoint(path_b)
    keys = sorted((set(a) | set(b)) - {"format"})
    for key in keys:
        if key == "global_step":
            sa = int(np.asarray(a.get(key, -1)))
            sb = int(np.asarray(b.get(key, -1)))
            print(f"global_step: {sa} -> {sb}")
            continue
        if key not in a or key not in b:
            print(f"  {key:22s} only in {'A' if key in a else 'B'}")
            continue
        la = dict(_leaves(a[key]))
        lb = dict(_leaves(b[key]))
        deltas = [
            float(np.max(np.abs(la[n].astype(np.float64) - lb[n])))
            for n in la
            if n in lb and la[n].shape == lb[n].shape
        ]
        print(
            f"  {key:22s} max|delta| = {max(deltas) if deltas else float('nan'):.3e}"
        )


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m pronerf_tpu_torch.tools.ckpt")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("show")
    ps.add_argument("path")
    ps.add_argument("-v", "--verbose", action="store_true")
    pd = sub.add_parser("diff")
    pd.add_argument("path_a")
    pd.add_argument("path_b")
    args = p.parse_args(argv)
    if args.cmd == "show":
        show(args.path, args.verbose)
    else:
        diff(args.path_a, args.path_b)


if __name__ == "__main__":
    main()
