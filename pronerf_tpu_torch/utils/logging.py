"""Observability: structured training metrics and image logging.

Every experiment gets a ``metrics.jsonl`` stream (one JSON object per event)
beside the stdout prints, and ``i_img`` drops a held-out render PNG under
``imgs/`` (through the port's own PNG writer). Counterpart of
``pronerf_tpu/utils/logging.py``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np


class MetricsLogger:
    def __init__(self, expdir):
        self.path = Path(expdir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, **scalars):
        rec = {"step": int(step), "wall_s": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")

    def close(self):
        self._fh.close()


def save_image_log(expdir, step: int, name: str, img) -> str:
    """PNG image log under ``expdir/imgs`` (the ``i_img`` render)."""
    from pronerf_tpu_torch.ops.metrics import to8b
    from pronerf_tpu_torch.utils.png import write_png

    out = Path(expdir) / "imgs"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}_{step:06d}.png"
    write_png(path, to8b(np.asarray(img)))
    return str(path)
