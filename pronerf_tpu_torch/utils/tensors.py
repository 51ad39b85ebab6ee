"""Small tensor helpers shared by the ops and the render entry points."""

from __future__ import annotations

import numpy as np
import torch


def as_f32(x, device=None):
    """``x`` (tensor, numpy array or nested list) as a float32 tensor on
    ``device`` (``None`` keeps a tensor where it is)."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def resolve_device(device):
    """The ``torch.device`` an entry point runs on. The default is the
    card: asking for ``cuda`` on a machine without one raises instead of
    running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pronerf_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions"
        )
    return device
