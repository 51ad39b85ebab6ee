"""The ``pronerf`` namespace of ``torch.library`` ops through which the
serving path launches the four CUDA kernels (``pronerf::fused_minmax``,
``pronerf::fused_nerf_raw``, ``pronerf::fused_nerf_composite``,
``pronerf::fused_nerf_raw_q``), so that a traced program can name them.

The ops are registered with the low-level :class:`torch.library.Library`
API: each has a CUDA implementation (launch the kernel and count it, or
raise), a CPU one (the kernel's plain version), a fake one (the shapes, for
``torch.export``) and an autograd one whose backward raises, since the
kernels are inference kernels and have no gradient.

Why not ``torch.library.custom_op``: it wraps every implementation in
``torch._disable_dynamo``, which imports ``torch._dynamo`` (with sympy and
FX) at the first call, seconds of a serving process's first frame that no
frame needs. An implementation registered here is called as it is. The
names and schemas are those the ``custom_op`` form had, so a program
exported under either form loads and serves under the other.
"""

from __future__ import annotations

import torch

NAMESPACE = "pronerf"

# one "DEF" library a namespace; kept alive for the process, or the ops
# would be deregistered
_LIB = torch.library.Library(NAMESPACE, "DEF")


def _no_backward(qualname):
    def backward(ctx, *grads):
        raise RuntimeError(
            f"Trying to backward through {qualname} but no autograd formula "
            "was registered: the kernel serves frames and has no gradient")

    return backward


def define(schema: str, cuda, cpu, fake):
    """Define the op ``pronerf::<schema>`` and register its
    implementations: ``cuda`` for CUDA tensors, ``cpu`` for CPU tensors,
    ``fake`` for tracing; a backward through it raises.

    Returns the op's ``OpOverload`` (``torch.ops.pronerf.<name>.default``),
    which callers, ``torch.library.opcheck`` and traced programs take."""
    name = schema.split("(", 1)[0]
    qualname = f"{NAMESPACE}::{name}"
    _LIB.define(schema)
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(qualname, fake, lib=_LIB)
    torch.library.register_autograd(qualname, _no_backward(qualname),
                                    lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
