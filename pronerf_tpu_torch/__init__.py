"""pronerf_tpu_torch: the PyTorch/CUDA port of ``pronerf_tpu`` for one
NVIDIA Hopper card.

It sits beside the JAX package, mirrors its module names, and imports
nothing of it (and no ``jax``): what it needs from the jax-free modules there
it keeps as its own copy. Plain tensor code is eager PyTorch; the fused MLP
kernels are CUDA C++ under ``kernels/csrc/``, built at first use.

Geometry (projection, ray generation) and the f32 parity path must run in
full float32, so importing the package switches TF32 off for matrix products
and for cuDNN.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
