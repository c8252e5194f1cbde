"""pytorch_geometric_signed_directed_tpu_torch — the PyTorch/CUDA port.

A port of ``pytorch_geometric_signed_directed_tpu`` (the JAX/Pallas
package beside it, which stays the reference) to PyTorch on an NVIDIA
Hopper card.  Plain tensor code is PyTorch; every Pallas kernel on a
ported path is a CUDA C++ kernel written by hand for ``sm_90a``
(``ops/cuda``), built with ``nvcc`` at first use and bound with ctypes.

Layout mirrors the JAX package so a reader can find each counterpart:

  ops/       COO container, segment tier (``index_add_``), tiered SpMM
             (dense / segment / mxu), the CSR scatter kernel (ops/cuda).
  spectral/  host-side (numpy/scipy) magnetic Laplacians.
  data/      DSBM synthetic generator.
  utils/     meta-graph generation.
  nn/        MagNet layers and models as ``torch.nn.Module``s.
  train/     full-batch trainer (Adam with coupled L2).

Device policy: every entry point that places tensors takes ``device=None``
and ``None`` means ``"cuda"``.  Without CUDA it raises and asks for
``device="cpu"``; it never moves to the CPU on its own.
"""

__version__ = "0.1.0"

from . import ops  # noqa: F401
from . import graph  # noqa: F401
from . import spectral  # noqa: F401
from . import utils  # noqa: F401
from . import data  # noqa: F401
from . import nn  # noqa: F401
from . import train  # noqa: F401
from .device import resolve_device  # noqa: F401

__all__ = ["ops", "graph", "spectral", "utils", "data", "nn", "train",
           "resolve_device", "__version__"]
