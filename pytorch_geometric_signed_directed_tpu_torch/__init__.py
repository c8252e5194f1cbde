"""pytorch_geometric_signed_directed_tpu_torch — the PyTorch/CUDA port.

A port of ``pytorch_geometric_signed_directed_tpu`` (the JAX/Pallas
package beside it, which stays the reference) to PyTorch on an NVIDIA
Hopper card.  Plain tensor code is PyTorch; every Pallas kernel on a
ported path is a CUDA C++ kernel written by hand for ``sm_90a``
(``ops/cuda``), built with ``nvcc`` at first use and bound with ctypes.

Layout mirrors the JAX package so a reader can find each counterpart.
Imports point one way, from the bottom of this list up: ``device`` and
``instrument``, ``native``, ``ops``, ``graph`` and ``spectral``, ``nn`` and
``utils``, ``parallel``, ``train``, ``experiments``.

  instrument.py  the port's spans and call counters (imports only torch).
  ops/       COO container, segment tier (``index_add_``), tiered SpMM
             (dense / segment / mxu / bsr), the layouts, the CUDA
             kernels (ops/cuda).
  spectral/  host-side (numpy/scipy) magnetic Laplacians, the
             trainable-q templates, PPR adjacencies and spectral
             features.
  parallel/  the kernel tier across a device mesh.
  data/      DirectedData / SignedData containers, DSBM, SDSBM, SSBM, the
             polarized SSBM, the real-data loaders and writers of their
             file schemas.
  utils/     meta-graph generation, node and link splits, samplers, the
             imbalance, balanced-cut, link-sign and triplet losses, the
             numpy logistic probes and metrics.
  nn/        MagNet, MSGNN, DIGRAC, DiGCN, DGCN, DiGCL, SSSNET, SGCN,
             SNEA, SiGAT and SDGNN layers and models as
             ``torch.nn.Module``s.
  train/     full-batch trainer (Adam with coupled L2), masked NLL,
             checkpoints, timing.
  experiments/  every experiment (``experiments.EXPERIMENTS``), run
             by ``python -m pytorch_geometric_signed_directed_tpu_torch``.

Device policy: every entry point that places tensors takes ``device=None``
and ``None`` means ``"cuda"``.  Without CUDA it raises and asks for
``device="cpu"``; it never moves to the CPU on its own.
"""

__version__ = "0.1.0"

from . import ops  # noqa: F401
from . import graph  # noqa: F401
from . import spectral  # noqa: F401
# nn before utils: utils.signed's losses import nn.inits, and nn.signed's
# SGCN imports those losses
from . import nn  # noqa: F401
from . import utils  # noqa: F401
from . import data  # noqa: F401
from . import parallel  # noqa: F401
from . import train  # noqa: F401
from . import experiments  # noqa: F401
from .device import resolve_device  # noqa: F401

__all__ = ["ops", "graph", "spectral", "utils", "data", "nn", "parallel",
           "train", "experiments", "resolve_device", "__version__"]
