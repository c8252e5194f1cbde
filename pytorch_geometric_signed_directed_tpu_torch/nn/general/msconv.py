"""MSConv: MagNetConv over the signed magnetic Laplacian.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/general/
msconv.py``.  The Chebyshev recurrence is MagNetConv's; only the
Laplacian differs (signed weights, absolute-degree normalization), and it
comes from ``spectral.magnet_propagators(signed=True, absolute_degree=...)``
or ``magnetic_template(signed=True)``.
"""
from typing import Optional

import torch

from ...device import DeviceLike
from ..directed.magnet_conv import MagNetConv


class MSConv(MagNetConv):
    """MagNetConv with the ``absolute_degree`` its Laplacian was built
    with; pass operators built with ``signed=True``."""

    def __init__(self, in_channels: int, out_channels: int, K: int,
                 q: float = 0.25, trainable_q: bool = False,
                 normalization: Optional[str] = "sym", bias: bool = True,
                 absolute_degree: bool = True, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, K, q=q,
                         trainable_q=trainable_q, normalization=normalization,
                         bias=bias, device=device, generator=generator)
        self.absolute_degree = absolute_degree
