"""Data containers, synthetic graph generators (host-side numpy) and the
real-data loaders."""

from .directed_data import DirectedData
from .dsbm import DSBM
from .load_real import (Citeseer, Cora_ml, DIGRAC_real_data, MSGNN_real_data,
                        SDGNN_real_data, SSSNET_real_data, Telegram, WebKB,
                        WikiCS, WikipediaNetwork, load_directed_real_data,
                        load_signed_real_data)
from .sdsbm import SDSBM
from .polarized_ssbm import polarized_SSBM
from .signed_data import SignedData
from .ssbm import SSBM, fill, geometric_sizes

__all__ = ["Citeseer", "Cora_ml", "DIGRAC_real_data", "DirectedData", "DSBM",
           "MSGNN_real_data", "SDGNN_real_data", "SDSBM", "SSBM",
           "SSSNET_real_data", "SignedData", "Telegram", "WebKB", "WikiCS",
           "WikipediaNetwork", "fill", "geometric_sizes",
           "load_directed_real_data", "load_signed_real_data",
           "polarized_SSBM"]
