"""hist_select — radix-histogram k-th-largest threshold select.

Per (row, segment), the k-th largest key in 4 byte-level radix passes, the
threshold behind every selection in :mod:`repro_torch.core.selectk`.
"""
from .ops import kth_key
from .ref import kth_key_ref

__all__ = ["kth_key", "kth_key_ref"]
