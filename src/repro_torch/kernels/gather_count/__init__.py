"""gather_count — tier-aware row gather with memory-side block counters.

``rows = storage[idx]`` and ``counts[idx // block_rows] += 1`` in one pass:
the HMU's counters ride along the data movement, as in the paper's CXL
memory device.
"""
from .ops import gather_count
from .ref import gather_count_ref

__all__ = ["gather_count", "gather_count_ref"]
