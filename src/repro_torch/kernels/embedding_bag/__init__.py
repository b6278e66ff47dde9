"""embedding_bag — DLRM batched embedding bag with memory-side counters.

Per bag, the weighted sum of its rows (float32 accumulation, cast to the
storage dtype), with every looked-up row's block counter bumped in the same
pass.
"""
from .ops import embedding_bag
from .ref import embedding_bag_ref

__all__ = ["embedding_bag", "embedding_bag_ref"]
