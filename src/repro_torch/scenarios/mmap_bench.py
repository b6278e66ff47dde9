"""mmap-bench scenario — the paper's §III.A microbenchmark, online (PyTorch
port of ``repro/scenarios/mmap_bench.py``).

``workloads.mmap_bench`` reproduces the paper's synthetic region workload
(10 GiB mapped, 1 GiB hot for 90% of accesses) as a page-id access stream,
which also feeds the offline fig3 profile->promote->replay path.  This
scenario packages that stream onto the :class:`~repro_torch.scenarios.
AccessScenario` protocol, so the §III.A workload runs the same online
six-lane :class:`~repro_torch.core.runtime.EpochRuntime` loop as DLRM and
the KV cache — and doubles as the fleet's antagonist tenant: a scanner that
touches a wide, internally-uniform region at high volume is exactly the
noisy neighbour that floods count-ranked selection in a shared fast tier
(``repro_torch.fleet``).

The workload is stationary (``shift_at`` defaults to 0 so summary slices
cover the whole run).  The hot region IS compile-time knowledge: the
program allocates the hot arena, so the static hint layout is the identity
rank map over the region with a flat (``alpha=0``) within-region prior.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from ..core.costmodel import CXL_SYSTEM, MemSystem
from ..hints import HintLayout
from ..workloads import mmap_bench

__all__ = ["MmapBenchScenario"]


@dataclasses.dataclass
class MmapBenchScenario:
    """§III.A mmap-bench as an online access scenario.

    Blocks are 4 KiB pages of the mapped region; the hot region occupies
    pages ``[0, spec.k_hot)`` and receives ``spec.hot_access_fraction`` of
    the accesses, uniform within each region.  ``accesses_per_batch`` sets
    the stream intensity — crank it to turn the benchmark into a
    noisy-neighbour scanner tenant.
    """

    spec: mmap_bench.MmapBenchSpec = mmap_bench.SMALL
    system: MemSystem = CXL_SYSTEM
    n_epochs: int = 6
    batches_per_epoch: int = 4
    accesses_per_batch: int = 20_000
    k_hot: Optional[int] = None          # fast-tier slots; default = hot pages
    shift_at: int = 0                    # stationary workload
    pebs_period: int = 1009
    seed: int = 0

    name = "mmap_bench"

    def __post_init__(self):
        n = self.spec.n_pages
        self.n_blocks = n
        self.k_hot = (self.spec.k_hot if self.k_hot is None
                      else min(int(self.k_hot), n))
        self.bytes_per_access = float(self.spec.access_bytes)
        self.block_bytes = float(self.spec.page_bytes)
        self.nb_scan_rate = max(n // self.batches_per_epoch, 1)

    def epochs(self) -> Iterator[np.ndarray]:
        """Deterministic per call: a fresh generator over the same seed."""
        total = self.n_epochs * self.batches_per_epoch * self.accesses_per_batch
        it = mmap_bench.access_stream(
            self.spec, total_accesses=total, batch=self.accesses_per_batch,
            seed=self.seed)
        for _ in range(self.n_epochs):
            yield np.stack([next(it) for _ in range(self.batches_per_epoch)])

    def hint_layout(self) -> HintLayout:
        # the program allocated the arena: identity layout, flat prior —
        # every annotated page ranks equally, the clip marks the hot head
        return HintLayout(
            self.n_blocks,
            rank_to_page=np.arange(self.n_blocks, dtype=np.int32),
            alpha=0.0,
            rows_per_page=max(self.spec.page_bytes
                              // self.spec.access_bytes, 1),
        )
