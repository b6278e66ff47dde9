"""mmap-bench (paper §III.A): 10 GiB region, 1 GiB hot for 90% of accesses.

"The mmap-bench microbenchmark allocates 10 GiB of memory, with 1 GiB being
accessed for 90% of the execution.  Within this frequently accessed region,
the precise number of pages eligible for promotion is K = 262,144 (4 KiB)
pages."

We reproduce it as an access *stream* at page granularity (the Data Logger's
view: physical page addresses), so a full paper-scale run needs only a few
hundred MB of trace batches, not 10 GiB of data.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

PAGE_BYTES = 4096


@dataclasses.dataclass(frozen=True)
class MmapBenchSpec:
    total_bytes: int = 10 << 30          # 10 GiB
    hot_bytes: int = 1 << 30             # 1 GiB hot region
    hot_access_fraction: float = 0.9     # 90% of accesses hit the hot region
    page_bytes: int = PAGE_BYTES
    access_bytes: int = 64               # one cacheline per access (CXL.mem flit)

    @property
    def n_pages(self) -> int:
        return self.total_bytes // self.page_bytes

    @property
    def k_hot(self) -> int:
        """K — pages eligible for promotion (the paper's 262,144)."""
        return self.hot_bytes // self.page_bytes


# Reduced spec for CI-speed tests: same shape, 4096x smaller.
SMALL = MmapBenchSpec(total_bytes=10 << 18, hot_bytes=1 << 18)
PAPER = MmapBenchSpec()


def access_stream(
    spec: MmapBenchSpec,
    total_accesses: int,
    batch: int = 1 << 21,
    seed: int = 0,
) -> Iterator[np.ndarray]:
    """Ground-truth page-id stream: Bernoulli(hot_fraction) region choice,
    uniform within each region (the paper's benchmark touches the hot GiB
    uniformly — skew across pages comes from the region split)."""
    rng = np.random.default_rng(seed)
    n_hot = spec.k_hot
    n_pages = spec.n_pages
    remaining = total_accesses
    while remaining > 0:
        n = min(batch, remaining)
        hot = rng.random(n) < spec.hot_access_fraction
        pages = np.where(
            hot,
            rng.integers(0, n_hot, n),
            rng.integers(n_hot, n_pages, n),
        ).astype(np.int32)
        yield pages
        remaining -= n


def true_hot_pages(spec: MmapBenchSpec) -> np.ndarray:
    return np.arange(spec.k_hot, dtype=np.int32)
