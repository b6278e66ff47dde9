"""Analytic two-tier memory cost model.

This container has no CXL expander and no HBM, so end-to-end *time* is
modeled, not measured (the relative telemetry quality — coverage/accuracy —
is measured, it emerges from the emulators).  The model is a per-tier
roofline: a batch of accesses costs

    max( latency-bound term,  bandwidth-bound term )   per tier, summed.

* latency-bound: n_accesses * latency / MLP  (MLP = memory-level parallelism,
  i.e. outstanding requests the core/DMA sustains)
* bandwidth-bound: bytes / bandwidth

Two calibrated profiles are provided:
* ``CXL_SYSTEM`` — the paper's platform (Emerald Rapids DDR5 + FPGA CXL card).
* ``TPU_V5E_SYSTEM`` — the TPU mapping (HBM + host memory over PCIe), used by
  the LM-side tiering features.
"""
from __future__ import annotations

import dataclasses


def _check_overlap(overlap: float) -> None:
    """Overlap fractions are physical ratios: anything outside [0,1] (or NaN)
    is a caller bug, not a clampable input."""
    if not 0.0 <= float(overlap) <= 1.0:
        raise ValueError(f"overlap must be in [0, 1], got {overlap!r}")


@dataclasses.dataclass(frozen=True)
class TierSpec:
    name: str
    latency_ns: float
    bandwidth_gbps: float  # GB/s


@dataclasses.dataclass(frozen=True)
class MemSystem:
    fast: TierSpec
    slow: TierSpec
    mlp: float = 16.0  # sustained outstanding requests

    def tier_time_s(self, n_accesses: float, bytes_total: float, tier: TierSpec) -> float:
        lat = n_accesses * tier.latency_ns * 1e-9 / self.mlp
        bw = bytes_total / (tier.bandwidth_gbps * 1e9)
        return max(lat, bw)

    def access_time_s(
        self,
        n_fast: float,
        n_slow: float,
        bytes_per_access: float,
        overlap: float = 0.0,
    ) -> float:
        """Time to service the access mix.  ``overlap`` in [0,1]: fraction of
        slow-tier time hidden under concurrent work (prefetch/NMC overlap);
        0 is the serial sum of the tiers, 1 hides all slow-tier time."""
        _check_overlap(overlap)
        tf = self.tier_time_s(n_fast, n_fast * bytes_per_access, self.fast)
        ts = self.tier_time_s(n_slow, n_slow * bytes_per_access, self.slow)
        return tf + ts * (1.0 - overlap)

    def migration_time_s(self, n_blocks: float, block_bytes: float) -> float:
        """Block migration: read from slow + write to fast (slow side bounds)."""
        return self.tier_time_s(n_blocks, n_blocks * block_bytes, self.slow)

    def migration_overlap_s(
        self,
        n_slow: float,
        bytes_per_access: float,
        n_blocks: float,
        block_bytes: float,
        overlap: float = 1.0,
    ) -> float:
        """Seconds of epoch time hidden when ``n_blocks`` of migration stream
        concurrently with the epoch's accesses (lookahead prefetch): the
        overlapped fraction of whichever leg is shorter — the slow-tier access
        time or the migration DMA — hides under the other.  0 at
        ``overlap=0`` (stop-the-world migration), ``min(ts, mig)`` at 1."""
        _check_overlap(overlap)
        ts = self.tier_time_s(n_slow, n_slow * bytes_per_access, self.slow)
        mig = self.migration_time_s(n_blocks, block_bytes)
        return overlap * min(ts, mig)

    def overlapped_epoch_time_s(
        self,
        n_fast: float,
        n_slow: float,
        bytes_per_access: float,
        n_blocks: float,
        block_bytes: float,
        overlap: float = 1.0,
    ) -> float:
        """Epoch time when the boundary migration overlaps the epoch's access
        stream instead of serializing ahead of it.  The hidden share of the
        slow-tier access time folds out through the ``access_time_s(overlap=)``
        hook, so the total is the serial sum minus ``migration_overlap_s``:
        never more than stop-the-world migration, never less than the longer
        of the two legs."""
        hidden = self.migration_overlap_s(
            n_slow, bytes_per_access, n_blocks, block_bytes, overlap)
        ts = self.tier_time_s(n_slow, n_slow * bytes_per_access, self.slow)
        eff = hidden / ts if ts > 0.0 else 0.0
        return (self.access_time_s(n_fast, n_slow, bytes_per_access,
                                   overlap=eff)
                + self.migration_time_s(n_blocks, block_bytes))


# The paper's platform: Intel Emerald Rapids (DDR5) + FPGA CXL type-3 card.
# DDR5 local socket ~90 ns load-to-use / ~250 GB/s per socket;
# FPGA CXL.mem ~350-400 ns / ~28 GB/s (FPGA prototypes are slower than ASIC CXL).
CXL_SYSTEM = MemSystem(
    fast=TierSpec("host-dram-ddr5", latency_ns=90.0, bandwidth_gbps=250.0),
    slow=TierSpec("cxl-fpga", latency_ns=380.0, bandwidth_gbps=28.0),
    mlp=16.0,
)

# TPU v5e mapping used by the LM tiering features: HBM vs host DRAM over PCIe.
TPU_V5E_SYSTEM = MemSystem(
    fast=TierSpec("hbm", latency_ns=550.0, bandwidth_gbps=819.0),
    slow=TierSpec("host-pcie", latency_ns=2300.0, bandwidth_gbps=16.0),
    mlp=64.0,
)


def split_accesses_by_tier(counts, is_fast):
    """(n_fast_accesses, n_slow_accesses) given per-block true counts and a
    fast-residency mask."""
    import numpy as np

    c = np.asarray(counts, np.float64)
    m = np.asarray(is_fast, bool)
    return float(c[m].sum()), float(c[~m].sum())
