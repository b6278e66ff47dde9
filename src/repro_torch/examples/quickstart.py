"""Quickstart: memory-side tiering telemetry in 60 lines (PyTorch
counterpart of ``examples/quickstart.py``).

Builds a two-tier store, runs a skewed workload through the three telemetry
emulators (HMU / PEBS / NUMA-balancing), promotes with each one's hot list,
and prints the resulting accuracy / coverage / modeled speed — the paper's
core experiment at toy scale.  The printed lines are the reference
example's, line for line (its times are the ``CXL_SYSTEM`` cost model's).

    python -m repro_torch.examples.quickstart                # GPU
    python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from ..core import CXL_SYSTEM, TieredStore, TieringManager

__all__ = ["K_HOT", "N_BLOCKS", "main"]

# ---- a table with a hot head: 4096 blocks, the first 400 are 90% of traffic
N_BLOCKS, K_HOT = 4096, 400


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)

    mgr = TieringManager(n_blocks=N_BLOCKS, k_hot=K_HOT, pebs_period=997,
                         nb_scan_rate=N_BLOCKS // 4, device=args.device)
    for _ in range(32):
        hot = rng.integers(0, K_HOT, 18_000)          # 90% of accesses
        cold = rng.integers(K_HOT, N_BLOCKS, 2_000)   # 10%
        mgr.observe(np.concatenate([hot, cold]))

    results = mgr.evaluate(CXL_SYSTEM, bytes_per_access=256.0)
    print(f"{'strategy':<10s}{'accuracy':>9s}{'coverage':>9s}"
          f"{'host ev.':>10s}{'time':>10s}")
    for name in ("hmu", "pebs", "nb", "dram-only", "cxl-only"):
        r = results[name.replace("cxl-only", "slow-only")]
        print(f"{name:<10s}{r.accuracy:>9.2f}{r.coverage:>9.2f}"
              f"{r.host_events:>10d}{r.time_s*1e6:>9.0f}us")

    # ---- and the actual data plane: a TieredStore gather is tier-transparent
    data = torch.arange(N_BLOCKS * 4 * 8, dtype=torch.float32,
                        device=mgr.device).reshape(N_BLOCKS * 4, 8)
    store = TieredStore.create(data, block_rows=4, n_slots=K_HOT)
    store = store.promote(results["hmu"].promoted[:K_HOT])
    rows = torch.as_tensor(rng.integers(0, N_BLOCKS * 4, 64),
                           device=mgr.device)
    assert bool(torch.all(store.gather(rows) == data[rows]))
    print(f"\nTieredStore: {int(store.fast_occupancy())}/{K_HOT} fast slots "
          "filled; reads identical before/after promotion ✓")


if __name__ == "__main__":
    main()
