"""DLRM embedding-bag inference with a tiered table — the paper's §III.B
offline evaluation (Fig. 2) on the port, at the paper's width by default
(PyTorch counterpart of ``examples/dlrm_tiering.py``).

Flow: the table is allocated in the slow tier -> profile batches with the
counter-instrumented ``embedding_bag`` kernel -> promote the oracle top-K
blocks -> replay batches through the tier-aware ``gather_count`` kernel,
which counts each physical block the way a memory-side HMU counts
addresses -> model the per-tier time with the CXL cost model.

    python -m repro_torch.examples.dlrm_tiering            # on the GPU
    python -m repro_torch.examples.dlrm_tiering --small --device cpu

At ``datagen.PAPER`` the table is 20,000,000 rows x 256 float32 (20.48 GB,
5,000,000 blocks of 4 rows = one 4 KiB page), 450,000 fast slots (9 %),
and 150,000 bags of 16 per batch; with the table kept for the exactness
check it needs about 48 GB of device memory.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from ..core import policy
from ..core.blockstore import TieredStore
from ..core.costmodel import CXL_SYSTEM
from ..device import upload
from ..dlrm import datagen
from ..kernels.dispatch import resolve_device
from ..kernels.embedding_bag import embedding_bag
from ..kernels.gather_count import gather_count

__all__ = ["SMALL", "make_table", "run"]

# 256 blocks of 4 rows x 16 dims, 8 bags of 4 per batch: the test size
SMALL = datagen.DLRMTraceSpec(n_params=256 * 4 * 16, emb_dim=16,
                              lookups_per_batch=8 * 4,
                              page_bytes=4 * 16 * 4)


def make_table(n_rows: int, dim: int, seed: int, device) -> torch.Tensor:
    """N(0, 0.05^2) float32 table made on ``device`` by a seeded generator
    (at the paper's width a host-side table would take 41 GB of host
    memory in float64)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    table = torch.empty((n_rows, dim), dtype=torch.float32, device=dev)
    return table.normal_(0.0, 0.05, generator=gen)


def run(spec: datagen.DLRMTraceSpec = datagen.PAPER,
        fast_fraction: float = 0.09, bag: int = 16,
        profile_batches: int = 20, eval_batches: int = 5,
        table=None, seed: int = 0, device="cuda") -> dict:
    """Profile -> promote -> measure on one tiered table.

    ``table`` (tensor or array, ``(spec.n_rows, spec.emb_dim)``) defaults to
    :func:`make_table` on ``device``.  Row ids: Zipf pages from
    ``ZipfPageSampler(spec, seed + 1)``, a uniform row within the page from
    ``numpy.random.default_rng(seed)``.  Returns the counts, the plan, the
    per-tier split and the modeled times (see the keys at the end)."""
    dev = resolve_device(device)
    br, dim = spec.rows_per_page, spec.emb_dim
    n_blocks = spec.n_pages
    n_slots = int(n_blocks * fast_fraction)
    batch = spec.lookups_per_batch // bag
    if table is None:
        table = make_table(spec.n_rows, dim, seed, dev)
    elif isinstance(table, torch.Tensor):
        table = table.to(dev)
    else:
        table = upload(np.asarray(table), dev)
    store = TieredStore.create(table, block_rows=br, n_slots=n_slots)
    sampler = datagen.ZipfPageSampler(spec, seed=seed + 1)
    rng = np.random.default_rng(seed)

    def batch_indices() -> torch.Tensor:
        pages = sampler.sample(batch * bag).astype(np.int64)
        rows = pages * br + rng.integers(0, br, batch * bag)
        return upload(rows.reshape(batch, bag).astype(np.int32), dev)

    # ---- profile: the counters ride along the embedding bag over the slow
    # region, where every allocation starts
    counts = torch.zeros(n_blocks, dtype=torch.int32, device=dev)
    slow = store.storage[store.fast_rows:]
    pooled = None
    for _ in range(profile_batches):
        pooled, counts = embedding_bag(slow, batch_indices(), counts,
                                       block_rows=br)

    # ---- promote the top-K blocks (oracle methodology)
    plan = policy.oracle_top_k(counts, k=store.n_slots)
    store = store.promote(plan.promote)

    # ---- measure: the tier-aware gather counts physical blocks (fast slot
    # s is block s, slow block b is n_slots + b), as an HMU counts addresses
    phys = torch.zeros(n_slots + n_blocks, dtype=torch.int32, device=dev)
    gathered_equal = True
    for _ in range(eval_batches):
        rows = batch_indices().reshape(-1)
        gathered, phys = gather_count(store.storage, store.resolve(rows),
                                      phys, block_rows=br)
        gathered_equal &= bool(torch.equal(gathered,
                                           table.index_select(0, rows)))
        del gathered

    fast_phys, slow_phys = phys[:n_slots], phys[n_slots:]
    s2b = store.slot_to_block
    occ = s2b >= 0
    if bool(torch.any(fast_phys[~occ] != 0)):
        raise AssertionError("accesses counted on a free fast slot")
    eval_counts = slow_phys.to(torch.int64)
    eval_counts.index_add_(0, s2b[occ].to(torch.int64),
                           fast_phys[occ].to(torch.int64))
    n_fast = float(torch.sum(fast_phys, dtype=torch.int64))
    n_slow = float(torch.sum(slow_phys, dtype=torch.int64))
    bpa = dim * table.element_size()
    t_tier = CXL_SYSTEM.access_time_s(n_fast, n_slow, bpa)
    t_fast = CXL_SYSTEM.access_time_s(n_fast + n_slow, 0, bpa)
    t_slow = CXL_SYSTEM.access_time_s(0, n_fast + n_slow, bpa)
    counts_np = counts.cpu().numpy()
    return {
        "n_rows": spec.n_rows, "dim": dim, "block_rows": br,
        "n_blocks": n_blocks, "n_slots": n_slots, "batch": batch, "bag": bag,
        "profile_counts": counts_np,
        "profile_accesses": int(counts_np.astype(np.int64).sum()),
        "profile_blocks_touched": int((counts_np > 0).sum()),
        "pooled": pooled,                       # the last profile batch's
        "promoted": plan.promote.cpu().numpy(),
        "fast_occupancy": int(store.fast_occupancy()),
        "eval_counts": eval_counts.cpu().numpy(),
        "n_fast": n_fast, "n_slow": n_slow,
        "hit_rate": n_fast / max(n_fast + n_slow, 1.0),
        "tiered_s": t_tier, "dram_only_s": t_fast, "cxl_only_s": t_slow,
        "tiered_vs_dram": t_tier / t_fast,
        "gathered_equal": gathered_equal,
    }


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="256 blocks x 4 rows x 16 dims instead of the "
                         "paper's width")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    spec = SMALL if args.small else datagen.PAPER
    t0 = time.perf_counter()
    out = run(spec, bag=4 if args.small else 16, seed=args.seed,
              device=args.device)
    if out["pooled"] is not None and out["pooled"].is_cuda:
        torch.cuda.synchronize()
    print(f"table {out['n_rows']:,} x {out['dim']} in {out['n_blocks']:,} "
          f"blocks, {out['n_slots']:,} fast slots; "
          f"{out['batch']:,} bags of {out['bag']} per batch "
          f"({time.perf_counter() - t0:.1f} s)")
    print(f"profiled: the counters saw {out['profile_accesses']:,} accesses "
          f"across {out['profile_blocks_touched']:,} blocks")
    print(f"promoted {out['fast_occupancy']:,} blocks to the fast tier")
    print(f"fast-tier hit rate: {out['hit_rate']:.1%}")
    print(f"modeled lookup time/eval: tiered={out['tiered_s'] * 1e6:.0f}us "
          f"dram-only={out['dram_only_s'] * 1e6:.0f}us "
          f"cxl-only={out['cxl_only_s'] * 1e6:.0f}us")
    print(f"=> tiered within {out['tiered_vs_dram']:.2f}x of DRAM-only "
          f"(paper: 1.03x at 9%); gathered rows equal the table's: "
          f"{out['gathered_equal']}")
    if not out["gathered_equal"]:
        raise SystemExit("gathered rows differ from the table's")


if __name__ == "__main__":
    main()
