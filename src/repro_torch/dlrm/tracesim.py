"""Trace-driven reproduction of the paper's two evaluations (PyTorch port of
``repro/dlrm/tracesim.py``).

* ``run_fig3``   — mmap-bench: hotness CDF + PEBS/NB accuracy+coverage and the
  resulting tiering speedups (paper: HMU 2.94x vs PEBS, 1.73x vs NB).
* ``run_table1`` — DLRM embedding-bag inference: HMU vs Linux NB vs DRAM-only
  (paper: 1.94x vs NB, 1.03x slower than DRAM-only, 9% top-tier footprint).
* ``run_online`` — the §VI online regime: the EpochRuntime drives all six
  policies (incl. the hint-fed ``hinted``/``prefetch`` lanes when
  ``hints=True``) over a phase-shifting DLRM trace and returns the per-epoch
  trajectory (time / accuracy / coverage series instead of one end state).
  It is a thin re-export of
  :func:`repro_torch.scenarios.dlrm.run_online` — the DLRM packaging of the
  workload-agnostic :func:`repro_torch.scenarios.run_scenario` loop.

Both run at full paper scale (5.24 M / 2.62 M pages) as *trace* sims: no 20 GB
table is allocated, only per-page counters — exactly the device-side view the
CXL Data Logger provides.

Linux NB is modeled with three handicaps, each traceable to kernel behaviour
(Documentation/mm/numa_balancing; mm/migrate.c):

1. **Saturating hotness signal.**  NB sees hint faults, not accesses: a page
   faults at most once per scan pass and the kernel keeps only the last two
   fault records, so fault counts saturate (cap 2) and every page touched
   soon after each unmap looks identical — ranking among candidates is
   frequency-blind ("NB lacks accuracy / misclassifies super-hot pages").
2. **Promotion throttle + address order.**  Promotion happens on fault
   arrival, throttled at `numa_balancing_promote_rate_limit` (256 MB/s
   default), and the scanner walks VMAs by *address*, so promotion order is
   uncorrelated with hotness.  HMU's oracle methodology batch-promotes the
   exact top-K up-front instead; NB is still mid-ramp during measurement
   ("for fairness, NB had two iterations to promote hot candidates").
3. **Hint-fault tax.**  NB keeps scanning during the measured phase; each
   hint fault costs a trap + bookkeeping.  HMU collects in the memory
   device: zero host-side tax (paper §V).

PEBS is handicapped only by its sampling period (coverage), per the paper.

The collectors run on ``device`` (default ``"cuda"``: raises without a CUDA
device; pass ``device="cpu"`` for the plain versions on the CPU); the
placement and cost arithmetic around them is host numpy, as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from ..core import metrics, telemetry as tel
from ..core.costmodel import CXL_SYSTEM, MemSystem
from ..core.manager import TieringManager
from ..scenarios.dlrm import run_online  # noqa: F401  (thin re-export)
from ..workloads import mmap_bench
from . import datagen

# Cost of servicing one NUMA hint fault (trap, rmap walk, task_numa_fault,
# TLB invalidation share) — well-documented AutoNUMA overhead, ~1-3 us.
NB_FAULT_COST_S = 2e-6
# Kernel keeps two fault records per page -> counts saturate at 2.
NB_FAULT_CAP = 2
# numa_balancing_promote_rate_limit_MBps default.
NB_PROMOTE_BYTES_PER_S = 256e6
# Scanner unmap rate: 256 MB per 100 ms scan window (task_numa_work defaults)
# -> ceiling on hint-fault rate while a promotion backlog keeps scanning on.
NB_SCAN_UNMAP_PAGES_PER_S = 625_000.0


def nb_fault_tax_s(
    elapsed_s: float,
    touch_rate_pages_per_s: float,
    scan_pages_per_s: float = NB_SCAN_UNMAP_PAGES_PER_S,
) -> float:
    """Hint-fault servicing time the workload pays while NB keeps scanning:
    fault rate = min(rate pages are (re)touched, scanner unmap rate).  The
    scanner rate is adaptive in Linux (scan_period 100ms..60s); callers pick a
    point in that range per workload phase."""
    rate = min(touch_rate_pages_per_s, scan_pages_per_s)
    return elapsed_s * rate * NB_FAULT_COST_S


@dataclasses.dataclass
class MethodRow:
    name: str
    avg_inference_us: float
    pages_promoted: int
    top_tier_gb: float
    speed_vs_nb: float
    accuracy: float
    coverage: float
    host_events: int
    migration_s: float = 0.0


def nb_select(
    faults: np.ndarray, k: int, fault_cap: int = NB_FAULT_CAP, seed: int = 0
) -> np.ndarray:
    """NB candidates: two-touch, ranked by saturated fault count, ties broken
    blindly; returned in *promotion (address/scan) order*, i.e. shuffled."""
    rng = np.random.default_rng(seed)
    cand = np.nonzero(faults >= 2)[0]
    if cand.size == 0:
        return cand
    sat = np.minimum(faults[cand], fault_cap)
    tie = rng.permutation(cand.size)
    order = np.lexsort((tie, -sat))
    chosen = cand[order[: min(k, cand.size)]]
    return rng.permutation(chosen)  # promotion arrives in address order


def _np(t) -> np.ndarray:
    return t.cpu().numpy()


def _mask(n: int, ids: np.ndarray) -> np.ndarray:
    m = np.zeros((n,), bool)
    if ids.size:
        m[ids] = True
    return m


def _mem_time_s(system, counts, fast_mask, bpa) -> float:
    n_fast = float(counts[fast_mask].sum())
    n_slow = float(counts.sum()) - n_fast
    return system.access_time_s(n_fast, n_slow, bpa)


# =====================================================================  Table 1
def run_table1(
    spec: datagen.DLRMTraceSpec = datagen.PAPER,
    system: MemSystem = CXL_SYSTEM,
    warmup_iterations: int = 2,   # the paper's "two iterations"
    batches_per_iteration: int = 20,
    eval_batches: int = 30,
    k_hot: Optional[int] = None,
    nb_throttle_bytes_per_s: float = NB_PROMOTE_BYTES_PER_S,
    dram_only_target_us: float = 63_324.0,    # calibrates non-memory compute time
    seed: int = 0,
    device="cuda",
) -> Dict[str, MethodRow]:
    n_pages = spec.n_pages
    k = min(k_hot if k_hot is not None else spec.k_hot_paper, n_pages)
    warmup_batches = warmup_iterations * batches_per_iteration
    # NB completes one scan pass per iteration (needs >=2 for two-touch).
    scan_rate = max(n_pages // batches_per_iteration, 1)
    mgr = TieringManager(n_pages, k, nb_scan_rate=scan_rate, device=device)
    sampler = datagen.ZipfPageSampler(spec, seed)

    # ---- warmup/profiling: allocations in CXL, collectors observe.
    # Each iteration's batches go through observe_all (one observe_scatter
    # launch per batch) — bit-identical to per-batch observe.
    for _ in range(warmup_iterations):
        mgr.observe_epoch(np.stack([
            sampler.sample(spec.lookups_per_batch)
            for _ in range(batches_per_iteration)]))
    mgr.hmu = tel.hmu_drain_cost(mgr.hmu)

    # ---- eval traffic (expectation replay of the stationary distribution)
    probs = sampler.page_probabilities()
    per_batch = probs * spec.lookups_per_batch
    true_hot = metrics.true_top_k(per_batch, k)

    hmu_counts = _np(tel.hmu_estimate(mgr.hmu))
    hmu_sel = np.argsort(-hmu_counts, kind="stable")[:k]
    hmu_sel = hmu_sel[hmu_counts[hmu_sel] > 0]
    nb_sel = nb_select(_np(tel.nb_estimate(mgr.nb)), k, seed=seed)

    bpa = float(spec.row_bytes)
    mem_all_fast = _mem_time_s(system, per_batch, np.ones((n_pages,), bool), bpa)
    compute_base_s = dram_only_target_us * 1e-6 - mem_all_fast
    assert compute_base_s > 0, "cost model: memory time exceeds calibration target"

    rows: Dict[str, MethodRow] = {}

    def add(name, t_s, promoted, host, migration_s=0.0):
        rows[name] = MethodRow(
            name=name, avg_inference_us=t_s * 1e6,
            pages_promoted=int(promoted.size),
            top_tier_gb=promoted.size * spec.page_bytes / 1e9,
            speed_vs_nb=0.0,
            accuracy=metrics.accuracy(promoted, true_hot) if promoted.size else 0.0,
            coverage=metrics.coverage(promoted, true_hot, k),
            host_events=host, migration_s=migration_s,
        )

    # HMU: exact top-K batch-promoted after warmup (oracle methodology).
    t_hmu = compute_base_s + _mem_time_s(system, per_batch, _mask(n_pages, hmu_sel), bpa)
    add("hmu", t_hmu, hmu_sel, int(float(mgr.hmu.host_events)),
        migration_s=system.migration_time_s(hmu_sel.size, spec.page_bytes))

    add("dram-only", compute_base_s + mem_all_fast, np.arange(n_pages), 0)
    rows["dram-only"].top_tier_gb = spec.table_bytes / 1e9
    t_cxl = compute_base_s + _mem_time_s(system, per_batch, np.zeros((n_pages,), bool), bpa)
    add("cxl-only", t_cxl, np.empty((0,), np.int64), 0)

    # NB: throttled promotion in address order, ramping through the eval.
    # Candidates only confirm (two-touch) during the second scan pass, so the
    # promotion clock starts one iteration into the warmup.
    ramp_elapsed = max(warmup_batches - batches_per_iteration, 0) * t_cxl
    migrated = min(nb_throttle_bytes_per_s * ramp_elapsed,
                   nb_sel.size * spec.page_bytes)
    nb_mask = np.zeros((n_pages,), bool)
    # page (re)touch rate: pages touched per iteration / iteration wall time
    touched_per_iter = float(np.sum(1.0 - np.exp(-per_batch * batches_per_iteration)))
    total_t, eval_faults = 0.0, 0.0
    for _ in range(eval_batches):
        nb_mask[nb_sel[: int(migrated // spec.page_bytes)]] = True
        t = compute_base_s + _mem_time_s(system, per_batch, nb_mask, bpa)
        touch_rate = touched_per_iter / (t * batches_per_iteration)
        tax = nb_fault_tax_s(t, touch_rate)
        eval_faults += tax / NB_FAULT_COST_S
        t += tax
        total_t += t
        migrated = min(migrated + nb_throttle_bytes_per_s * t,
                       nb_sel.size * spec.page_bytes)
    add("nb", total_t / eval_batches, np.nonzero(nb_mask)[0],
        int(float(mgr.nb.host_events) + eval_faults))

    for r in rows.values():
        r.speed_vs_nb = rows["nb"].avg_inference_us / r.avg_inference_us
    return rows


# =====================================================================  Fig. 3
def run_fig3(
    spec: mmap_bench.MmapBenchSpec = mmap_bench.PAPER,
    system: MemSystem = CXL_SYSTEM,
    total_accesses: int = 180_000_000,
    pebs_period: int = 10007,
    nb_scan_passes: float = 16.0,
    n_batches: int = 64,
    nb_throttle_bytes_per_s: float = NB_PROMOTE_BYTES_PER_S,
    nb_eval_scan_pages_per_s: float = 150_000.0,   # steady-state adaptive rate
    nb_profile_credit: float = 0.4,   # fraction of the profile run in which NB
                                      # promotes (scan_delay + two-touch lag)
    nb_fault_cap: int = 12,           # windows the latency threshold resolves
    seed: int = 0,
    device="cuda",
) -> dict:
    """mmap-bench: profile the full run, promote per strategy, then replay.
    Performance metric is reads/second (latency-bound random access).  NB's
    placement ramps at the kernel throttle during the measured replay."""
    n_pages, k = spec.n_pages, spec.k_hot
    scan_rate = max(int(n_pages * nb_scan_passes / n_batches), 1)
    mgr = TieringManager(n_pages, k, pebs_period=pebs_period,
                         nb_scan_rate=scan_rate, device=device)
    batch = total_accesses // n_batches
    for pages in mmap_bench.access_stream(spec, total_accesses, batch=batch, seed=seed):
        mgr.observe(pages)
    mgr.hmu = tel.hmu_drain_cost(mgr.hmu)

    true_hot = mmap_bench.true_hot_pages(spec)
    counts = mgr.true_counts
    reads = float(counts.sum())
    bpa = float(spec.access_bytes)

    hmu_counts = _np(tel.hmu_estimate(mgr.hmu))
    hmu_sel = np.argsort(-hmu_counts, kind="stable")[:k]
    pebs_est = _np(tel.pebs_estimate(mgr.pebs))
    pebs_ids = np.argsort(-pebs_est, kind="stable")
    pebs_sel = pebs_ids[pebs_est[pebs_ids] > 0][:k]
    # With short scan windows (16 passes) per-pass fault counts resolve the
    # hot/cold frequency contrast (the fault-latency threshold in kernel
    # terms), so rank with cap = pass count.
    nb_sel = nb_select(_np(tel.nb_estimate(mgr.nb)), k,
                       fault_cap=nb_fault_cap, seed=seed)

    out = {
        "hotness": {
            "pages_for_90pct": metrics.pages_for_access_fraction(counts, 0.90),
            "cdf": metrics.hotness_cdf(counts, n_points=20),
        },
        "methods": {},
    }
    host = {
        "hmu": int(float(mgr.hmu.host_events)),
        "pebs": int(float(mgr.pebs.host_events)),
        "nb": int(float(mgr.nb.host_events)),
    }

    # HMU/PEBS: batch-promote up-front, steady-state replay.
    for name, ids in (("hmu", hmu_sel), ("pebs", pebs_sel)):
        t = _mem_time_s(system, counts, _mask(n_pages, ids), bpa)
        out["methods"][name] = {
            "reads_per_s": reads / t,
            "accuracy": metrics.accuracy(ids, true_hot),
            "coverage": metrics.coverage(ids, true_hot, k),
            "promoted": int(ids.size), "host_events": host[name],
        }

    # NB: replay in chunks with the promotion ramp + fault tax (scan-capped:
    # mmap-bench touches pages far faster than the scanner unmaps them).
    # Promotion credit accrues during the profiling run (the same workload is
    # executing while the kernel migrates at the throttle rate).
    nb_mask = np.zeros((n_pages,), bool)
    t_profile = _mem_time_s(system, counts, nb_mask, bpa)
    t_profile += nb_fault_tax_s(t_profile, float("inf"), nb_eval_scan_pages_per_s)
    migrated = min(nb_throttle_bytes_per_s * t_profile * nb_profile_credit,
                   nb_sel.size * spec.page_bytes)
    total_t, eval_faults = 0.0, 0.0
    chunk_counts = counts / n_batches
    for _ in range(n_batches):
        nb_mask[nb_sel[: int(migrated // spec.page_bytes)]] = True
        t = _mem_time_s(system, chunk_counts, nb_mask, bpa)
        tax = nb_fault_tax_s(t, float("inf"), nb_eval_scan_pages_per_s)
        eval_faults += tax / NB_FAULT_COST_S
        t += tax
        total_t += t
        migrated = min(migrated + nb_throttle_bytes_per_s * t,
                       nb_sel.size * spec.page_bytes)
    nb_final = np.nonzero(nb_mask)[0]
    out["methods"]["nb"] = {
        "reads_per_s": reads / total_t,
        "accuracy": metrics.accuracy(nb_final, true_hot),
        "coverage": metrics.coverage(nb_final, true_hot, k),
        "promoted": int(nb_final.size),
        "host_events": host["nb"] + int(eval_faults),
    }

    for name, mask in (("dram-only", np.ones((n_pages,), bool)),
                       ("cxl-only", np.zeros((n_pages,), bool))):
        out["methods"][name] = {
            "reads_per_s": reads / _mem_time_s(system, counts, mask, bpa),
            "accuracy": 1.0, "coverage": 1.0,
            "promoted": int(mask.sum()), "host_events": 0,
        }
    m = out["methods"]
    m["hmu"]["speedup_vs_pebs"] = m["hmu"]["reads_per_s"] / m["pebs"]["reads_per_s"]
    m["hmu"]["speedup_vs_nb"] = m["hmu"]["reads_per_s"] / m["nb"]["reads_per_s"]
    out["overlap_nb_hmu"] = metrics.overlap(nb_final, hmu_sel, k)
    return out


# =====================================================================  online
# run_online lives in repro_torch.scenarios.dlrm (the DLRM packaging of the
# workload-agnostic scenario loop); imported above.
