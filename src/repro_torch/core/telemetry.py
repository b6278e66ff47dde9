"""Telemetry collectors (PyTorch port of ``repro/core/telemetry.py``).

Three observers of one ground-truth access stream, plus the true counter:

* ``HMU``  — memory-side exact per-block counters (saturating) and a bounded
  request log whose drain is the collector's only host cost;
* ``PEBS`` — every ``period``-th access of the stream, by an exact int32
  cursor carried modulo the period;
* ``NB``   — NUMA-balancing hint faults: a cyclic scanner unmaps
  ``scan_rate`` blocks per batch and the first touch of an unmapped block
  faults (recency, not frequency).

Every collector update is an affine function of two per-batch histograms —
the access histogram and the PEBS-sampled one — which one
:func:`repro_torch.kernels.observe_scatter.observe_scatter` pass over the
batch's ids produces (the hand-written kernel on the card, the plain
version on the CPU).  This is the reference's kernel path
(``telemetry.py:438-455``); its scatter-per-collector path gives the same
states bit for bit.

State is a set of frozen dataclasses holding tensors, updated functionally
like the reference's pytrees.  Event scalars are exact
:class:`~repro_torch.faults.Counter64` values.

**Fault lanes.**  A bundle built with a
:class:`~repro_torch.faults.FaultModel` (``bundle_init(faults=...)``)
injects the reference's faults on the device, in the same pass:

* HMU counters saturate at the model's ``hmu_counter_max``;
* each would-be PEBS sample is dropped with probability ``pebs_drop_p``
  (scalar or per-block): the keep mask rides into the same
  ``observe_scatter`` pass, and the drops accrue to
  ``faults.pebs_dropped``;
* once an epoch, before its batches, each collector's cumulative state
  resets with probability ``reset_p`` (drain races);
* with probability ``nb_stall_p`` a batch's NB scanner tick is a no-op.

Every draw is the reference's own ``jax.random`` draw, computed by
:mod:`repro_torch.faults.prng` from the model's key, so faulty states are
identical to the reference's too.  Ground truth is never faulted.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..faults import prng
from ..faults.model import (CARRY_BASE, INT32_MAX, Counter64, FaultModel,
                            counter_add, counter_init, counter_scaled_add,
                            counter_zero_like)
from ..kernels.observe_scatter import observe_scatter

__all__ = [
    "HMUState", "PEBSState", "NBState", "TelemetryBundle",
    "hmu_init", "hmu_observe", "hmu_estimate", "hmu_drain_cost",
    "hmu_saturated", "pebs_init", "pebs_observe", "pebs_estimate",
    "nb_init", "nb_observe", "nb_estimate",
    "bundle_init", "observe_all", "count_observe",
]


def _i32(value: int, device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.int32, device=device)


# =====================================================================  HMU
@dataclasses.dataclass(frozen=True)
class HMUState:
    """Exact saturating per-block counters + bounded request-log emulation."""
    counts: torch.Tensor       # (n_blocks,) int32 saturating access counts
    log_used: Counter64        # records currently in the log
    log_dropped: Counter64     # records lost to log overflow
    log_capacity: int
    host_events: Counter64     # host work units spent (drain only)


def hmu_init(n_blocks: int, log_capacity: int = 1 << 33,
             device="cpu") -> HMUState:
    return HMUState(
        counts=torch.zeros((n_blocks,), dtype=torch.int32, device=device),
        log_used=counter_init(device), log_dropped=counter_init(device),
        log_capacity=int(log_capacity), host_events=counter_init(device))


def _hmu_observe(state: HMUState, n_events: int, hist: torch.Tensor,
                 weight: int = 1,
                 counter_max: Optional[torch.Tensor] = None) -> HMUState:
    """HMU update from the batch's access histogram: ``counts + hist *
    weight``, saturating at ``counter_max`` (a fault model's int32 cap,
    scalar or per-block; int32 max without one) instead of wrapping, and
    ``n_events`` records offered to the log.  The reference's hi/lo
    free-space arithmetic (``telemetry.py:139-148``) is ``clip(capacity -
    used, 0, n)`` exactly (its ``diff_hi >= 2`` branch only triggers where
    the free space exceeds any one call's events), so the int64 counter
    computes that directly."""
    n = int(n_events) * int(weight)
    if n >= CARRY_BASE:
        raise ValueError(
            f"one observe call adds {n} events; split calls below "
            f"{CARRY_BASE} so the log counters stay exact like the "
            f"reference's")
    summed = state.counts + hist * weight          # int32, may wrap
    # a wrapped sum reads less than the old count: exactly the blocks that
    # crossed int32 max this call (per-call mass << 2**31)
    if counter_max is None:
        counts = torch.where(summed < state.counts, INT32_MAX,
                             torch.clamp(summed, max=INT32_MAX))
    else:
        counts = torch.where(summed < state.counts, counter_max,
                             torch.minimum(summed, counter_max))
    appended = torch.clamp(state.log_capacity - state.log_used.value, 0, n)
    return dataclasses.replace(
        state, counts=counts,
        log_used=counter_add(state.log_used, appended),
        log_dropped=counter_add(state.log_dropped, n - appended))


def hmu_estimate(state: HMUState) -> torch.Tensor:
    return state.counts


def hmu_saturated(state: HMUState,
                  counter_max: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Blocks pinned at the saturation cap (``counter_max``, a fault model's
    ``hmu_counter_max``; int32 max without one): () int64."""
    cap = INT32_MAX if counter_max is None else counter_max
    return torch.sum(state.counts >= cap, dtype=torch.int64)


def hmu_drain_cost(state: HMUState, per_record_cost: float = 1.0) -> HMUState:
    """Host drains the log: ``host_events += log_used * cost``, log empties.
    ``per_record_cost`` must be a small non-negative integer, as in the
    reference."""
    cost = float(per_record_cost)
    if not cost.is_integer() or not 0 <= cost < 64:
        raise ValueError(f"per_record_cost must be a small non-negative "
                         f"integer (exact counter math), got "
                         f"{per_record_cost!r}")
    return dataclasses.replace(
        state,
        host_events=counter_scaled_add(state.host_events, state.log_used,
                                       int(cost)),
        log_used=counter_zero_like(state.log_used))


# =====================================================================  PEBS
@dataclasses.dataclass(frozen=True)
class PEBSState:
    sampled: torch.Tensor      # (n_blocks,) int32 sampled hits per block
    cursor: torch.Tensor       # () int32 global access index mod period
    period: int
    host_events: Counter64     # one per PEBS record


def pebs_init(n_blocks: int, period: int = 10007, device="cpu") -> PEBSState:
    return PEBSState(
        sampled=torch.zeros((n_blocks,), dtype=torch.int32, device=device),
        cursor=_i32(0, device), period=int(period),
        host_events=counter_init(device))


def _pebs_sample_mask(state: PEBSState, m: int) -> torch.Tensor:
    """(m,) bool: the batch positions PEBS samples (stream index a multiple
    of the period)."""
    pos = state.cursor + torch.arange(m, dtype=torch.int32,
                                      device=state.cursor.device)
    return torch.remainder(pos, state.period) == 0


def _pebs_apply(state: PEBSState, m: int, pebs_hist: torch.Tensor,
                n_kept: Optional[torch.Tensor] = None) -> PEBSState:
    """PEBS update from the sampled histogram of an ``m``-access batch.
    Without drops the kept count is the closed form of the reference's
    kernel path (``telemetry.py:443-444``): multiples of the period in
    [cursor, cursor + m), with floor division (``cursor - 1`` is -1 at
    cursor 0); with drops the caller counts the survivors."""
    cur, per = state.cursor, state.period
    if n_kept is None:
        n_kept = (torch.div(cur + (m - 1), per, rounding_mode="floor")
                  - torch.div(cur - 1, per, rounding_mode="floor"))
    return dataclasses.replace(
        state, sampled=state.sampled + pebs_hist,
        cursor=torch.remainder(cur + m, per).to(torch.int32),
        host_events=counter_add(state.host_events, n_kept))


def pebs_estimate(state: PEBSState) -> torch.Tensor:
    """Scaled estimate: each sample represents ``period`` accesses."""
    return state.sampled * state.period


# =====================================================================  NB
@dataclasses.dataclass(frozen=True)
class NBState:
    """NUMA-balancing emulation (task_numa_work-style cyclic scanner)."""
    mapped: torch.Tensor       # (n_blocks,) bool: PTE present
    faults: torch.Tensor       # (n_blocks,) int32 hint-fault counts
    scan_ptr: torch.Tensor     # () int32 cyclic scan position
    scan_rate: int
    host_events: Counter64     # hint faults serviced


def nb_init(n_blocks: int, scan_rate: int, device="cpu") -> NBState:
    return NBState(
        mapped=torch.ones((n_blocks,), dtype=torch.bool, device=device),
        faults=torch.zeros((n_blocks,), dtype=torch.int32, device=device),
        scan_ptr=_i32(0, device), scan_rate=int(scan_rate),
        host_events=counter_init(device))


def _nb_observe(state: NBState, touched: torch.Tensor,
                stalled: Optional[torch.Tensor] = None) -> NBState:
    """One scanner tick, then the batch's touches (``touched = hist > 0``).
    The tick unmaps the cyclic window ``[scan_ptr, scan_ptr + scan_rate)``
    mod n_blocks, written as a mask instead of the reference's scatter: a
    block is in it iff ``(i - scan_ptr) mod n < scan_rate``.  ``stalled``
    (a () bool on the device, from the fault model) makes the tick a no-op
    — no unmapping, no cursor advance — by ``torch.where``, while the
    touches still re-map pages."""
    n = state.mapped.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=touched.device)
    in_scan = torch.remainder(idx - state.scan_ptr, n) < state.scan_rate
    advance = state.scan_rate
    if stalled is not None:
        in_scan = in_scan & ~stalled
        advance = torch.where(stalled, 0, state.scan_rate)
    mapped = state.mapped & ~in_scan
    faulted = touched & ~mapped
    return dataclasses.replace(
        state, mapped=mapped | touched,
        faults=state.faults + faulted.to(torch.int32),
        scan_ptr=torch.remainder(state.scan_ptr + advance,
                                 n).to(torch.int32),
        host_events=counter_add(state.host_events,
                                torch.sum(faulted, dtype=torch.int64)))


def nb_estimate(state: NBState) -> torch.Tensor:
    return state.faults


# =====================================================  fused bundle (epoch)
@dataclasses.dataclass(frozen=True)
class TelemetryBundle:
    """All three collectors plus the device-side ground-truth counter."""
    hmu: HMUState
    pebs: PEBSState
    nb: NBState
    true_counts: torch.Tensor  # (n_blocks,) int32 exact histogram
    faults: Optional[FaultModel] = None


def bundle_init(n_blocks: int, pebs_period: int = 10007,
                nb_scan_rate: int = 1, hmu_log_capacity: int = 1 << 33,
                faults: Optional[FaultModel] = None,
                device="cpu") -> TelemetryBundle:
    """Fresh collectors on ``device``; with ``faults``, a private copy of
    the model on the same device (its per-block knobs must have
    ``n_blocks`` entries)."""
    if faults is not None:
        for name in ("pebs_drop_p", "hmu_counter_max"):
            leaf = getattr(faults, name)
            if leaf.dim() == 1 and leaf.shape[0] != n_blocks:
                raise ValueError(f"FaultModel.{name} is per-block with "
                                 f"{leaf.shape[0]} entries; this bundle has "
                                 f"n_blocks={n_blocks}")
        faults = faults.to(device)
    return TelemetryBundle(
        hmu=hmu_init(n_blocks, log_capacity=hmu_log_capacity, device=device),
        pebs=pebs_init(n_blocks, period=pebs_period, device=device),
        nb=nb_init(n_blocks, scan_rate=nb_scan_rate, device=device),
        true_counts=torch.zeros((n_blocks,), dtype=torch.int32,
                                device=device),
        faults=faults)


def _bundle_observe(bundle: TelemetryBundle,
                    block_ids: torch.Tensor) -> TelemetryBundle:
    """One batch: ONE observe_scatter pass feeds all four updates."""
    flat = block_ids.reshape(-1)
    m = flat.shape[0]
    n = bundle.true_counts.shape[0]
    f = bundle.faults
    if f is None:
        hist, pebs_hist = observe_scatter(flat, bundle.pebs.cursor,
                                          n_blocks=n,
                                          period=bundle.pebs.period)
        return TelemetryBundle(
            hmu=_hmu_observe(bundle.hmu, m, hist),
            pebs=_pebs_apply(bundle.pebs, m, pebs_hist),
            nb=_nb_observe(bundle.nb, hist > 0),
            true_counts=bundle.true_counts + hist)
    # the reference's per-batch draws (telemetry.py:464-469), same key
    # splits, same words; ground truth is never faulted
    keys = prng.split(f.key, 3)
    if f.pebs_drop_p.dim() == 0:
        drop_p = f.pebs_drop_p
    else:   # jnp's gather: a negative id wraps once, then ids clamp
        idx = flat.to(torch.int64)
        idx = torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)
        drop_p = f.pebs_drop_p[idx]
    keep = prng.uniform(keys[1], (m,)) >= drop_p
    stalled = prng.bernoulli(keys[2], f.nb_stall_p)
    hist, pebs_hist = observe_scatter(flat, bundle.pebs.cursor, n_blocks=n,
                                      period=bundle.pebs.period, keep=keep)
    hit = _pebs_sample_mask(bundle.pebs, m)
    n_kept = torch.sum(hit & keep, dtype=torch.int64)
    n_dropped = torch.sum(hit & ~keep, dtype=torch.int64)
    return TelemetryBundle(
        hmu=_hmu_observe(bundle.hmu, m, hist,
                         counter_max=f.hmu_counter_max),
        pebs=_pebs_apply(bundle.pebs, m, pebs_hist, n_kept=n_kept),
        nb=_nb_observe(bundle.nb, hist > 0, stalled=stalled),
        true_counts=bundle.true_counts + hist,
        faults=dataclasses.replace(
            f, key=keys[0],
            pebs_dropped=counter_add(f.pebs_dropped, n_dropped),
            nb_stalls=f.nb_stalls + stalled.to(torch.int32)))


def _bundle_resets(bundle: TelemetryBundle) -> TelemetryBundle:
    """Once an epoch, before its batches (``telemetry.py:490-510``): with
    per-collector probability ``reset_p`` a collector's cumulative state
    snaps back to empty — HMU counts, the PEBS sampled histogram, NB fault
    counts and its PTE state.  The runtime's epoch-delta baselines are not
    touched, so the next delta it computes is garbage for one epoch."""
    f = bundle.faults
    keys = prng.split(f.key)
    r = prng.uniform(keys[1], (3,)) < f.reset_p          # COLLECTORS order
    hmu = dataclasses.replace(
        bundle.hmu, counts=torch.where(r[0], 0, bundle.hmu.counts))
    pebs = dataclasses.replace(
        bundle.pebs, sampled=torch.where(r[1], 0, bundle.pebs.sampled))
    nb = dataclasses.replace(
        bundle.nb, faults=torch.where(r[2], 0, bundle.nb.faults),
        mapped=bundle.nb.mapped | r[2])
    return dataclasses.replace(
        bundle, hmu=hmu, pebs=pebs, nb=nb,
        faults=dataclasses.replace(f, key=keys[0],
                                   resets=f.resets + r.to(torch.int32)))


def observe_all(bundle: TelemetryBundle,
                batches: torch.Tensor) -> TelemetryBundle:
    """Observe a whole epoch ``(n_batches, batch_size)``: the per-batch
    update applied in the reference scan's order (``telemetry.py:553-561``),
    so states match it bit for bit.  With a fault model, the epoch's reset
    draw comes first, as in the reference."""
    if batches.dim() != 2:
        raise ValueError(f"epoch batches must be 2-D, got "
                         f"{tuple(batches.shape)}")
    if bundle.faults is not None:
        bundle = _bundle_resets(bundle)
    for i in range(batches.shape[0]):
        bundle = _bundle_observe(bundle, batches[i])
    return bundle


# ------------------------------------------------ per-collector entry points
def _hist(block_ids: torch.Tensor, n_blocks: int) -> torch.Tensor:
    flat = block_ids.reshape(-1)
    return observe_scatter(flat, _i32(0, flat.device), n_blocks=n_blocks,
                           period=1)[0]


def hmu_observe(state: HMUState, block_ids: torch.Tensor,
                weight: int = 1) -> HMUState:
    """Every access counted (``weight`` times)."""
    return _hmu_observe(state, block_ids.numel(),
                        _hist(block_ids, state.counts.shape[0]), weight)


def pebs_observe(state: PEBSState, block_ids: torch.Tensor) -> PEBSState:
    """Only every ``period``-th access of the stream is seen."""
    flat = block_ids.reshape(-1)
    _, pebs_hist = observe_scatter(flat, state.cursor,
                                   n_blocks=state.sampled.shape[0],
                                   period=state.period)
    return _pebs_apply(state, flat.shape[0], pebs_hist)


def nb_observe(state: NBState, block_ids: torch.Tensor) -> NBState:
    return _nb_observe(state, _hist(block_ids, state.faults.shape[0]) > 0)


def count_observe(counts: torch.Tensor,
                  block_ids: torch.Tensor) -> torch.Tensor:
    """Ground-truth histogram update."""
    return counts + _hist(block_ids, counts.shape[0])
