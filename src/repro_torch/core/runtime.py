"""Epoch-driven tiering runtime, fused path (PyTorch port of
``repro/core/runtime.py``): observe -> decide -> migrate -> account.

Each epoch is two steps on the device:

1. :func:`repro_torch.core.telemetry.observe_all` feeds the epoch's batches
   to the HMU, PEBS and NB collectors and the true counter — one
   ``observe_scatter`` kernel pass per batch;
2. :func:`_epoch_step` runs the six policy lanes: every lane's signal is
   ranked in ONE ``selectk.select_top_k`` over the stacked unique key rows
   (one ``hist_select`` kernel call), the lanes migrate through
   ``placement.apply_plan``, and their counts land in row ``out_row`` of the
   device-side record buffer.

With a :class:`~repro_torch.faults.FaultModel` the collectors degrade on the
device (``core.telemetry``) and the step keeps its accounting on ground
truth (its own ``prev_true`` baseline and a hot set of its own, one more
``hist_select`` call an epoch), serves the lanes' estimates
``stale_epochs`` late from a ring, and clamps negative deltas (a reset) to
zero.  With a :class:`~repro_torch.faults.Hardening` it tracks each
collector's smoothed quality (observed epoch mass over expected), swaps a
lane's input to a healthy collector by ``torch.where`` on that scalar when
it falls below the floor, and gates watermark demotion on ``H`` cold epochs
in a row.  Both only add state leaves and record columns: no branch reads
the device.

With a :class:`Tenancy` (``repro_torch.fleet``) the same step enforces
per-tenant quotas — one segment-capped ``hist_select`` call masks every key
row to each tenant's own top ``caps[t]`` before the select — and adds
(L, T) per-tenant counts to the same record row, which the flush appends to
``EpochRuntime.tenant_records``.

The host pulls that buffer — one packed ``(sync_every, F)`` int64 tensor —
once every ``sync_every`` epochs (:meth:`EpochRuntime._flush_records`, the
only device->host transfer of the loop, counted in
``DISPATCH_COUNTS["record_sync"]``) and assembles the
:class:`EpochRecord`\\ s in float64 on the host, exactly as the reference
does, so trajectories are bit-identical to it for every ``sync_every``.
Inside an epoch nothing is read back: thresholds, caps and the PEBS bound
stay host Python ints, and every upload (batches, hint ranks) goes through
pinned memory without blocking.

With a tracer enabled (:mod:`repro_torch.obs.trace`) the loop records the
reference's spans — ``hint_refresh``, ``observe_all``, ``epoch_step`` and
``record_sync`` — and, with ``profiler_annotations``, the same names as
``torch.profiler`` ranges around the kernels they launch.  PyTorch runs
eagerly, so there is no trace to count: the reference's ``TRACE_COUNTS``
has no counterpart here.

With a mesh (``mesh=``, a ``DeviceMesh``, and ``mesh_axis``) every leaf
whose last axis is the block axis holds the rank's contiguous range of it
(:mod:`repro_torch.core.shard`); scalars, ``slot_to_block`` and the record
buffer are replicated.  Every rank observes the whole epoch and counts its
own range.  Each selection gathers its int32 key rows into the full block
vector (one all-gather), runs the unchanged ``select_top_k`` /
``top_k_mask`` / ``segment_top_k_mask`` there and keeps the rank's slice of
the masks, so ties stay lowest-index-first and ``hist_select`` launches as
often as without a mesh.  Reads of a per-block leaf by a slot's or a plan's
block id are answered by the owning rank in one integer all-reduce, and the
epoch's record row is summed in one more.  Nothing reduces a float over the
block axis, so a sharded trajectory is byte-identical to the meshless one.

``fused=False`` is the reference's per-lane host loop, kept as the
bit-identity oracle of the fused step: each epoch pulls four full
estimate arrays and the event scalars to the host, and every lane decides
by one eager policy call (``policy.oracle_top_k`` ... ``policy.prefetch``,
each one ``hist_select`` launch on the card) and migrates through host
numpy maps (:meth:`EpochRuntime._apply_plan`).  It syncs by design, so it
takes ``sync_every=1`` only and no fault model; its records carry the
``reference_step`` span.

Policy lanes and their telemetry sources:

=================  =========================  ===============================
lane               estimate                   host tax per epoch
=================  =========================  ===============================
hmu_oracle         HMU epoch-delta counts     log drain (~ns/record)
nb_two_touch       NB cumulative faults       hint faults (~2 us each)
reactive_watermark HMU epoch-delta counts     log drain
proactive_ewma     EWMA of HMU epoch deltas   log drain
hinted             PEBS epoch-delta estimate  PEBS samples (~1.5 us each)
                   blended with static hints
prefetch           lookahead window over the  none
                   queued next-epoch batches
=================  =========================  ===============================
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
from collections import deque
from typing import (Dict, Iterable, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from . import selectk
from . import policy
from . import shard as shd
from . import telemetry as tel
from ..device import sync_allowed, upload
from ..faults.model import COLLECTORS, LANE_COLLECTOR, FaultModel, Hardening
from ..kernels.dispatch import resolve_device
from ..kernels.hist_select import kernel as hs_kernel
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from . import metrics
from .costmodel import CXL_SYSTEM, MemSystem, split_accesses_by_tier
from .placement import Placement, apply_plan, demote_idle

__all__ = [
    "ALL_POLICIES", "DISPATCH_COUNTS", "Counters", "counting",
    "EpochRecord", "EpochRuntime", "Tenancy", "Trajectory",
]

ALL_POLICIES = (
    "hmu_oracle", "nb_two_touch", "reactive_watermark", "proactive_ewma",
    "hinted", "prefetch",
)

NB_FAULT_COST_S = 2e-6
PEBS_SAMPLE_COST_S = 1.5e-6
HMU_DRAIN_COST_S = 2e-9

# Per-call counters: an epoch is exactly one observe_all and one epoch_step;
# "hint_refresh" counts host->device hint-rank uploads, "record_sync" the
# device->host record pulls (ceil(n_epochs / sync_every) per run), and
# "reference" the per-lane reference path's pulls, decisions and
# evictions.  A CounterDict view over the process metrics registry
# (repro_dispatch_total, labelled by kind), so the same counts are
# scrapeable.  Never zeroed: read them through counting().
DISPATCH_COUNTS = obs_metrics.CounterDict(
    obs_metrics.REGISTRY.counter(
        "repro_dispatch_total",
        help="Host->device dispatches and transfers by kind"),
    "kind", keys=("observe_all", "epoch_step", "reference",
                  "hint_refresh", "record_sync"))


class _CounterView:
    """Read-only scope-relative view of one live counter dict: each key reads
    as (current total) - (total at scope entry).  The live dict is never
    mutated, so nested and overlapping views stay correct."""

    def __init__(self, live: obs_metrics.CounterDict):
        self._live = live
        self._base = dict(live)

    def __getitem__(self, key: str) -> int:
        if key not in self._live:       # a typo'd gate must not read as 0
            raise KeyError(key)
        return self._live[key] - self._base.get(key, 0)

    def get(self, key: str, default: int = 0) -> int:
        return self[key] if key in self._live else default

    def __contains__(self, key: str) -> bool:
        return key in self._live

    def __iter__(self):
        return iter(self._live)

    def keys(self):
        return self._live.keys()

    def items(self):
        return [(k, self[k]) for k in self._live]

    def __eq__(self, other) -> bool:
        if isinstance(other, _CounterView):
            other = dict(other.items())
        return dict(self.items()) == other

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"_CounterView({dict(self.items())!r})"


class Counters(NamedTuple):
    """The scope-relative views a :func:`counting` block observes."""
    dispatch: _CounterView


@contextlib.contextmanager
def counting():
    """``with counting() as c:`` — ``c.dispatch[kind]`` reads the activity
    since the block started; nestable, since the live dict is never reset."""
    yield Counters(_CounterView(DISPATCH_COUNTS))


@dataclasses.dataclass
class EpochRecord:
    """One lane's accounting for one epoch."""
    epoch: int
    lane: str
    time_s: float            # access + host tax + migration
    access_s: float
    host_tax_s: float
    migration_s: float
    accuracy: float          # placement that served the epoch vs epoch top-K
    coverage: float
    resident: int            # fast blocks during the epoch
    promoted: int            # migrations applied at epoch end
    demoted: int
    host_events: float       # telemetry events charged this epoch
    hidden_s: float = 0.0    # migration time overlapped away (prefetch lane)
    quality: float = 1.0     # collector quality (1.0 without hardening)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Trajectory:
    """Per-epoch time series for every lane (the runtime's output)."""
    n_blocks: int
    k_hot: int
    records: Dict[str, List[EpochRecord]]

    def lane(self, name: str) -> List[EpochRecord]:
        return self.records[name]

    def times(self, name: str) -> np.ndarray:
        return np.array([r.time_s for r in self.records[name]])

    def to_json(self, **meta) -> str:
        return json.dumps({
            "n_blocks": self.n_blocks,
            "k_hot": self.k_hot,
            **meta,
            "lanes": {name: [r.to_dict() for r in recs]
                      for name, recs in self.records.items()},
        }, indent=1)


@dataclasses.dataclass
class _Lane:
    """Per-policy placement state of the *reference* path (host numpy maps;
    the fused path holds the same state lane-stacked in a Placement, and
    ``EpochRuntime.lanes`` gives host copies of it in this form)."""
    name: str
    slot_to_block: np.ndarray            # (k,) int32, -1 = free
    block_to_slot: np.ndarray            # (n_blocks,) int32, -1 = slow-only
    pred: Optional[np.ndarray] = None    # EWMA state (proactive lane)

    @property
    def fast_mask(self) -> np.ndarray:
        return self.block_to_slot >= 0

    def resident_ids(self) -> np.ndarray:
        s = self.slot_to_block
        return s[s >= 0]


def _unique_in_order(ids: np.ndarray, k: int) -> np.ndarray:
    """Valid plan ids, de-duplicated preserving priority order, capped at k."""
    ids = np.asarray(ids).reshape(-1)
    ids = ids[ids >= 0]
    _, first = np.unique(ids, return_index=True)
    return ids[np.sort(first)][:k]


class Tenancy(NamedTuple):
    """Static multi-tenant layout of one shared block space
    (``repro_torch.fleet``).

    ``offsets`` are the cumulative block offsets of the per-tenant id ranges
    (length T+1, ``offsets[0] == 0``, ``offsets[-1] == n_blocks``); tenant
    ``t`` owns global ids ``[offsets[t], offsets[t+1])``.  ``hot_k`` is each
    tenant's true-hot-set size — the denominator of its per-tenant coverage,
    the fast-tier target it would run solo — and ``caps`` are per-tenant
    admission quotas applied to every lane's selection each epoch (``None``
    = shared pool, no quotas).  While ``sum(caps) <= k_hot`` a tenant's
    first ``caps[t]`` wanted blocks are admitted unconditionally, because
    ``placement.apply_plan`` never evicts a still-wanted resident ahead of
    a free slot: quotas are isolation guarantees, not only rate limits.
    Hashable: it rides in the epoch step's static config."""
    offsets: Tuple[int, ...]
    hot_k: Tuple[int, ...]
    caps: Optional[Tuple[int, ...]] = None

    @property
    def n_tenants(self) -> int:
        return len(self.offsets) - 1

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(b - a for a, b in zip(self.offsets, self.offsets[1:]))

    def block_tenants(self) -> np.ndarray:
        """Per-block tenant ids, (n_blocks,) int32."""
        return np.repeat(np.arange(self.n_tenants, dtype=np.int32),
                         self.sizes)

    def validate(self, n_blocks: int, k_hot: int,
                 max_segments: Optional[int] = None) -> None:
        """Raise on a layout the epoch step cannot run.  ``max_segments``
        is the card's ``hist_select`` segment cap (every epoch selects per
        tenant in one call); ``None`` (the plain versions) has no cap."""
        offs = self.offsets
        if len(offs) < 2 or offs[0] != 0 or offs[-1] != n_blocks or any(
                b <= a for a, b in zip(offs, offs[1:])):
            raise ValueError(f"tenancy offsets must be strictly increasing "
                             f"from 0 to n_blocks={n_blocks}, got {offs}")
        if len(self.hot_k) != self.n_tenants or any(
                not 0 < h <= s for h, s in zip(self.hot_k, self.sizes)):
            raise ValueError(f"hot_k must give every tenant a size in "
                             f"(0, n_tenant_blocks], got {self.hot_k}")
        if self.caps is not None:
            if len(self.caps) != self.n_tenants or any(
                    c < 0 for c in self.caps):
                raise ValueError(f"caps must be one non-negative quota per "
                                 f"tenant, got {self.caps}")
            if sum(self.caps) > k_hot:
                raise ValueError(f"tenant caps sum to {sum(self.caps)} > "
                                 f"k_hot={k_hot}; quotas must fit the fast "
                                 f"tier for admission to be guaranteed")
        if max_segments is not None and self.n_tenants > max_segments:
            raise ValueError(
                f"tenancy has {self.n_tenants} tenants, more than the "
                f"{max_segments} segments one hist_select call takes on "
                f"the card")


# ======================================================  fused device step
class _FusedCfg(NamedTuple):
    """Hashable static config of the epoch step."""
    lanes: Tuple[str, ...]
    n_blocks: int
    k_hot: int
    ewma_alpha: float
    hint_weight: float
    nb_rate_limit: Optional[int]
    reactive_hot_threshold: Optional[int]
    tenancy: Optional[Tenancy] = None
    hardening: Optional[Hardening] = None
    shard: Optional[shd.BlockShard] = None   # the rank's range under a mesh


@dataclasses.dataclass(frozen=True)
class _FusedState:
    """Everything the epoch loop mutates, resident on the device."""
    bundle: tel.TelemetryBundle
    placement: Placement         # lane-stacked: (L, k_hot) / (L, n_blocks)
    pred: torch.Tensor           # (n_blocks,) f32 EWMA (the proactive lane's)
    hint_rank: torch.Tensor      # (n_blocks,) f32 static priorities
    prefetch_rank: torch.Tensor  # (n_blocks,) f32 lookahead priorities
    prev_hmu: torch.Tensor       # (n_blocks,) i32 epoch-delta baselines
    prev_pebs: torch.Tensor
    out_buf: torch.Tensor        # (sync_every, F) int64 packed record rows
                                 # (layout: _out_columns), written in place
    # with a Tenancy: its segments on the device, uploaded once — widths
    # hot_k (per-tenant hot sets) and, under quotas, caps
    tenant_hot: Optional[selectk.SegmentLayout] = None
    tenant_caps: Optional[selectk.SegmentLayout] = None
    # --- robustness leaves (None = subsystem off), as the reference's
    #     (runtime.py:282-305)
    prev_true: Optional[torch.Tensor] = None
                                 # (n_blocks,) i32 ground-truth baseline
                                 # (faults: d_hmu is no longer the truth)
    stale: Optional[torch.Tensor] = None
                                 # (stale_epochs+1, 3, n_blocks) i32 delay
                                 # ring of [d_hmu, d_pebs, nb] estimates
    stale_ptr: int = 0           # ring write position (advances by one an
                                 # epoch, so the host knows it)
    quality: Optional[torch.Tensor] = None
                                 # (3,) f32 smoothed per-collector quality
                                 # (COLLECTORS order; hardening only)
    prev_nb: Optional[torch.Tensor] = None
                                 # (n_blocks,) i32 last served NB faults
    nb_ewma: Optional[torch.Tensor] = None
                                 # () f32 EWMA of NB epoch fault mass
    cold_streak: Optional[torch.Tensor] = None
                                 # (L, n_blocks) i32 consecutive cold
                                 # epochs (demote hysteresis H > 1 only)


# Packed record-row layout: three collector event scalars, then one column
# per lane for each per-lane count, then (with a Hardening) the three
# collectors' smoothed quality as float32 bits, then (with a Tenancy) L x T
# columns, lane-major, for each per-tenant count (the reference's out_buf
# dict and its "quality" and "tenant" entries, packed so a flush is one
# exact transfer).
_OUT_SCALARS = ("drained", "pebs_host", "nb_host")
_OUT_LANE_FIELDS = ("n_fast", "n_slow", "inter", "resident", "promoted",
                    "demoted")


def _out_columns(n_lanes: int, n_tenants: int,
                 quality: bool = False) -> Dict[str, object]:
    cols: Dict[str, object] = {f: i for i, f in enumerate(_OUT_SCALARS)}
    base = len(_OUT_SCALARS)
    for j, f in enumerate(_OUT_LANE_FIELDS):
        cols[f] = slice(base + j * n_lanes, base + (j + 1) * n_lanes)
    base += len(_OUT_LANE_FIELDS) * n_lanes
    if quality:
        cols["quality"] = slice(base, base + len(COLLECTORS))
        base += len(COLLECTORS)
    width = n_lanes * n_tenants
    for j, f in enumerate(_OUT_LANE_FIELDS):
        cols["tenant:" + f] = slice(base + j * width, base + (j + 1) * width)
    cols["width"] = base + len(_OUT_LANE_FIELDS) * width
    return cols


def _out_buf_init(sync_every: int, n_lanes: int, n_tenants: int,
                  device, quality: bool = False) -> torch.Tensor:
    """Zeroed device accumulator for ``sync_every`` epochs of record rows."""
    width = _out_columns(int(n_lanes), int(n_tenants), quality)["width"]
    return torch.zeros((int(sync_every), width), dtype=torch.int64,
                       device=device)


def _per_tenant_sum(x: torch.Tensor, offsets: Sequence[int],
                    lo: int = 0) -> torch.Tensor:
    """(L, n) -> (L, T) int64: a sum over each tenant's id range (the
    ranges are contiguous and static, so each is a slice; one
    ``index_add_`` over the segment ids would instead send every block's
    value to one of L x T addresses by an atomic add).  ``x`` holds the
    blocks from global id ``lo`` (a sharded rank's range): each range is
    clipped to it, and a tenant outside it sums to zero."""
    return torch.stack([torch.sum(x[:, max(a - lo, 0):max(b - lo, 0)],
                                  dim=-1, dtype=torch.int64)
                        for a, b in zip(offsets, offsets[1:])], dim=-1)


def _lane_column(values: Sequence, dtype, device) -> torch.Tensor:
    """(L, 1) per-lane constant, filled on the device (no host copy)."""
    col = torch.empty((len(values), 1), dtype=dtype, device=device)
    for i, v in enumerate(values):
        col[i].fill_(v)
    return col


def _epoch_step(state: _FusedState, epoch_accesses: int, out_row: int, *,
                cfg: _FusedCfg, s_max: int) -> _FusedState:
    """decide + migrate + account for every lane.

    ``epoch_accesses`` and ``out_row`` are host ints; ``s_max`` is the
    static PEBS-positives bound.  The lanes' counts are written into row
    ``out_row`` of ``state.out_buf``; nothing leaves the device."""
    lanes, k = cfg.lanes, cfg.k_hot
    har = cfg.hardening
    sh = cfg.shard
    dev = state.pred.device
    b = state.bundle
    faulty = b.faults is not None

    # -- drain the HMU log (host tax charged from the drained count)
    drained = b.hmu.log_used
    bundle = dataclasses.replace(b, hmu=tel.hmu_drain_cost(b.hmu))

    # -- epoch-local estimates.  The fault-free HMU counter is exact, so
    #    d_hmu IS the epoch's ground truth and the oracle lane's selection
    #    doubles as the epoch-hot set.  With faults the step keeps its own
    #    ground-truth baseline: accounting stays on the truth while the
    #    lanes see only what their degraded collectors deliver.
    true_now = b.true_counts
    hmu_now = b.hmu.counts
    pebs_now = b.pebs.sampled * b.pebs.period
    d_hmu = hmu_now - state.prev_hmu
    d_pebs = pebs_now - state.prev_pebs
    nb_faults = b.nb.faults
    d_true = (true_now - state.prev_true if state.prev_true is not None
              else d_hmu)

    # -- staleness: this epoch's estimates go into the delay ring and the
    #    lanes are served the ones stale_epochs old (zeros while it warms
    #    up); accounting (d_true) is never delayed.  Served rows are copies:
    #    prev_nb keeps one past the slot's next write.
    stale_ptr_new = state.stale_ptr
    if state.stale is not None:
        depth = state.stale.shape[0]
        state.stale[state.stale_ptr] = torch.stack([d_hmu, d_pebs,
                                                    nb_faults])
        stale_ptr_new = (state.stale_ptr + 1) % depth
        served = state.stale[stale_ptr_new].clone()
        d_hmu, d_pebs, nb_faults = served[0], served[1], served[2]
    if faulty:
        # a reset shrinks cumulative collector state, so a delta can go
        # negative: "no information this epoch", never negative hotness
        d_hmu = torch.clamp_min(d_hmu, 0)
        d_pebs = torch.clamp_min(d_pebs, 0)
    d_hmu_f = d_hmu.to(torch.float32)

    # -- per-collector quality (hardening): observed epoch mass over the
    #    expected.  HMU and period-scaled PEBS should both report the
    #    epoch's access mass; NB's expectation is its own smoothed history.
    #    Every fault lane shrinks observed mass, so one smoothed scalar per
    #    collector covers them all.
    quality_new = nb_ewma_new = prev_nb_new = None
    if har is not None:
        exp_mass = torch.full((), float(max(np.float32(epoch_accesses),
                                            1.0)),
                              dtype=torch.float32, device=dev)
        d_nb = torch.clamp_min(nb_faults - state.prev_nb, 0)
        obs = [torch.sum(x, dtype=torch.int64) for x in (d_hmu, d_pebs, d_nb)]
        if sh is not None:              # integer masses: exact in any order
            obs = shd.sum_parts(sh, obs)
        obs_hmu, obs_pebs, obs_nb = (o.to(torch.float32) for o in obs)
        q_raw = torch.stack([
            policy.quality_estimate(obs_hmu, exp_mass),
            policy.quality_estimate(obs_pebs, exp_mass),
            torch.where(state.nb_ewma > 0.0,
                        policy.quality_estimate(obs_nb, state.nb_ewma),
                        1.0)])
        quality_new = policy.quality_smooth(
            state.quality, q_raw, har.quality_beta,
            torch.arange(3, device=dev) != 1)
        nb_ewma_new = policy.quality_smooth(state.nb_ewma, obs_nb,
                                            har.quality_beta, False)
        prev_nb_new = nb_faults

    thr = (cfg.reactive_hot_threshold
           if cfg.reactive_hot_threshold is not None
           else max(2, epoch_accesses // (8 * max(k, 1))))

    # -- per-lane selection keys (int32; floats via order-isomorphic
    #    bitcast) and eviction estimates.  Lanes that rank the same signal
    #    share one selection row.
    rows: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def row(rkey: str, key: torch.Tensor, est: torch.Tensor) -> int:
        if rkey not in rows:
            rows[rkey] = (key, est)
        return list(rows).index(rkey)

    hmu_row = row("hmu", d_hmu, d_hmu_f)
    # -- collector fallback (hardening): while a lane's primary collector's
    #    smoothed quality is below the floor, the lane's selection key AND
    #    eviction estimate are swapped, by torch.where on the quality
    #    scalar, to the named collector's served delta
    fb_map = dict(har.fallback) if har is not None else {}
    col_key = {"hmu": d_hmu, "pebs": d_pebs, "nb": nb_faults}

    def fall_back(name: str, key: torch.Tensor, est: torch.Tensor):
        alt = col_key[fb_map[name]]
        # the floor as a float32 value, as the reference compares it
        floor = float(np.float32(har.quality_floor))
        ok = quality_new[COLLECTORS.index(LANE_COLLECTOR[name])] >= floor
        return (ok, torch.where(ok, key, alt),
                torch.where(ok, est, alt.to(torch.float32)))

    pred_new = state.pred
    lane_row, min_keys, caps, is_reactive, healthy = [], [], [], [], []
    for name in lanes:
        if name == "hmu_oracle":
            r, min_key, cap = hmu_row, 1, k
            key, est = d_hmu, d_hmu_f
        elif name == "nb_two_touch":
            cap = k if cfg.nb_rate_limit is None else min(k, cfg.nb_rate_limit)
            min_key = 2
            key, est = nb_faults, nb_faults.to(torch.float32)
            r = row("nb", key, est)
        elif name == "reactive_watermark":
            r, min_key, cap = hmu_row, thr, k
            key, est = d_hmu, d_hmu_f
        elif name == "proactive_ewma":
            # the reference's fused-step float32 arithmetic, bit for bit
            pred_new = policy.ewma(cfg.ewma_alpha, d_hmu_f, state.pred)
            key, est = selectk.sortable_key(pred_new), pred_new
            r = row("pred", key, est)
            min_key, cap = 1, k
        elif name == "hinted":
            # exact argsort(argsort(d_pebs)): positives are bounded by this
            # epoch's PEBS samples, so rank the sparse support only (a
            # rank over the whole block axis: under a mesh, of the gathered
            # vector, and the rank keeps its slice)
            if sh is None:
                t_rank = selectk.stable_rank_sparse(d_pebs, s_max)
            else:
                t_rank = sh.local(selectk.stable_rank_sparse(
                    shd.all_gather(sh, d_pebs), s_max))
            score = policy.hinted_score(d_pebs, t_rank, state.hint_rank,
                                        cfg.hint_weight,
                                        n_blocks=cfg.n_blocks)
            key, est = selectk.sortable_key(score), d_pebs.to(torch.float32)
            r = row("score", key, est)
            min_key, cap = 0, k
        elif name == "prefetch":
            # lookahead rank in [0,1]; min_key 1 gates rank > 0
            r = row("la", selectk.sortable_key(state.prefetch_rank),
                    state.prefetch_rank)
            min_key, cap = 1, k
        else:  # pragma: no cover - guarded in __init__
            raise ValueError(name)
        ok = None
        if name in fb_map:
            ok, key, est = fall_back(name, key, est)
            r = row(f"fb:{name}", key, est)
        healthy.append(ok)
        lane_row.append(r)
        min_keys.append(min_key)
        caps.append(cap)
        is_reactive.append(name == "reactive_watermark")

    key_rows = torch.stack([kv[0] for kv in rows.values()])  # (U, n) int32
    ests = [kv[1] for kv in rows.values()]
    est_lanes = torch.stack([ests[r] for r in lane_row])      # (L, n) f32
    reactive = _lane_column(is_reactive, torch.bool, dev)       # (L, 1)
    min_key_col = _lane_column(min_keys, torch.int32, dev)
    if fb_map:
        # a fallen-back lane keys on a raw collector delta whatever its
        # normal key space was: gate at >= max(min_key, 1), so zero-signal
        # blocks are never promoted just to fill k
        true_ = torch.ones((), dtype=torch.bool, device=dev)
        healthy_col = torch.stack([true_ if h is None else h
                                   for h in healthy])[:, None]
        min_key_col = torch.where(healthy_col, min_key_col,
                                  torch.clamp_min(min_key_col, 1))
    cap_col = _lane_column(caps, torch.int32, dev)[:, 0]

    # -- multi-tenant quotas: every unique key row is masked to int32 min
    #    outside each tenant's own top caps[t] (one segment-capped
    #    hist_select call over the static tenant bounds), so a noisy
    #    tenant cannot crowd a quieter one out of any lane's candidates.
    #    Masked entries fail every lane's value gate (all min_keys >= 0).
    ten = cfg.tenancy
    quotas = ten is not None and ten.caps is not None
    # the hot set is workload truth: under quotas the hmu row is masked,
    # and with faults or staleness it no longer ranks the truth, so it gets
    # its own exact top-K; otherwise the oracle row doubles as it
    own_hot = quotas or faulty or state.stale is not None
    d_true_all = d_true
    if sh is not None:
        # every selection runs on the whole block axis: ONE all-gather of
        # the key rows, and of the truth where a selection ranks it
        n_rows = key_rows.shape[0]
        ranks_true = own_hot or ten is not None
        whole = shd.all_gather(sh, torch.cat([key_rows, d_true[None]])
                               if ranks_true else key_rows)
        key_rows = whole[:n_rows]
        d_true_all = whole[n_rows] if ranks_true else None
    if quotas:
        protected = selectk.segment_top_k_mask(
            key_rows, ten.offsets, ten.caps, layout=state.tenant_caps)
        key_rows = torch.where(protected, key_rows, selectk.INT32_MIN)

    # -- one selection per unique signal (the hist_select kernel on the
    #    card), fanned out to lanes
    vals_u, ids_u, sel_u = selectk.select_top_k(
        key_rows, k, return_mask=True)
    vals = torch.stack([vals_u[r] for r in lane_row])          # (L, k)
    ids = torch.stack([ids_u[r] for r in lane_row])

    # -- account the epoch under the placement that served it
    hot = (selectk.top_k_mask(d_true_all, k) if own_hot
           else sel_u[hmu_row])                    # epoch's true top-K set
    if sh is not None:
        hot = sh.local(hot)
    fast0 = state.placement.fast_mask              # (L, n)
    d_fast = torch.where(fast0, d_true, 0)
    n_fast = torch.sum(d_fast, dim=-1, dtype=torch.int64)
    n_true = torch.sum(d_true, dtype=torch.int64)
    inter = torch.sum(fast0 & hot, dim=-1, dtype=torch.int64)
    resident0 = state.placement.resident()

    # -- decide: ordered top-k ids per lane, gated per lane config.  With
    #    demote hysteresis a resident block must have looked cold for H
    #    epochs in a row before the watermark lane frees its slot.
    demote_enable = reactive
    cold_streak_new = None
    if state.cold_streak is not None:
        cold_streak_new = policy.cold_streak(state.cold_streak, est_lanes,
                                             fast0)
        demote_enable = demote_enable & (
            cold_streak_new >= har.demote_hysteresis)
    pl, pre_demoted = demote_idle(state.placement, est_lanes, demote_enable,
                                  shard=sh)
    free_slots = torch.sum(pl.slot_to_block < 0, dim=-1, dtype=torch.int32)
    cap_eff = torch.where(reactive[:, 0], torch.minimum(cap_col, free_slots),
                          cap_col)
    ok = (vals >= min_key_col) & (
        torch.arange(k, dtype=torch.int32, device=dev)[None, :]
        < cap_eff[:, None])
    want = torch.where(ok, ids, -1)

    # -- migrate: bounded promotion with plan-guarded coldest-victim eviction
    pl, promoted, demoted = apply_plan(pl, want, est_lanes, shard=sh)

    t_parts = []
    if ten is not None:
        # per-tenant accounting: tenant-range sums of the same masks the
        # lane record sums, and each tenant's own true-hot set (the top
        # hot_k[t] of its id range, all tenants in one segment call); only
        # (L, T) counts join the record row
        t_hot = selectk.segment_top_k_mask(
            d_true_all, ten.offsets, ten.hot_k, layout=state.tenant_hot)
        if sh is not None:
            t_hot = sh.local(t_hot)
        fast1 = pl.fast_mask
        lo = 0 if sh is None else sh.lo
        t_parts = [_per_tenant_sum(x, ten.offsets, lo).reshape(-1)
                   for x in (d_fast, d_true - d_fast, fast0 & t_hot, fast0,
                             fast1 & ~fast0, fast0 & ~fast1)]
    if sh is not None:
        # the block-axis sums, whole: ONE integer all-reduce an epoch
        n_fast, n_true, inter, *t_parts = shd.sum_parts(
            sh, [n_fast, n_true, inter, *t_parts])
    parts = [
        torch.stack([drained.value, bundle.pebs.host_events.value,
                     bundle.nb.host_events.value]),
        n_fast, n_true - n_fast, inter, resident0.to(torch.int64),
        promoted.to(torch.int64), (demoted + pre_demoted).to(torch.int64),
    ]
    if har is not None:
        # float32 bits, widened: the int64 row stays one exact transfer
        parts.append(quality_new.view(torch.int32).to(torch.int64))
    parts += t_parts
    # -- this epoch's record row, written in place into the accumulator
    #    (the reference donates the buffer; here the update is in place)
    state.out_buf[out_row] = torch.cat(parts)
    updates = dict(bundle=bundle, placement=pl, pred=pred_new,
                   prev_hmu=hmu_now, prev_pebs=pebs_now,
                   stale_ptr=stale_ptr_new)
    if state.prev_true is not None:
        updates["prev_true"] = true_now
    if har is not None:
        updates.update(quality=quality_new, nb_ewma=nb_ewma_new,
                       prev_nb=prev_nb_new)
    if state.cold_streak is not None:
        updates["cold_streak"] = cold_streak_new
    return dataclasses.replace(state, **updates)


def _check_mesh(mesh, axis: str, device: torch.device):
    """The reference's refusals of a mesh the sharded state cannot use."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh= takes a torch.distributed.device_mesh."
                        f"DeviceMesh (launch.mesh.make_telemetry_mesh), got "
                        f"{type(mesh).__name__}")
    if axis not in (mesh.mesh_dim_names or ()):
        raise TypeError(f"the mesh has no axis {axis!r} (its axes: "
                        f"{mesh.mesh_dim_names}); pass mesh_axis=")
    if mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot hold state on "
                         f"{device}")


class EpochRuntime:
    """Runs all policy lanes over one shared telemetry stream, epoch by
    epoch, on ``device`` (default ``"cuda"``; raises without a CUDA device,
    and runs on the CPU only when given ``device="cpu"``).

    ``step`` consumes one epoch of equal-size batches ``(n_batches,
    batch_size)``; ``run`` drives a whole workload and returns the
    :class:`Trajectory`.  ``hints`` (a
    :class:`repro_torch.hints.HintPipeline`) refreshes the hinted lane's
    ``hint_rank`` and the prefetch lane's ``prefetch_rank`` every epoch;
    ``sync_every=K`` batches the record sync (``step`` then returns the
    epochs it flushed, ``run`` flushes the partial tail, and :meth:`flush`
    drains it after manual stepping).  ``faults`` (a
    :class:`~repro_torch.faults.FaultModel`) degrades the collectors and
    ``hardening`` (a :class:`~repro_torch.faults.Hardening`, or a dict of
    :meth:`Hardening.make`'s keywords) makes the lanes cope; the runtime
    takes a private copy of the model.  ``export`` (a
    :class:`repro_torch.export.ExportClient`) receives every record at the
    record pull.  The kernels run on the card and their plain versions on
    the CPU, by the tensors' device.

    ``fused=True`` (default) keeps all lane state on the device and runs
    decide + migrate + account as :func:`_epoch_step`; ``fused=False`` is
    the reference's per-lane host loop, the bit-identity oracle (it takes
    neither ``sync_every > 1`` nor ``faults`` / ``hardening`` nor a mesh).

    ``mesh`` (a ``DeviceMesh`` of ``device``'s type with an axis named
    ``mesh_axis``: :func:`repro_torch.launch.mesh.make_telemetry_mesh`)
    shards all per-block state over that axis.  Every rank of the axis
    builds its runtime with the same arguments and steps it with the same
    epochs; the records come out the same on every rank, byte-identical to
    the meshless run's.
    """

    def __init__(
        self,
        n_blocks: int,
        k_hot: int,
        policies: Sequence[str] = ALL_POLICIES,
        system: MemSystem = CXL_SYSTEM,
        bytes_per_access: float = 256.0,
        block_bytes: float = 4096.0,
        pebs_period: int = 10007,
        nb_scan_rate: Optional[int] = None,
        hmu_log_capacity: int = 1 << 33,
        ewma_alpha: float = 0.5,
        hint_rank: Optional[np.ndarray] = None,
        hint_weight: float = 0.25,
        reactive_hot_threshold: Optional[int] = None,
        nb_rate_limit: Optional[int] = None,
        hints=None,
        prefetch_overlap: float = 1.0,
        fused: bool = True,
        mesh=None,
        mesh_axis: str = "blocks",
        tenancy=None,
        sync_every: int = 1,
        faults=None,
        hardening=None,
        export=None,
        device="cuda",
    ):
        unknown = set(policies) - set(ALL_POLICIES)
        if unknown:
            raise ValueError(f"unknown policies {sorted(unknown)}; "
                             f"choose from {ALL_POLICIES}")
        if mesh is not None and not fused:
            raise ValueError("mesh sharding requires the fused epoch step "
                             "(the reference path keeps lane state on the "
                             "host); pass fused=True or drop mesh")
        if (faults is not None or hardening is not None) and not fused:
            raise ValueError("fault injection / hardening run inside the "
                             "fused epoch step; the reference path stays "
                             "the fault-free bit-identity oracle — pass "
                             "fused=True or drop faults/hardening")
        if faults is not None and not isinstance(faults, FaultModel):
            raise TypeError(f"faults= takes a repro_torch.faults.FaultModel, "
                            f"got {type(faults).__name__}")
        if hardening is not None and not isinstance(hardening, Hardening):
            if not isinstance(hardening, Mapping):
                raise TypeError(
                    f"hardening= takes a repro_torch.faults.Hardening or a "
                    f"dict of Hardening.make's keywords, got "
                    f"{type(hardening).__name__}")
            hardening = Hardening.make(**dict(hardening))
        if hardening is not None:
            hardening.validate()
        self.device = resolve_device(device)
        if mesh is not None:
            _check_mesh(mesh, mesh_axis, self.device)
        self.sync_every = int(sync_every)
        if self.sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every!r}")
        if self.sync_every > 1 and not fused:
            raise ValueError("sync_every > 1 batches record syncs in the "
                             "fused epoch loop; the reference path stays "
                             "synchronous (it is the bit-identity oracle) — "
                             "pass fused=True or sync_every=1")
        self.fused = bool(fused)
        self.n_blocks = int(n_blocks)
        self.k_hot = min(int(k_hot), self.n_blocks)
        self.tenancy = tenancy
        self.hardening = hardening
        # Optional repro_torch.export client (duck-typed:
        # export_epoch_record).  It sees the records _flush_records has
        # already assembled on the host at the record pull: no launch, no
        # transfer, and the client never raises or blocks.
        self.export = export
        # per-epoch per-tenant raw accounting ((L, T) int64 arrays, lane
        # order = policies); repro_torch.fleet.accounting slices these into
        # TenantRecord rows with the tenants' own cost-model geometry
        self.tenant_records: List[Dict[str, np.ndarray]] = []
        if tenancy is not None:
            # the fused step selects per tenant in one hist_select call,
            # whose segment count is capped on the card
            tenancy.validate(self.n_blocks, self.k_hot, max_segments=(
                hs_kernel.max_segments()
                if self.device.type == "cuda" and self.fused else None))
        self.system = system
        self.bytes_per_access = float(bytes_per_access)
        self.block_bytes = float(block_bytes)
        self.ewma_alpha = float(ewma_alpha)
        self.hint_rank = (np.zeros((n_blocks,), np.float32)
                          if hint_rank is None
                          else np.asarray(hint_rank, np.float32))
        self.prefetch_rank = np.zeros((n_blocks,), np.float32)
        self.hint_weight = float(hint_weight)
        self.reactive_hot_threshold = reactive_hot_threshold
        self.nb_rate_limit = nb_rate_limit
        self.hints = hints
        self.prefetch_overlap = float(prefetch_overlap)
        if not 0.0 <= self.prefetch_overlap <= 1.0:
            raise ValueError(f"prefetch_overlap must be in [0, 1], "
                             f"got {prefetch_overlap!r}")
        self._prefetch_pending = 0          # blocks moved at the last boundary
        scan = (nb_scan_rate if nb_scan_rate is not None
                else max(n_blocks // 16, 1))
        self._lane_names = tuple(policies)
        self.epoch = 0
        self.records: Dict[str, List[EpochRecord]] = {n: [] for n in policies}
        self._prev_pebs_host = 0.0
        self._prev_nb_host = 0.0
        self._buffered = 0          # dispatched epochs not yet record-synced
        self._n_tenants = 0 if tenancy is None else tenancy.n_tenants
        # the rank's block range under a mesh (None: the whole axis here)
        self._shard = (None if mesh is None else
                       shd.from_mesh(mesh, mesh_axis, self.n_blocks))
        bundle = tel.bundle_init(
            n_blocks, pebs_period=pebs_period, nb_scan_rate=scan,
            hmu_log_capacity=hmu_log_capacity, faults=faults,
            shard=self._shard, device=self.device)
        if not self.fused:
            self.bundle = bundle
            self._ref_lanes = {
                name: _Lane(
                    name=name,
                    slot_to_block=np.full((self.k_hot,), -1, np.int32),
                    block_to_slot=np.full((self.n_blocks,), -1, np.int32),
                    pred=(np.zeros((self.n_blocks,), np.float32)
                          if name == "proactive_ewma" else None))
                for name in policies}
            # epoch-delta baselines (host copies)
            self._prev_true = np.zeros((self.n_blocks,), np.int64)
            self._prev_hmu = np.zeros((self.n_blocks,), np.int64)
            self._prev_pebs = np.zeros((self.n_blocks,), np.int64)
            return
        L = len(self._lane_names)
        self._cfg = _FusedCfg(
            lanes=self._lane_names, n_blocks=self.n_blocks, k_hot=self.k_hot,
            ewma_alpha=self.ewma_alpha, hint_weight=self.hint_weight,
            nb_rate_limit=self.nb_rate_limit,
            reactive_hot_threshold=self.reactive_hot_threshold,
            tenancy=tenancy, hardening=hardening, shard=self._shard)
        dev = self.device
        # per-block leaves hold the rank's range under a mesh
        n_here = self.n_blocks if self._shard is None else self._shard.n_local

        def zeros_n():
            return torch.zeros((n_here,), dtype=torch.int32, device=dev)

        # robustness leaves exist only when their subsystem is on
        # (reference runtime.py:944-965)
        extra = {}
        if faults is not None:
            extra["prev_true"] = zeros_n()
            if faults.stale_epochs > 0:
                extra["stale"] = torch.zeros(
                    (faults.stale_epochs + 1, 3, n_here),
                    dtype=torch.int32, device=dev)
        if hardening is not None:
            extra["quality"] = torch.ones((3,), dtype=torch.float32,
                                          device=dev)
            extra["nb_ewma"] = torch.zeros((), dtype=torch.float32,
                                           device=dev)
            extra["prev_nb"] = zeros_n()
            if hardening.demote_hysteresis > 1:
                extra["cold_streak"] = torch.zeros(
                    (L, n_here), dtype=torch.int32, device=dev)
        t_hot = t_caps = None
        if tenancy is not None:
            t_hot = selectk.segment_layout(tenancy.offsets, tenancy.hot_k,
                                           dev)
            if tenancy.caps is not None:
                t_caps = t_hot.with_caps(tenancy.caps)
        self._state = _FusedState(
            bundle=bundle,
            placement=Placement.create(n_here, self.k_hot, lanes=L,
                                       device=dev),
            pred=torch.zeros((n_here,), dtype=torch.float32, device=dev),
            hint_rank=self._upload_blocks(self.hint_rank),
            prefetch_rank=self._upload_blocks(self.prefetch_rank),
            prev_hmu=zeros_n(), prev_pebs=zeros_n(),
            out_buf=_out_buf_init(self.sync_every, L, self._n_tenants, dev,
                                  quality=hardening is not None),
            tenant_hot=t_hot, tenant_caps=t_caps, **extra,
        )

    # ---------------------------------------------------------- constructors
    @classmethod
    def for_scenario(cls, scenario, *, policies: Sequence[str] = ALL_POLICIES,
                     hints=None, prefetch_overlap: float = 1.0,
                     fused: bool = True, mesh=None,
                     mesh_axis: str = "blocks",
                     **overrides) -> "EpochRuntime":
        """Build a runtime from an access scenario's geometry and cost-model
        parameters; ``overrides`` replace any constructor kwarg."""
        kw = dict(
            policies=policies,
            system=scenario.system,
            bytes_per_access=scenario.bytes_per_access,
            block_bytes=scenario.block_bytes,
            pebs_period=scenario.pebs_period,
            nb_scan_rate=scenario.nb_scan_rate,
            hints=hints, prefetch_overlap=prefetch_overlap,
            fused=fused, mesh=mesh, mesh_axis=mesh_axis,
            tenancy=getattr(scenario, "tenancy", None),
        )
        kw.update(overrides)
        return cls(scenario.n_blocks, scenario.k_hot, **kw)

    # ------------------------------------------------------- state accessors
    def _upload_blocks(self, x: np.ndarray) -> torch.Tensor:
        """A host per-block array onto the device: the rank's range of it
        under a mesh."""
        if self._shard is not None:
            x = self._shard.local(x)
        return upload(x, self.device)

    def _whole(self, x: torch.Tensor) -> torch.Tensor:
        """A per-block device leaf over the whole block axis (an all-gather
        under a mesh: every rank of the axis must call it)."""
        return x if self._shard is None else shd.all_gather(self._shard, x)

    @property
    def lanes(self) -> Dict[str, _Lane]:
        """Per-lane placement view (host copies in fused mode, read from the
        device; the live host state on the reference path).  Under a mesh
        it gathers the whole block axis, so every rank must read it."""
        if not self.fused:
            return self._ref_lanes
        s2b = self._state.placement.slot_to_block.cpu().numpy()
        b2s = self._whole(self._state.placement.block_to_slot).cpu().numpy()
        pred = self._whole(self._state.pred).cpu().numpy()
        return {
            name: _Lane(name=name, slot_to_block=s2b[i], block_to_slot=b2s[i],
                        pred=pred if name == "proactive_ewma" else None)
            for i, name in enumerate(self._lane_names)
        }

    @property
    def pending_migration_s(self) -> float:
        """Migration time of the prefetch lane's last boundary, not yet
        charged to any record (flushes the record buffer first)."""
        if self.fused:
            self._flush_records()
        return self.system.migration_time_s(self._prefetch_pending,
                                            self.block_bytes)

    # ----------------------------------------------------------- hint refresh
    def set_hint_ranks(self, hint_rank: Optional[np.ndarray] = None,
                       prefetch_rank: Optional[np.ndarray] = None) -> None:
        """Replace the hint arrays the next epoch step reads — on the fused
        path a pinned, non-blocking host->device upload; the reference path
        keeps the host arrays.  Counted in
        ``DISPATCH_COUNTS['hint_refresh']``.  An array that is the SAME
        object as the current one is skipped, as in the reference."""
        updates = {}
        if hint_rank is not None and hint_rank is not self.hint_rank:
            self.hint_rank = np.asarray(hint_rank, np.float32)
            updates["hint_rank"] = self.hint_rank
        if prefetch_rank is not None and prefetch_rank is not self.prefetch_rank:
            self.prefetch_rank = np.asarray(prefetch_rank, np.float32)
            updates["prefetch_rank"] = self.prefetch_rank
        if updates:
            DISPATCH_COUNTS["hint_refresh"] += 1
        if self.fused and updates:
            _tr = obs_trace.get_tracer()
            cm = (_tr.span("hint_refresh", epoch=self.epoch,
                           arrays=",".join(sorted(updates)))
                  if _tr.enabled else obs_trace.NOOP_SPAN)
            with cm:
                self._state = dataclasses.replace(
                    self._state,
                    **{k: self._upload_blocks(v) for k, v in updates.items()})

    # ---------------------------------------------------------------- step
    def step(self, batches, lookahead: Sequence = ()):
        """Consume one epoch ``(n_batches, batch_size)``: observe, then
        decide/migrate/account every lane.  With ``sync_every=1`` returns
        this epoch's records; else the epochs a full buffer flushed."""
        batches = np.ascontiguousarray(np.asarray(batches, np.int32))
        if batches.ndim != 2:
            raise ValueError(f"epoch batches must be 2-D, got {batches.shape}")
        if self.hints is not None:
            self.set_hint_ranks(*self.hints.epoch_ranks(batches, lookahead))
        if self.fused:
            return self._step_fused(batches)
        return self._step_reference(batches)

    def _record(self, name: str, epoch: int, n_fast: float, n_slow: float,
                host_events: float, promoted: int, demoted: int,
                resident: int, inter: int,
                quality: float = 1.0) -> EpochRecord:
        """Epoch accounting (host float64 scalar math, as the reference)."""
        access_s = self.system.access_time_s(
            n_fast, n_slow, self.bytes_per_access)
        per_event = (NB_FAULT_COST_S if name == "nb_two_touch" else
                     PEBS_SAMPLE_COST_S if name == "hinted" else
                     0.0 if name == "prefetch" else
                     HMU_DRAIN_COST_S)
        host_tax_s = host_events * per_event
        hidden_s = 0.0
        if name == "prefetch":
            # the migration charged here is the one issued at the PREVIOUS
            # boundary; it streamed under this epoch's accesses
            moved = self._prefetch_pending
            self._prefetch_pending = promoted + demoted
            migration_s = self.system.migration_time_s(moved, self.block_bytes)
            hidden_s = self.system.migration_overlap_s(
                n_slow, self.bytes_per_access, moved, self.block_bytes,
                self.prefetch_overlap)
        else:
            migration_s = self.system.migration_time_s(
                promoted + demoted, self.block_bytes)
        return EpochRecord(
            epoch=epoch, lane=name,
            time_s=access_s + host_tax_s + migration_s - hidden_s,
            access_s=access_s, host_tax_s=host_tax_s, migration_s=migration_s,
            accuracy=(inter / resident) if resident else 0.0,
            coverage=(inter / self.k_hot) if self.k_hot else 0.0,
            resident=resident, promoted=promoted, demoted=demoted,
            host_events=host_events, hidden_s=hidden_s, quality=quality,
        )

    def _step_fused(self, batches: np.ndarray):
        state = self._state
        # spans are attribution only: tracing off uses the shared no-op
        # context manager (no allocation), tracing on wraps the very same
        # launches
        _tr = obs_trace.get_tracer()
        DISPATCH_COUNTS["observe_all"] += 1
        cm = (_tr.span("observe_all", epoch=self.epoch)
              if _tr.enabled else obs_trace.NOOP_SPAN)
        with cm:
            bundle = tel.observe_all(state.bundle,
                                     upload(batches, self.device))
        state = dataclasses.replace(state, bundle=bundle)
        # this epoch's observe_all is already queued when a full buffer
        # forces the previous K epochs' record pull
        flushed: Dict[str, List[EpochRecord]] = {}
        if self._buffered >= self.sync_every:
            flushed = self._flush_records()
        # static PEBS-positives bound, quantized to the next power of two
        bound = int(batches.size) // state.bundle.pebs.period + 2
        s_max = min(self.n_blocks, 1 << (bound - 1).bit_length())
        DISPATCH_COUNTS["epoch_step"] += 1
        cm = (_tr.span("epoch_step", epoch=self.epoch)
              if _tr.enabled else obs_trace.NOOP_SPAN)
        with cm:
            self._state = _epoch_step(state, int(batches.size),
                                      self._buffered, cfg=self._cfg,
                                      s_max=s_max)
        self.epoch += 1
        self._buffered += 1
        if self.sync_every == 1:
            flushed = self._flush_records()   # synchronous loop: pull now
            return {name: recs[0] for name, recs in flushed.items()}
        return flushed

    def _flush_records(self) -> Dict[str, List[EpochRecord]]:
        """Pull the buffered epochs' record rows in ONE device->host
        transfer and assemble their :class:`EpochRecord`\\ s in dispatch
        order — the loop's only sync."""
        n_buf = self._buffered
        if n_buf == 0:
            return {}
        base = self.epoch - n_buf
        DISPATCH_COUNTS["record_sync"] += 1
        _tr = obs_trace.get_tracer()
        cm = (_tr.span("record_sync", epoch_base=base, n_epochs=n_buf)
              if _tr.enabled else obs_trace.NOOP_SPAN)
        with cm, sync_allowed(self.device):
            host = self._state.out_buf.cpu().numpy()
        L, T = len(self._lane_names), self._n_tenants
        cols = _out_columns(L, T, quality=self.hardening is not None)
        flushed: Dict[str, List[EpochRecord]] = {
            name: [] for name in self._lane_names}
        for j in range(n_buf):                 # rows beyond n_buf are stale
            row = host[j]
            pebs_host = float(row[cols["pebs_host"]])
            nb_host = float(row[cols["nb_host"]])
            d_pebs_host = pebs_host - self._prev_pebs_host
            d_nb_host = nb_host - self._prev_nb_host
            self._prev_pebs_host, self._prev_nb_host = pebs_host, nb_host
            drained = float(row[cols["drained"]])
            if T:
                # copies: on the CPU ``host`` is the live buffer itself
                self.tenant_records.append({
                    f: np.array(row[cols["tenant:" + f]].reshape(L, T))
                    for f in _OUT_LANE_FIELDS})
            lane_vals = {f: row[cols[f]] for f in _OUT_LANE_FIELDS}
            qual = (row[cols["quality"]].astype(np.int32).view(np.float32)
                    if "quality" in cols else None)
            for i, name in enumerate(self._lane_names):
                host_events = (d_nb_host if name == "nb_two_touch" else
                               d_pebs_host if name == "hinted" else
                               0.0 if name == "prefetch" else drained)
                col = LANE_COLLECTOR[name]
                quality = (float(qual[COLLECTORS.index(col)])
                           if qual is not None and col is not None else 1.0)
                rec = self._record(
                    name, epoch=base + j, quality=quality,
                    n_fast=float(lane_vals["n_fast"][i]),
                    n_slow=float(lane_vals["n_slow"][i]),
                    host_events=host_events,
                    promoted=int(lane_vals["promoted"][i]),
                    demoted=int(lane_vals["demoted"][i]),
                    resident=int(lane_vals["resident"][i]),
                    inter=int(lane_vals["inter"][i]),
                )
                self.records[name].append(rec)
                flushed[name].append(rec)
                if self.export is not None:
                    self.export.export_epoch_record(rec)
        self._buffered = 0
        return flushed

    def flush(self) -> Dict[str, List[EpochRecord]]:
        """Force the record pull for any still-buffered epochs (a no-op on
        the reference path and on an empty buffer)."""
        return self._flush_records()

    def block_until_ready(self) -> "EpochRuntime":
        """Wait until every launch queued on the device has finished (the
        stopping point for wall-clock timers; records may already be pulled
        while the last epoch's state updates are in flight)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self

    # ------------------------------------------------ the reference path
    def _upload(self, x: np.ndarray, dtype) -> torch.Tensor:
        return upload(np.asarray(x, dtype), self.device)

    def _apply_plan(self, lane: _Lane, plan: policy.MigrationPlan,
                    est: np.ndarray) -> Tuple[int, int]:
        """Promote the plan into the lane's bounded fast tier; evict
        plan-guarded coldest victims when no slots are free.  Returns
        (promoted, demoted) block counts."""
        want = _unique_in_order(plan.promote.cpu().numpy(), self.k_hot)
        if want.size == 0:
            return 0, 0
        new = want[lane.block_to_slot[want] < 0]
        if new.size == 0:
            return 0, 0
        free = np.nonzero(lane.slot_to_block < 0)[0]
        demoted = 0
        need = new.size - free.size
        if need > 0:
            DISPATCH_COUNTS["reference"] += 1
            vic = policy.plan_eviction(
                self._upload(est, np.float32), self._upload(want, np.int32),
                self._upload(lane.slot_to_block, np.int32),
                int(need)).cpu().numpy()
            vic = vic[vic >= 0]
            if vic.size:
                slots = lane.block_to_slot[vic]
                lane.slot_to_block[slots] = -1
                lane.block_to_slot[vic] = -1
                demoted = int(vic.size)
            free = np.nonzero(lane.slot_to_block < 0)[0]
        take = int(min(new.size, free.size))
        if take:
            sel, slots = new[:take], free[:take]
            lane.slot_to_block[slots] = sel
            lane.block_to_slot[sel] = slots
        return take, demoted

    def _demote_untouched(self, lane: _Lane, est: np.ndarray) -> int:
        """Watermark demotion: free every resident block the epoch never
        touched (est == 0) so reactive promotion has slots."""
        resident = lane.resident_ids()
        idle = resident[est[resident] == 0]
        if idle.size:
            slots = lane.block_to_slot[idle]
            lane.slot_to_block[slots] = -1
            lane.block_to_slot[idle] = -1
        return int(idle.size)

    def _reactive_threshold(self, epoch_accesses: int) -> int:
        if self.reactive_hot_threshold is not None:
            return self.reactive_hot_threshold
        return max(2, epoch_accesses // (8 * max(self.k_hot, 1)))

    def _plan_quota(self, lane: _Lane, d_hmu: np.ndarray, d_pebs: np.ndarray,
                    nb_faults: np.ndarray, epoch_accesses: int,
                    ) -> Tuple[policy.MigrationPlan, np.ndarray, int]:
        """Decide under per-tenant quotas: the lane's key is protected per
        tenant (each tenant's top ``caps[t]`` keys survive, ties lowest
        index first) and masked to int32 min elsewhere, then the lane's
        gates run on the globally ordered masked selection — numpy stable
        sorts, the spec of the fused segment-capped select.  Float keys are
        the float32 bit patterns the device ranks."""
        ten, k, n = self.tenancy, self.k_hot, self.n_blocks
        pre_demoted = 0
        DISPATCH_COUNTS["reference"] += 1

        def f32_key(x: np.ndarray) -> np.ndarray:
            return np.ascontiguousarray(
                np.asarray(x, np.float32)).view(np.int32)

        cap = k
        if lane.name == "hmu_oracle":
            est, key, min_key = d_hmu, d_hmu, 1
        elif lane.name == "nb_two_touch":
            est, key, min_key = nb_faults, nb_faults, 2
            if self.nb_rate_limit is not None:
                cap = min(k, self.nb_rate_limit)
        elif lane.name == "reactive_watermark":
            est, key = d_hmu, d_hmu
            pre_demoted = self._demote_untouched(lane, est)
            cap = min(k, int(np.sum(lane.slot_to_block < 0)))
            min_key = self._reactive_threshold(epoch_accesses)
        elif lane.name == "proactive_ewma":
            lane.pred = policy.ewma_eager(
                self.ewma_alpha, self._upload(d_hmu, np.float32),
                self._upload(lane.pred, np.float32)).cpu().numpy()
            est, key, min_key = lane.pred, f32_key(lane.pred), 1
        elif lane.name == "hinted":
            est = d_pebs
            est_t = self._upload(est, np.int32)
            score = policy.hinted_score_eager(
                est_t, policy.stable_rank(est_t),
                self._upload(self.hint_rank, np.float32), self.hint_weight)
            key, min_key = f32_key(score.cpu().numpy()), 0
        elif lane.name == "prefetch":
            est = self.prefetch_rank
            key, min_key = f32_key(est), 1
        else:  # pragma: no cover - guarded in __init__
            raise ValueError(lane.name)

        key = np.asarray(key, np.int64)
        protected = np.zeros((n,), bool)
        for t, tcap in enumerate(ten.caps):
            off, end = ten.offsets[t], ten.offsets[t + 1]
            order = np.argsort(-key[off:end], kind="stable")
            protected[off + order[:tcap]] = True
        masked = np.where(protected, key, np.iinfo(np.int32).min)
        ids = np.argsort(-masked, kind="stable")[:k]
        ok = (masked[ids] >= min_key) & (np.arange(ids.size) < cap)
        plan = policy.MigrationPlan(promote=torch.from_numpy(
            np.where(ok, ids, -1)))
        return plan, np.asarray(est), pre_demoted

    def _plan(self, lane: _Lane, d_hmu: np.ndarray, d_pebs: np.ndarray,
              nb_faults: np.ndarray, epoch_accesses: int,
              ) -> Tuple[policy.MigrationPlan, np.ndarray, int]:
        """One lane's decide step -> (plan, estimate, pre-demotions): one
        eager policy call on the device (one ``hist_select`` launch on the
        card), or the quota path's numpy selection."""
        if self.tenancy is not None and self.tenancy.caps is not None:
            return self._plan_quota(lane, d_hmu, d_pebs, nb_faults,
                                    epoch_accesses)
        k = self.k_hot
        pre_demoted = 0
        DISPATCH_COUNTS["reference"] += 1
        if lane.name == "hmu_oracle":
            est = d_hmu
            plan = policy.oracle_top_k(self._upload(est, np.int32), k)
        elif lane.name == "nb_two_touch":
            est = nb_faults
            plan = policy.nb_two_touch(self._upload(est, np.int32), k,
                                       self.nb_rate_limit)
        elif lane.name == "reactive_watermark":
            est = d_hmu
            pre_demoted = self._demote_untouched(lane, est)
            free = int(np.sum(lane.slot_to_block < 0))
            plan = policy.reactive_watermark(
                self._upload(est, np.int32),
                self._reactive_threshold(epoch_accesses), free, max_moves=k)
        elif lane.name == "proactive_ewma":
            pred, plan = policy.proactive_ewma(
                self._upload(lane.pred, np.float32),
                self._upload(d_hmu, np.float32), k, alpha=self.ewma_alpha)
            lane.pred = pred.cpu().numpy()
            est = lane.pred
        elif lane.name == "hinted":
            est = d_pebs
            plan = policy.hinted(self._upload(est, np.int32),
                                 self._upload(self.hint_rank, np.float32), k,
                                 hint_weight=self.hint_weight)
        elif lane.name == "prefetch":
            est = self.prefetch_rank
            plan = policy.prefetch(self._upload(est, np.float32), k)
        else:  # pragma: no cover - guarded in __init__
            raise ValueError(lane.name)
        return plan, np.asarray(est), pre_demoted

    def _step_reference(self, batches: np.ndarray) -> Dict[str, EpochRecord]:
        _tr = obs_trace.get_tracer()
        cm = (_tr.span("reference_step", epoch=self.epoch)
              if _tr.enabled else obs_trace.NOOP_SPAN)
        with cm:
            return self._step_reference_impl(batches)

    def _step_reference_impl(self, batches: np.ndarray
                             ) -> Dict[str, EpochRecord]:
        epoch_accesses = int(batches.size)

        # -- observe (one observe_scatter launch a batch) + drain the HMU log
        DISPATCH_COUNTS["observe_all"] += 1
        self.bundle = tel.observe_all(self.bundle,
                                      upload(batches, self.device))
        drained = float(self.bundle.hmu.log_used)
        self.bundle = dataclasses.replace(
            self.bundle, hmu=tel.hmu_drain_cost(self.bundle.hmu))

        # -- epoch-local estimates (four full-array pulls per epoch)
        DISPATCH_COUNTS["reference"] += 4

        def pull(x: torch.Tensor) -> np.ndarray:
            return x.cpu().numpy().astype(np.int64)

        true_now = pull(self.bundle.true_counts)
        hmu_now = pull(tel.hmu_estimate(self.bundle.hmu))
        pebs_now = pull(tel.pebs_estimate(self.bundle.pebs))
        d_true = true_now - self._prev_true
        d_hmu = hmu_now - self._prev_hmu
        d_pebs = pebs_now - self._prev_pebs
        nb_faults = pull(tel.nb_estimate(self.bundle.nb))
        pebs_host = float(self.bundle.pebs.host_events)
        nb_host = float(self.bundle.nb.host_events)
        d_pebs_host = pebs_host - self._prev_pebs_host
        d_nb_host = nb_host - self._prev_nb_host
        self._prev_true, self._prev_hmu = true_now, hmu_now
        self._prev_pebs = pebs_now
        self._prev_pebs_host, self._prev_nb_host = pebs_host, nb_host

        epoch_hot = metrics.true_top_k(d_true, self.k_hot)
        ten = self.tenancy
        if ten is not None:
            # per-tenant true-hot mask: top hot_k[t] of each tenant's range
            # (the fused step's stable tie-break)
            t_hot_mask = np.zeros((self.n_blocks,), bool)
            for t in range(ten.n_tenants):
                off, end = ten.offsets[t], ten.offsets[t + 1]
                t_hot_mask[off + metrics.true_top_k(d_true[off:end],
                                                    ten.hot_k[t])] = True
            t_rows = {key: [] for key in _OUT_LANE_FIELDS}
        out: Dict[str, EpochRecord] = {}
        for lane in self._ref_lanes.values():
            # -- account the epoch under the placement that served it
            served = lane.resident_ids().copy()
            fast_before = lane.fast_mask.copy()
            n_fast, n_slow = split_accesses_by_tier(d_true, fast_before)
            host_events = (d_nb_host if lane.name == "nb_two_touch" else
                           d_pebs_host if lane.name == "hinted" else
                           0.0 if lane.name == "prefetch" else drained)

            # -- decide + migrate for the NEXT epoch
            plan, est, pre_demoted = self._plan(
                lane, d_hmu, d_pebs, nb_faults, epoch_accesses)
            promoted, demoted = self._apply_plan(lane, plan, est)
            inter = int(np.intersect1d(served, epoch_hot).size)
            if ten is not None:
                fast_after = lane.fast_mask
                lane_masks = {
                    "n_fast": np.where(fast_before, d_true, 0),
                    "n_slow": np.where(fast_before, 0, d_true),
                    "inter": fast_before & t_hot_mask,
                    "resident": fast_before,
                    "promoted": fast_after & ~fast_before,
                    "demoted": fast_before & ~fast_after,
                }
                for key, arr in lane_masks.items():
                    t_rows[key].append(np.array([
                        int(arr[ten.offsets[t]:ten.offsets[t + 1]].sum())
                        for t in range(ten.n_tenants)], np.int64))
            rec = self._record(
                lane.name, epoch=self.epoch, n_fast=n_fast, n_slow=n_slow,
                host_events=host_events, promoted=promoted,
                demoted=demoted + pre_demoted,
                resident=int(served.size), inter=inter,
            )
            self.records[lane.name].append(rec)
            out[lane.name] = rec
            if self.export is not None:
                self.export.export_epoch_record(rec)
        if ten is not None:
            self.tenant_records.append(
                {key: np.stack(rows) for key, rows in t_rows.items()})
        self.epoch += 1
        return out

    # ----------------------------------------------------------------- run
    def run(self, epochs: Iterable) -> Trajectory:
        """Drive a whole epoch stream.  With a hint pipeline attached, the
        stream is buffered by the pipeline's lookahead depth so each
        ``step`` sees the queued next epochs.  Returns only this stream's
        records."""
        self._flush_records()
        self._prefetch_pending = 0
        starts = {name: len(recs) for name, recs in self.records.items()}
        depth = self.hints.lookahead_depth if self.hints is not None else 0
        it = iter(epochs)
        buf: deque = deque()                # current epoch + queued lookahead
        try:
            while True:
                if not buf:
                    buf.extend(itertools.islice(it, 1))
                    if not buf:
                        break
                batches = buf.popleft()
                buf.extend(itertools.islice(it, depth - len(buf)))
                self.step(batches, lookahead=tuple(buf))
        finally:
            # the partial tail lands even when a run dies mid-stream
            self._flush_records()
        return Trajectory(n_blocks=self.n_blocks, k_hot=self.k_hot,
                          records={name: recs[starts[name]:]
                                   for name, recs in self.records.items()})
