"""AccessScenario protocol + the workload-agnostic online driver (PyTorch
port of ``repro/scenarios/base.py``).

A scenario is everything the :class:`~repro_torch.core.runtime.EpochRuntime` needs
to place one workload online, and nothing about *how* the runtime does it:

* **epoch stream** — ``epochs()`` yields ``(n_batches, batch_size)`` int32
  block-index arrays, deterministic per call (so a fused run and its
  reference-path bit-identity check replay the same stream);
* **page geometry** — ``n_blocks`` blocks, ``k_hot`` fast slots,
  ``bytes_per_access`` / ``block_bytes`` sizes;
* **cost-model params** — the :class:`~repro_torch.core.costmodel.MemSystem` plus
  collector rates (``pebs_period``, ``nb_scan_rate``);
* **optional hint layout** — ``hint_layout()`` returns what a compiler knows
  statically (:class:`~repro_torch.hints.HintLayout`), or ``None`` when hotness is
  runtime-only.

:func:`run_scenario` is the one packaging of the six-lane runtime: build via
:meth:`EpochRuntime.for_scenario`, drive the stream, summarize the
trajectory.  Every scenario inherits the runtime's invariants — one
observe_all and one epoch step per epoch, one record pull per
``sync_every`` epochs — because the runtime never learns which workload it
is placing.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from ..core.costmodel import MemSystem
from ..core.runtime import ALL_POLICIES, EpochRuntime, Trajectory
from ..hints import HintLayout, HintPipeline

__all__ = ["AccessScenario", "build_hints", "run_scenario",
           "scenario_summary"]


@runtime_checkable
class AccessScenario(Protocol):
    """Structural contract every workload packaging satisfies (duck-typed —
    scenarios don't inherit anything)."""

    name: str                   # row key in benchmarks / trajectory meta
    n_blocks: int               # blocks the placement ranges over
    k_hot: int                  # fast-tier capacity in blocks
    shift_at: int               # epoch the workload shifts (summary slicing)
    system: MemSystem           # two-tier cost model
    bytes_per_access: float     # bytes one access stream element touches
    block_bytes: float          # bytes one migration moves
    pebs_period: int            # PEBS collector sampling period
    nb_scan_rate: int           # NB scanner unmap rate (blocks/batch)

    def epochs(self) -> Iterable[np.ndarray]:
        """Fresh, deterministic epoch stream of (n_batches, batch) arrays."""
        ...

    def hint_layout(self) -> Optional[HintLayout]:
        """Static structure a compiler would know, or None if runtime-only."""
        ...


def build_hints(scenario: AccessScenario, depth: int = 1,
                clip_rank: Optional[int] = None,
                detector: bool = True) -> HintPipeline:
    """The scenario's default :class:`HintPipeline` — fresh per call, since
    pipelines are stateful (phase-detector EWMA, cached scaled ranks).

    A scenario may provide its own ``build_pipeline(depth=, clip_rank=,
    detector=)`` factory, which then wins over the single-layout default
    (the reference's fleet scenario composes per-tenant hints this way)."""
    build = getattr(scenario, "build_pipeline", None)
    if build is not None:
        return build(depth=depth, clip_rank=clip_rank, detector=detector)
    layout = scenario.hint_layout()
    if layout is None:
        layout = HintLayout(scenario.n_blocks)
    return HintPipeline.for_scenario(layout, depth=depth,
                                     clip_rank=clip_rank, detector=detector)


def scenario_summary(rt: EpochRuntime, traj: Trajectory,
                     policies: Sequence[str], shift_at: int) -> dict:
    """Headline per-lane numbers from a trajectory (the same columns for
    every workload, so scenarios are comparable row-for-row).

    Per-lane dicts are the reference's ``lane_summary`` fields; the
    cross-lane aggregates (``proactive_vs_nb_post_shift``, ...) sit beside
    them at the top level."""
    summary: Dict[str, object] = {}
    for name in policies:
        ts = traj.times(name)
        recs = traj.lane(name)
        accs = np.array([r.accuracy for r in recs])
        covs = np.array([r.coverage for r in recs])
        post = slice(shift_at, None)
        summary[name] = {
            "mean_time_us": float(ts.mean() * 1e6),
            "post_shift_mean_time_us": float(ts[post].mean() * 1e6),
            "final_accuracy": float(accs[-1]),
            "final_coverage": float(covs[-1]),
            "post_shift_mean_coverage": float(covs[post].mean()),
            "post_shift_recovery_epochs": int(np.argmax(
                accs[post] >= 0.5)) if (accs[post] >= 0.5).any() else -1,
            "hidden_total_s": float(sum(r.hidden_s for r in recs)),
        }
        if name == "prefetch":
            # the final boundary's migration overlaps an epoch that never
            # runs; report it so lane-total comparisons stay honest
            summary[name]["pending_migration_us"] = float(
                rt.pending_migration_s * 1e6)
    if "proactive_ewma" in policies and "nb_two_touch" in policies:
        summary["proactive_vs_nb_post_shift"] = float(
            summary["nb_two_touch"]["post_shift_mean_time_us"]
            / summary["proactive_ewma"]["post_shift_mean_time_us"])
    if "prefetch" in policies and "hinted" in policies:
        summary["prefetch_vs_hinted_post_shift_coverage"] = (
            summary["prefetch"]["post_shift_mean_coverage"]
            - summary["hinted"]["post_shift_mean_coverage"])
    return summary


def run_scenario(
    scenario: AccessScenario,
    policies: Sequence[str] = ALL_POLICIES,
    hints=False,
    lookahead_depth: int = 1,
    prefetch_overlap: float = 1.0,
    fused: bool = True,
    mesh=None,
    mesh_axis: str = "blocks",
    sync_every: int = 1,
    epochs: Optional[Iterable[np.ndarray]] = None,
    faults=None,
    hardening=None,
    export=None,
    device="cuda",
    **runtime_overrides,
) -> dict:
    """Place one scenario online: all ``policies`` lanes over the scenario's
    epoch stream, through one :class:`EpochRuntime` built from its geometry,
    on ``device`` (default ``"cuda"``: raises without a CUDA device; pass
    ``device="cpu"`` for the plain versions on the CPU).

    ``hints=True`` attaches the scenario's default pipeline
    (:func:`build_hints`); a pre-built pipeline may be passed instead (it
    is stateful — never share one across runs that must match).
    ``epochs`` replaces the scenario's own stream — pass a pre-materialized
    list when timing the run, so data generation stays outside the
    measurement.  ``sync_every=K`` pulls the records once every K epochs;
    trajectories are bit-identical for every K.  Extra keyword arguments
    override runtime constructor kwargs (``ewma_alpha=``).

    ``faults=`` (a :class:`~repro_torch.faults.FaultModel`) degrades the
    collectors on the device and ``hardening=`` (a
    :class:`~repro_torch.faults.Hardening` or a dict of its ``make``
    keywords) turns on the quality-gated fallback and demotion hysteresis;
    both draw and decide exactly as the reference does, so a degraded
    trajectory is byte-identical to the reference's, and a neutral
    ``FaultModel.create()`` to ``faults=None``.

    ``export=`` attaches a :class:`repro_torch.export.ExportClient`:
    per-epoch records stream out at the runtime's record pull and each
    lane's summary is emitted as a ``lane_summary`` record on completion,
    all tagged with the scenario's name.  Export is observability-only —
    trajectories are byte-identical export-on vs export-off and the epoch's
    launches and pulls are unchanged.

    ``fused=False`` runs the per-lane reference path (the bit-identity
    oracle; ``sync_every`` 1, no faults).  ``mesh`` (see
    :func:`repro_torch.launch.mesh.make_telemetry_mesh`) shards all
    per-block state over its ``mesh_axis``: every rank of the mesh calls
    this with the same arguments and gets the meshless run's result.

    Returns ``{"trajectory": per-epoch dict, "summary": headline numbers}``.
    """
    if hints is True:
        hints = build_hints(scenario, depth=lookahead_depth)
    exp = export.bind(scenario=scenario.name) if export is not None else None
    rt = EpochRuntime.for_scenario(
        scenario, policies=tuple(policies), hints=hints or None,
        prefetch_overlap=prefetch_overlap, fused=fused, mesh=mesh,
        mesh_axis=mesh_axis, sync_every=sync_every, faults=faults, hardening=hardening,
        export=exp, device=device, **runtime_overrides)
    traj = rt.run(scenario.epochs() if epochs is None else epochs)
    summary = scenario_summary(rt, traj, policies, scenario.shift_at)
    if exp is not None:
        for name in policies:
            exp.export_lane_summary(name, summary[name])
    return {
        "trajectory": json.loads(traj.to_json(scenario=scenario.name,
                                              shift_at=scenario.shift_at)),
        "summary": summary,
    }
