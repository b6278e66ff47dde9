"""DLRM embedding-table scenario — the paper's §III.B workload, online
(PyTorch port of ``repro/scenarios/dlrm.py``).

The phase-shifting Zipf page trace (:mod:`repro_torch.dlrm.datagen`) packaged as
an :class:`~repro_torch.scenarios.AccessScenario`: blocks are embedding-table
pages, the hot set rotates once at ``shift_at``, and the compiler's static
knowledge is the table layout (popularity rank -> page id) plus the row-level
Zipf prior — the :class:`~repro_torch.hints.HintLayout` the hinted lane's static
provider analyses.

:func:`run_online` keeps the reference's ``run_online`` signature as a thin
wrapper over :func:`~repro_torch.scenarios.run_scenario`.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from ..core.costmodel import CXL_SYSTEM, MemSystem
from ..core.runtime import ALL_POLICIES
from ..dlrm import datagen
from ..hints import HintLayout
from .base import run_scenario

__all__ = ["DLRMScenario", "run_online"]


@dataclasses.dataclass
class DLRMScenario:
    """Phase-shifting DLRM embedding-page trace.

    Geometry comes from the trace spec (page = block, row = access); the
    collector rates are the §VI defaults (``nb_scan_rate`` = one NB scan
    pass per epoch's batches).  ``rotate_by`` is the hot-head rotation at
    ``shift_at`` (default a third of the table, see
    :class:`~repro_torch.dlrm.datagen.PhaseShiftSampler`).
    """

    spec: datagen.DLRMTraceSpec = datagen.SMALL
    system: MemSystem = CXL_SYSTEM
    n_epochs: int = 8
    batches_per_epoch: int = 4
    shift_at: int = 4
    k_hot: Optional[int] = None
    pebs_period: int = 401
    rotate_by: Optional[int] = None
    seed: int = 0

    name = "dlrm"

    def __post_init__(self):
        n = self.spec.n_pages
        self.n_blocks = n
        self.k_hot = min(self.k_hot if self.k_hot is not None
                         else max(n // 20, 1), n)
        self.bytes_per_access = float(self.spec.row_bytes)
        self.block_bytes = float(self.spec.page_bytes)
        self.nb_scan_rate = max(n // self.batches_per_epoch, 1)

    def epochs(self) -> Iterator[np.ndarray]:
        return datagen.phase_shift_epochs(
            self.spec, n_epochs=self.n_epochs,
            batches_per_epoch=self.batches_per_epoch, shift_at=self.shift_at,
            rotate_by=self.rotate_by, seed=self.seed)

    def hint_layout(self) -> HintLayout:
        # layout from the same sampler the trace uses, so the static hints
        # point at the actual table layout by construction
        sampler = datagen.PhaseShiftSampler(
            self.spec, rotate_by=self.rotate_by, seed=self.seed)
        return HintLayout(self.n_blocks, rank_to_page=sampler.rank_to_page,
                          alpha=self.spec.alpha,
                          rows_per_page=self.spec.rows_per_page)


def run_online(
    spec: datagen.DLRMTraceSpec = datagen.SMALL,
    system: MemSystem = CXL_SYSTEM,
    n_epochs: int = 8,
    batches_per_epoch: int = 4,
    shift_at: int = 4,
    k_hot: Optional[int] = None,
    policies: tuple = ALL_POLICIES,
    pebs_period: int = 401,
    rotate_by: Optional[int] = None,
    seed: int = 0,
    hints=False,
    lookahead_depth: int = 1,
    prefetch_overlap: float = 1.0,
    fused: bool = True,
    mesh=None,
    sync_every: int = 1,
    export=None,
    device="cuda",
) -> dict:
    """§VI online regime: multi-epoch phase-shifting DLRM trace through the
    EpochRuntime.  The hot set rotates at ``shift_at``; the trajectory shows
    which telemetry/policy pairs re-converge and which collapse (NB).

    ``hints=True`` attaches the scenario's default
    :class:`repro_torch.hints.HintPipeline` (static table analysis +
    ``lookahead_depth`` epochs of lookahead + phase-change re-weighting) so
    the hinted lane runs on compiler-derived ranks and the prefetch lane is
    live; a pre-built pipeline may be passed instead.  ``prefetch_overlap``
    is how much of the prefetch lane's migration streams under the epoch it
    serves.

    ``sync_every=K`` batches the record syncs (bit-identical for every K);
    ``export=`` streams records through a
    :class:`repro_torch.export.ExportClient` (observability-only:
    trajectories are byte-identical either way); ``device`` defaults to
    ``"cuda"`` (raises without one).  ``fused=False`` runs the per-lane
    reference path; ``mesh=`` is not ported yet and raises.

    Returns ``{"trajectory": per-epoch dict, "summary": headline numbers}``.
    """
    scenario = DLRMScenario(
        spec=spec, system=system, n_epochs=n_epochs,
        batches_per_epoch=batches_per_epoch, shift_at=shift_at, k_hot=k_hot,
        pebs_period=pebs_period, rotate_by=rotate_by, seed=seed)
    return run_scenario(
        scenario, policies=policies, hints=hints,
        lookahead_depth=lookahead_depth, prefetch_overlap=prefetch_overlap,
        fused=fused, mesh=mesh, sync_every=sync_every, export=export,
        device=device)
