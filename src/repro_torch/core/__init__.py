"""repro_torch.core — memory-side tiering telemetry (PyTorch port of
``repro/core``).

Public surface:
  TieredStore           two-tier block store + indirection (blockstore.py)
  Placement             the bounded-fast-tier slot<->block maps (placement.py)
  HMU / PEBS / NB       telemetry emulators over one access stream
                        (telemetry.py)
  policies              oracle top-k, NB two-touch, reactive, proactive
  selectk               exact top-k / rank selection without full sorts
  MemSystem             two-tier analytic cost model (costmodel.py)
  TieringManager        Fig. 2 "Tiering Agent" glue (manager.py)
  EpochRuntime          online observe->decide->migrate->account loop over
                        all six policy lanes (runtime.py, fused path)
  Tenancy               multi-tenant layout and quotas the epoch step
                        enforces (runtime.py; built by repro_torch.fleet)
  metrics               accuracy / coverage / overlap / hotness CDF
"""
from .blockstore import TieredStore
from .costmodel import CXL_SYSTEM, TPU_V5E_SYSTEM, MemSystem, TierSpec
from .manager import StrategyResult, TieringManager
from .placement import Placement
from .runtime import (ALL_POLICIES, EpochRecord, EpochRuntime, Tenancy,
                      Trajectory)
from . import metrics, placement, policy, selectk, telemetry

__all__ = [
    "TieredStore", "TieringManager", "StrategyResult", "Placement",
    "EpochRuntime", "EpochRecord", "Tenancy", "Trajectory", "ALL_POLICIES",
    "MemSystem", "TierSpec", "CXL_SYSTEM", "TPU_V5E_SYSTEM",
    "metrics", "placement", "policy", "selectk", "telemetry",
]
