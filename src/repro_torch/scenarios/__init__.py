"""repro_torch.scenarios — one EpochRuntime, many workloads (PyTorch port of
``repro/scenarios``).  Ported so far: the :class:`AccessScenario` protocol,
:func:`run_scenario` and the DLRM phase-shift scenario; the KV-cache, MoE
and mmap-bench scenarios come with the model stack (ROADMAP Queue 1)."""
from .base import AccessScenario, build_hints, run_scenario, scenario_summary
from .dlrm import DLRMScenario, run_online

__all__ = [
    "AccessScenario", "DLRMScenario", "build_hints", "run_online",
    "run_scenario", "scenario_summary",
]
