"""repro_torch.scenarios — one EpochRuntime, many workloads (PyTorch port of
``repro/scenarios``): the :class:`AccessScenario` protocol,
:func:`run_scenario`, the DLRM phase-shift scenario, the KV-cache scenario
(KV pages placed from the serving engine's per-page attention-mass feed),
the MoE expert-bank scenario (expert banks placed from the router's
counters) and the mmap-bench scenario (the paper's §III.A region, the
fleet's scanner tenant).

The model-backed scenarios import the model stack lazily (PEP 562), so
trace-only users of ``run_online`` never pay for it.
"""
from .base import AccessScenario, build_hints, run_scenario, scenario_summary
from .dlrm import DLRMScenario, run_online
from .mmap_bench import MmapBenchScenario

__all__ = [
    "AccessScenario", "DLRMScenario", "KVCacheScenario", "MmapBenchScenario",
    "MoEExpertScenario", "build_hints", "run_online", "run_scenario",
    "scenario_summary",
]

_LAZY = {"KVCacheScenario": "kv_cache", "MoEExpertScenario": "moe_experts"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
