"""Architecture registry: --arch <id> resolves here (the port's own copy of
``repro/configs``, as data: the configs build the port's ``ModelConfig``).

Each module defines ``config()`` (the exact published configuration) and
``smoke_config()`` (same family/features, reduced dims, for CPU smoke tests).
Optional per-arch attributes: ``SHARDING_OVERRIDES`` (logical->mesh axis
remaps), ``OPTIMIZER`` ("adamw" | "adafactor").
"""
from __future__ import annotations

import importlib
from typing import Dict

ARCH_IDS = [
    "musicgen-medium",
    "rwkv6-3b",
    "llama3.2-3b",
    "qwen2-0.5b",
    "internlm2-1.8b",
    "yi-9b",
    "qwen2-vl-72b",
    "mixtral-8x22b",
    "kimi-k2-1t-a32b",
    "zamba2-2.7b",
]

_MODULES: Dict[str, str] = {
    "musicgen-medium": "musicgen_medium",
    "rwkv6-3b": "rwkv6_3b",
    "llama3.2-3b": "llama3_2_3b",
    "qwen2-0.5b": "qwen2_0_5b",
    "internlm2-1.8b": "internlm2_1_8b",
    "yi-9b": "yi_9b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "mixtral-8x22b": "mixtral_8x22b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "zamba2-2.7b": "zamba2_2_7b",
}


def arch_module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    return importlib.import_module(f"{__name__}.{_MODULES[arch_id]}")


def get_config(arch_id: str):
    return arch_module(arch_id).config()


def get_smoke_config(arch_id: str):
    return arch_module(arch_id).smoke_config()


def get_optimizer_name(arch_id: str) -> str:
    return getattr(arch_module(arch_id), "OPTIMIZER", "adamw")


def get_sharding_overrides(arch_id: str) -> dict:
    return getattr(arch_module(arch_id), "SHARDING_OVERRIDES", {})
