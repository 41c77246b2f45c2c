"""Architecture registry: ``get_config(arch_id)`` / ``--arch <id>``."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    ModelConfig,
    PREFILL_32K,
    ShapeConfig,
    TRAIN_4K,
    applicable,
    shape_by_name,
)

_MODULES = {
    "seamless-m4t-medium": "seamless_m4t_medium",
    "zamba2-7b": "zamba2_7b",
    "minitron-8b": "minitron_8b",
    "starcoder2-7b": "starcoder2_7b",
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen3-4b": "qwen3_4b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "xlstm-1.3b": "xlstm_1_3b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    try:
        mod_name = _MODULES[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
