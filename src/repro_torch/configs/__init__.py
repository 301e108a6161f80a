"""Config registry: ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``.

The ten architectures of the JAX package, registered in its order.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (CoLearnConfig, InputShape,
                                      INPUT_SHAPES, ModelConfig, TrainConfig)

_MODULES = {
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen1.5-32b": "qwen1_5_32b",
    "musicgen-large": "musicgen_large",
    "arctic-480b": "arctic_480b",
    "internvl2-76b": "internvl2_76b",
    "xlstm-1.3b": "xlstm_1_3b",
    "qwen2-72b": "qwen2_72b",
    "internlm2-1.8b": "internlm2_1_8b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}

ARCH_IDS = tuple(_MODULES)

__all__ = ["ARCH_IDS", "CoLearnConfig", "INPUT_SHAPES", "InputShape",
           "ModelConfig", "TrainConfig", "get_config", "get_smoke_config"]


def _mod(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).smoke_config()
