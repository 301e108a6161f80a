"""Config registry: ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``.

Only the architectures the port runs are listed; the others are still to
port (ROADMAP.md).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (CoLearnConfig, InputShape,
                                      INPUT_SHAPES, ModelConfig, TrainConfig)

_MODULES = {
    "internlm2-1.8b": "internlm2_1_8b",
    "xlstm-1.3b": "xlstm_1_3b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
}

ARCH_IDS = tuple(_MODULES)

__all__ = ["ARCH_IDS", "CoLearnConfig", "INPUT_SHAPES", "InputShape",
           "ModelConfig", "TrainConfig", "get_config", "get_smoke_config"]


def _mod(arch_id: str):
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"arch {arch_id!r} not yet ported, see ROADMAP.md; ported: "
            f"{sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).smoke_config()
