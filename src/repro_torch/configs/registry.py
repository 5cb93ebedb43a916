"""Architecture registry: --arch <id> -> ModelConfig (+ reduced smoke config).

The same ten arch ids as ``repro.configs.registry``, each answered by the
port's copy of its config module."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(_ARCH_MODULES[arch]).smoke_config()
