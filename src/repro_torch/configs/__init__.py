"""Config registry: ``get_config(name)``; ``<arch>-smoke`` maps to
``get_config(arch).reduced()``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig  # noqa: F401

_MODULES = {
    "llama3-8b": "rsq_llama3_8b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "minitron-4b": "minitron_4b",
    "qwen1.5-4b": "qwen15_4b",
    "command-r-35b": "command_r_35b",
    "command-r-plus-104b": "command_r_plus_104b",
    "mamba2-780m": "mamba2_780m",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "whisper-medium": "whisper_medium",
    "llama-3.2-vision-11b": "llama32_vision_11b",
}


def list_configs() -> tuple[str, ...]:
    return tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
