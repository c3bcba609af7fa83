"""Config registry: ``get_config(name)``; ``<arch>-smoke`` maps to
``get_config(arch).reduced()``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig  # noqa: F401

_MODULES = {
    "llama3-8b": "rsq_llama3_8b",
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
