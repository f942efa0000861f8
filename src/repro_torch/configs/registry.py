"""--arch registry: id -> ModelConfig (olmo-1b in this slice)."""

from __future__ import annotations

from repro_torch.configs import olmo_1b
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {olmo_1b.CONFIG.name: olmo_1b.CONFIG}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
