"""--arch registry: id -> ModelConfig (olmo-1b and deepseek-moe-16b)."""

from __future__ import annotations

from repro_torch.configs import deepseek_moe_16b, olmo_1b
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (olmo_1b.CONFIG, deepseek_moe_16b.CONFIG)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
