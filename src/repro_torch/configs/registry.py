"""--arch registry: id -> ModelConfig (the configs ported so far)."""

from __future__ import annotations

from repro_torch.configs import (
    deepseek_moe_16b,
    gemma3_1b,
    gemma3_27b,
    grok_1_314b,
    hymba_1_5b,
    llama32_vision_11b,
    minitron_8b,
    olmo_1b,
    rwkv6_3b,
    whisper_small,
)
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (olmo_1b.CONFIG, deepseek_moe_16b.CONFIG,
                        minitron_8b.CONFIG, gemma3_1b.CONFIG,
                        gemma3_27b.CONFIG, whisper_small.CONFIG,
                        llama32_vision_11b.CONFIG, rwkv6_3b.CONFIG,
                        hymba_1_5b.CONFIG, grok_1_314b.CONFIG)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
