"""Model configuration (the dense subset the port runs in this slice).

Counterpart of ``repro/configs/base.py``: the same field names and
defaults for what a dense decoder needs, ``hd`` and ``reduced()``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    attn_pattern: str = "full"
    rope_theta: float = 10_000.0
    norm_type: str = "rmsnorm"   # rmsnorm | layernorm | nonparametric_ln
    act: str = "silu"            # silu (swiglu)
    tie_embeddings: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    max_seq_len: int = 131_072
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU tests (the JAX package's
        ``ModelConfig.reduced`` for a dense model)."""
        n_heads = min(4, self.n_heads)
        return dataclasses.replace(
            self,
            name=f"{self.name}-smoke",
            n_layers=min(4, max(2, self.n_layers // 16)),
            d_model=64,
            n_heads=n_heads,
            n_kv_heads=max(1, min(self.n_kv_heads, n_heads)),
            head_dim=16,
            d_ff=128,
            vocab=256,
            max_seq_len=128,
            param_dtype="float32",
            compute_dtype="float32",
        )
