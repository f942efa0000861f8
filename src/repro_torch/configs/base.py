"""Model configuration (the dense and MoE decoders the port runs).

Counterpart of ``repro/configs/base.py``: the same field names and
defaults for what a dense or MoE decoder needs (sliding-window attention
included), ``hd``, ``is_global_layer`` and ``reduced()``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_expert: int = 0            # per-expert FFN width (= d_ff of the config)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe (the families ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    attn_pattern: str = "full"   # full | local_global
    sliding_window: int = 1024
    global_every: int = 0        # local_global: layer i is global if i % N == N-1
    rope_theta: float = 10_000.0
    norm_type: str = "rmsnorm"   # rmsnorm | layernorm | nonparametric_ln
    act: str = "silu"            # silu (swiglu) | geglu | gelu | relu2
    tie_embeddings: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    max_seq_len: int = 131_072
    moe: MoEConfig | None = None
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def is_global_layer(self, i: int) -> bool:
        if self.attn_pattern != "local_global" or self.global_every <= 0:
            return self.attn_pattern == "full"
        return i % self.global_every == self.global_every - 1

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU tests (the JAX package's
        ``ModelConfig.reduced`` for a dense or MoE model)."""
        mo = None
        if self.moe is not None:
            mo = dataclasses.replace(
                self.moe, n_experts=min(8, self.moe.n_experts),
                top_k=min(2, self.moe.top_k),
                n_shared=min(1, self.moe.n_shared), d_expert=128)
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
            sliding_window=8,
            global_every=self.global_every if self.global_every <= 4 else 2,
            moe=mo,
            max_seq_len=128,
            param_dtype="float32",
            compute_dtype="float32",
        )
