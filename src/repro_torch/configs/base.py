"""Model configuration (the decoders the port runs).

Counterpart of ``repro/configs/base.py``: the same field names and
defaults for what a dense, MoE, audio (whisper: an encoder over stub
frame embeddings), vlm (llama-3.2-vision: gated cross-attention over
stub patch embeddings), ssm (rwkv6: attention-free time-mix and
channel-mix over a recurrent state) or hybrid (hymba: Mamba heads in
parallel with sliding-window attention, ``parallel_ssm``) decoder needs;
``hd``, ``attn_free``, ``sub_quadratic``, ``param_count``,
``active_param_count``, ``is_global_layer``, ``is_cross_layer`` and
``reduced()``; and the training fields ``optimizer`` and ``remat``.
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
class SSMConfig:
    """Covers both RWKV6 time-mix and Mamba-style selective SSM heads."""

    kind: str = "mamba"          # "mamba" | "rwkv6"
    state_dim: int = 16          # per-head recurrent state (hymba: 16)
    head_dim: int = 64           # rwkv6 head size
    expand: int = 2              # mamba inner expansion
    conv_dim: int = 4            # mamba depthwise conv width
    chunk: int = 128             # chunked-scan block length


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder operating on stub frame embeddings."""

    n_layers: int = 12
    n_frames: int = 1500         # 30 s of audio at 50 Hz after conv stem
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
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
    optimizer: str = "adamw"     # adamw | adafactor (train/optimizer.py)
    remat: bool = True           # training: recompute each layer in backward
    max_seq_len: int = 131_072
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    parallel_ssm: bool = False   # hymba: attention and mamba heads in parallel
    encoder: EncoderConfig | None = None  # whisper
    cross_attn_every: int = 0    # llama-vision: each Nth layer cross-attends
    vision_tokens: int = 0       # stub patch-embedding count
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the dry run's long_500k shape (the reference's
        rule: recurrent families, or local/global attention)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attn_pattern == "local_global"

    def param_count(self) -> int:
        """The reference's analytic parameter count (its 6·N·D roofline
        terms), formula for formula."""
        d, hd = self.d_model, self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        gated = self.act in ("silu", "geglu")
        ffn = (3 if gated else 2) * d * self.d_ff
        per_layer = attn if not self.attn_free else 0
        if self.moe is not None:
            e = self.moe
            nm = 3 if gated else 2
            per_layer += e.n_experts * (nm * d * e.d_expert) \
                + e.n_shared * (nm * d * e.d_expert) + d * e.n_experts
        else:
            per_layer += ffn
        if self.family == "ssm" and self.ssm and self.ssm.kind == "rwkv6":
            per_layer = 5 * d * d + d * d + 2 * d * self.d_ff + d * self.d_ff
        if self.parallel_ssm and self.ssm:
            di = self.ssm.expand * d
            per_layer += 2 * d * di + di * d + di * self.ssm.state_dim * 2
        if self.cross_attn_every > 0:
            frac = 1.0 / self.cross_attn_every
            per_layer += int(frac * (2 * d * self.n_kv_heads * hd
                                     + 2 * d * self.n_heads * hd))
        total = self.n_layers * per_layer + self.vocab * d
        if not self.tie_embeddings:
            total += self.vocab * d
        if self.encoder is not None:
            enc = self.encoder
            total += enc.n_layers * (4 * enc.d_model ** 2
                                     + 2 * enc.d_model * enc.d_ff)
            total += self.n_layers * 4 * d * d
        return total

    def active_param_count(self) -> int:
        """Active params a token (MoE: the routed top-k and the shared
        experts only), the reference's formula."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        nm = 3 if self.act in ("silu", "geglu") else 2
        dense_like = self.param_count() - self.n_layers * (
            e.n_experts * nm * self.d_model * e.d_expert)
        active_moe = self.n_layers * (e.top_k * nm * self.d_model
                                      * e.d_expert)
        return dense_like + active_moe

    def is_global_layer(self, i: int) -> bool:
        if self.attn_pattern != "local_global" or self.global_every <= 0:
            return self.attn_pattern == "full"
        return i % self.global_every == self.global_every - 1

    def is_cross_layer(self, i: int) -> bool:
        """Whether decoder layer ``i`` cross-attends: every layer of an
        encoder-decoder (whisper), the last of each group of
        ``cross_attn_every`` (llama-vision), none otherwise."""
        if self.encoder is not None:
            return True
        g = self.cross_attn_every
        return g > 0 and i % g == g - 1

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU tests (the JAX package's
        ``ModelConfig.reduced``)."""
        mo = None
        if self.moe is not None:
            mo = dataclasses.replace(
                self.moe, n_experts=min(8, self.moe.n_experts),
                top_k=min(2, self.moe.top_k),
                n_shared=min(1, self.moe.n_shared), d_expert=128)
        ss = None
        if self.ssm is not None:
            ss = dataclasses.replace(
                self.ssm, state_dim=min(8, self.ssm.state_dim),
                head_dim=32, chunk=16)
        enc = None
        if self.encoder is not None:
            enc = dataclasses.replace(
                self.encoder, n_layers=2, n_frames=16, d_model=64,
                n_heads=4, d_ff=128)
        # an attention-free config keeps no heads
        n_heads = min(4, self.n_heads) if self.n_heads else 0
        return dataclasses.replace(
            self,
            name=f"{self.name}-smoke",
            n_layers=min(4, max(2, self.n_layers // 16)),
            d_model=64,
            n_heads=n_heads,
            n_kv_heads=max(1, min(self.n_kv_heads, n_heads)) if n_heads
            else 0,
            head_dim=16 if self.n_heads else 0,
            d_ff=128,
            vocab=256,
            sliding_window=8,
            global_every=self.global_every if self.global_every <= 4 else 2,
            vision_tokens=8 if self.vision_tokens else 0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            moe=mo, ssm=ss, encoder=enc,
            max_seq_len=128,
            param_dtype="float32",
            compute_dtype="float32",
        )
