"""grok-1-314b [hf:xai-org/grok-1; unverified]: 64L d=6144 48H (GQA kv=8)
MoE 8 experts top-2, d_expert=32768, vocab=131072.  Adafactor optimizer
(factored second moment) so its training state stays sublinear."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab=131_072,
    attn_pattern="full",
    norm_type="rmsnorm",
    act="geglu",
    moe=MoEConfig(
        n_experts=8, top_k=2, n_shared=0, d_expert=32768,
        capacity_factor=1.25,
    ),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    optimizer="adafactor",
    source="hf:xai-org/grok-1 (unverified)",
)
