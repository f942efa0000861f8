"""deepseek-moe-16b [arXiv:2401.06066; hf]: 28L d=2048 16H (kv=16)
fine-grained MoE: 64 routed experts top-6 + 2 shared, d_expert=1408,
vocab=102400."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                 # per-expert width
    vocab=102_400,
    attn_pattern="full",
    norm_type="rmsnorm",
    act="silu",
    moe=MoEConfig(
        n_experts=64, top_k=6, n_shared=2, d_expert=1408,
        capacity_factor=1.25,
    ),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    source="arXiv:2401.06066",
)
