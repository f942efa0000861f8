"""olmo-1b [arXiv:2402.00838; hf]: 16L d=2048 16H (kv=16) d_ff=8192
vocab=50304, non-parametric LayerNorm (the OLMo signature)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50_304,
    attn_pattern="full",
    norm_type="nonparametric_ln",
    act="silu",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    source="arXiv:2402.00838",
)
