"""hymba-1.5b [arXiv:2411.13676; hf]: 32L d=1600 25H (GQA kv=5) d_ff=5504,
parallel attention + Mamba heads per layer, ssm_state=16; sliding-window
attention with periodic global layers (the Hymba pattern)."""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32_001,
    attn_pattern="local_global",
    sliding_window=1024,
    global_every=16,           # few global layers, rest SWA
    norm_type="rmsnorm",
    act="silu",
    parallel_ssm=True,
    ssm=SSMConfig(kind="mamba", state_dim=16, expand=2, conv_dim=4),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    source="arXiv:2411.13676",
)
