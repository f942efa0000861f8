"""rwkv6-3b (Finch) [arXiv:2404.05892; hf]: 32L d=2560, attention-free
data-dependent-decay linear recurrence, d_ff=8960, vocab=65536."""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=8960,
    vocab=65_536,
    norm_type="layernorm",
    act="relu2",               # rwkv channel-mix uses squared relu
    ssm=SSMConfig(kind="rwkv6", head_dim=64),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    source="arXiv:2404.05892",
)
