"""gemma3-27b [hf:google/gemma-3-27b-pt; unverified]: 62L d=5376 32H (GQA
kv=16) d_ff=21504 vocab=262144, 5:1 local:global, 128k ctx."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab=262_144,
    attn_pattern="local_global",
    sliding_window=1024,
    global_every=6,
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    act="geglu",
    max_seq_len=131_072,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    source="hf:google/gemma-3-27b-pt (unverified)",
)
