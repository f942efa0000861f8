"""gemma3-1b [hf:google/gemma-3-1b-pt; unverified]: 26L d=1152 4H (GQA kv=1)
d_ff=6912 vocab=262144, 5:1 local:global sliding-window attention, 128k ctx."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262_144,
    attn_pattern="local_global",
    sliding_window=1024,
    global_every=6,            # 5 local : 1 global
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    act="geglu",
    max_seq_len=131_072,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    source="hf:google/gemma-3-1b-pt (unverified)",
)
