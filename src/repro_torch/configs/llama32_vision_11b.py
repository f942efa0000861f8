"""llama-3.2-vision-11b [hf:meta-llama/Llama-3.2-11B-Vision; unverified]:
40L d=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; every 5th layer gains a
gated cross-attention block over stub patch embeddings (the vision
frontend is a stub: the model takes [B, 1601, 4096])."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128_256,
    attn_pattern="full",
    rope_theta=500_000.0,
    norm_type="rmsnorm",
    act="silu",
    cross_attn_every=5,
    vision_tokens=1601,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    source="hf:meta-llama/Llama-3.2-11B-Vision (unverified)",
)
