"""whisper-small [arXiv:2212.04356; unverified]: enc-dec, 12L decoder
d=768 12H d_ff=3072 vocab=51865; the conv audio frontend is a stub --
the model takes precomputed frame embeddings [B, 1500, 768]."""

from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51_865,
    attn_pattern="full",
    norm_type="layernorm",
    act="gelu",
    tie_embeddings=True,
    encoder=EncoderConfig(
        n_layers=12, n_frames=1500, d_model=768, n_heads=12, d_ff=3072
    ),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    source="arXiv:2212.04356",
)
