"""minitron-8b [arXiv:2407.14679; hf]: pruned Nemotron-4, 32L d=4096 32H
(GQA kv=8) d_ff=16384 vocab=256000. Squared-ReLU FFN per Nemotron."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=256_000,
    attn_pattern="full",
    norm_type="layernorm",
    act="relu2",
    tie_embeddings=False,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    source="arXiv:2407.14679",
)
