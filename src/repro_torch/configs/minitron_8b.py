"""minitron-8b [dense] — 32L d_model=4096 32H (GQA kv=8, head_dim=128)
d_ff=16384 vocab=256000, pruned nemotron [arXiv:2407.14679; hf]."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    arch_id="minitron-8b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=256000,
    act="swiglu",
    family="attn",
)

SMOKE = ModelConfig(
    arch_id="minitron-8b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    act="swiglu",
    family="attn",
    dtype="float32",
)
