"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4, head_dim=128)
d_ff=18432 vocab=49152, RoPE [arXiv:2402.19173; hf]."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-7b",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab=49152,
    act="gelu",
    family="attn",
)

SMOKE = ModelConfig(
    arch_id="starcoder2-7b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    act="gelu",
    family="attn",
    dtype="float32",
)
