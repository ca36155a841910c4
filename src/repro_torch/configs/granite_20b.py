"""granite-20b [dense] — 52L d_model=6144 48H (MQA kv=1, head_dim=128)
d_ff=24576 vocab=49152, llama-arch code model [arXiv:2405.04324; hf].
MQA: one KV head, repeated to the 48 query heads.
"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-20b",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    act="gelu",
    family="attn",
)

SMOKE = ModelConfig(
    arch_id="granite-20b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab=256,
    act="gelu",
    family="attn",
    dtype="float32",
)
