"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE: 64 experts top-8 [arXiv:2409.02060; hf]."""
from ..models.moe import MoEConfig
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    arch_id="olmoe-1b-7b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab=50304,
    act="swiglu",
    family="attn",
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024, n_shared=0,
                  normalize_topk=False),
)

SMOKE = ModelConfig(
    arch_id="olmoe-1b-7b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    kv_heads=4,
    head_dim=16,
    d_ff=32,
    vocab=256,
    act="swiglu",
    family="attn",
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=0,
                  normalize_topk=False),
    dtype="float32",
)
