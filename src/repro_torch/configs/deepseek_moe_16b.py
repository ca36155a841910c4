"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE: 64 routed experts top-6 + 2 shared, fine-grained
[arXiv:2401.06066; hf].

Exercises the paper's technique end-to-end: the SpGEMM-formulated
dispatch (models/moe.py) through the SpMM kernel.
"""
from ..models.moe import MoEConfig
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-moe-16b",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=102400,
    act="swiglu",
    family="attn",
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
)

SMOKE = ModelConfig(
    arch_id="deepseek-moe-16b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    kv_heads=4,
    head_dim=16,
    d_ff=32,
    vocab=256,
    act="swiglu",
    family="attn",
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=1),
    dtype="float32",
)
