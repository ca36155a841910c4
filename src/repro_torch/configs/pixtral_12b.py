"""pixtral-12b [vlm] — Pixtral-ViT frontend (STUB) + Mistral-Nemo-style
backbone. 40L d_model=5120 32H (GQA kv=8, head_dim=128) d_ff=14336
vocab=131072. [hf:mistralai/Pixtral-12B-2409; unverified]

The vision frontend is a stub: the model takes precomputed patch
embeddings (input_mode="embeds"); the backbone (the part
that matters for distribution/roofline) is exact.
"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    arch_id="pixtral-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    act="swiglu",
    rope_theta=1e6,
    family="attn",
    input_mode="embeds",
)

SMOKE = ModelConfig(
    arch_id="pixtral-12b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    act="swiglu",
    family="attn",
    input_mode="embeds",
    dtype="float32",
)
