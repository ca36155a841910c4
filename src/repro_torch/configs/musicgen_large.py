"""musicgen-large [audio] — 48L d_model=2048 32H (MHA kv=32, head_dim=64)
d_ff=8192 vocab=2048; decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

The EnCodec frontend is a stub: the model takes precomputed frame
embeddings (the sum of per-codebook embeddings), so input_mode="embeds"; the output head predicts one codebook stream
(vocab 2048). The backbone transformer is exact.
"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-large",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=2048,
    act="gelu",
    family="attn",
    input_mode="embeds",
)

SMOKE = ModelConfig(
    arch_id="musicgen-large-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=64,
    act="gelu",
    family="attn",
    input_mode="embeds",
    dtype="float32",
)
