"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8, head_dim=256)
d_ff=14336 vocab=256000; alternating local(4096)/global attention, attn
soft-cap 50, final logit soft-cap 30, GeGLU, post-norms, scaled embeddings
[arXiv:2408.00118; hf]."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma2-9b",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    act="geglu",
    family="attn",
    local_global_alt=True,
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    query_scale=256 ** -0.5,
    use_post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    arch_id="gemma2-9b-smoke",
    n_layers=4,
    d_model=64,
    n_heads=4,
    kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    act="geglu",
    family="attn",
    local_global_alt=True,
    window=8,
    attn_softcap=50.0,
    final_softcap=30.0,
    use_post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
    dtype="float32",
)
