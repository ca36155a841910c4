"""zamba2-2.7b [hybrid] — 54L mamba2 backbone d_model=2560 + one weight-
shared attention block (32H MHA + d_ff=10240 MLP) applied every 6 layers,
vocab=32000, ssm_state=64 [arXiv:2411.15242; hf].

Hybrid decode state: per-layer SSM states + per-application KV cache for the
shared block — sub-quadratic, so long_500k runs.
"""
from ..models.ssm import SSMConfig
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab=32000,
    act="gelu",
    family="hybrid",
    hybrid_every=6,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, d_conv=4, chunk=128),
    supports_long_context=True,
)

SMOKE = ModelConfig(
    arch_id="zamba2-2.7b-smoke",
    n_layers=4,
    d_model=64,
    n_heads=4,
    kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    act="gelu",
    family="hybrid",
    hybrid_every=2,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, d_conv=4, chunk=8),
    supports_long_context=True,
    dtype="float32",
)
