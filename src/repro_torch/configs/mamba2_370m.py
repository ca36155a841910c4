"""mamba2-370m [ssm] — 48L d_model=1024, attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality) [arXiv:2405.21060; unverified].

Attention-free: the paper's SpGEMM technique is inapplicable; long_500k
decode runs with O(1) recurrent state.
"""
from ..models.ssm import SSMConfig
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-370m",
    n_layers=48,
    d_model=1024,
    vocab=50280,
    family="ssm",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, chunk=128),
    tie_embeddings=True,
    supports_long_context=True,
)

SMOKE = ModelConfig(
    arch_id="mamba2-370m-smoke",
    n_layers=2,
    d_model=64,
    vocab=256,
    family="ssm",
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, d_conv=4, chunk=8),
    tie_embeddings=True,
    supports_long_context=True,
    dtype="float32",
)
