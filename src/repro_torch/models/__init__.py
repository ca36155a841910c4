"""Model zoo: one decoder-LM implementation covering all the JAX package's
families (``transformer``), its blocks (``attention``, ``mlp``, ``moe``,
``ssm``) and shared pieces (``common``)."""
from .transformer import (  # noqa: F401
    ModelConfig,
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
)
