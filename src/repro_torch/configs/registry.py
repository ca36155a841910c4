"""--arch <id> registry: full configs, smoke configs and input shapes."""
from __future__ import annotations

from ..models.transformer import ModelConfig
from . import (
    deepseek_moe_16b,
    gemma2_9b,
    granite_20b,
    mamba2_370m,
    minitron_8b,
    musicgen_large,
    olmoe_1b_7b,
    pixtral_12b,
    starcoder2_7b,
    zamba2_2_7b,
)
from .shapes import SHAPES, ShapeSpec, applicable  # noqa: F401

_MODULES = {
    "pixtral-12b": pixtral_12b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "gemma2-9b": gemma2_9b,
    "granite-20b": granite_20b,
    "starcoder2-7b": starcoder2_7b,
    "minitron-8b": minitron_8b,
    "musicgen-large": musicgen_large,
    "mamba2-370m": mamba2_370m,
    "zamba2-2.7b": zamba2_2_7b,
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = _MODULES[arch]
    return mod.SMOKE if smoke else mod.CONFIG
