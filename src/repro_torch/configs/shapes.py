"""Input shapes (one set, shared by all LM archs).

  train_4k     seq 4,096  × global batch 256   -> train_step
  prefill_32k  seq 32,768 × global batch 32    -> prefill (serve)
  decode_32k   KV 32,768  × global batch 128   -> decode_step (serve)
  long_500k    KV 524,288 × global batch 1     -> decode_step (serve);
               requires sub-quadratic state — SSM/hybrid only
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable(arch_family: str, supports_long: bool, shape: str) -> bool:
    """Skip rules: long_500k only for sub-quadratic decode state."""
    if shape == "long_500k":
        return supports_long
    return True
