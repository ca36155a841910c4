"""Feed-forward blocks: SwiGLU (llama-family), GeGLU (gemma2) and GELU
(starcoder-family)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .common import dense_init

Tensor = torch.Tensor

GATED = ("swiglu", "geglu")


def init_mlp(generator, d_model: int, d_ff: int, act: str, dtype=torch.float32,
             device="cuda") -> Dict[str, Tensor]:
    params = {
        "w_in": dense_init(generator, (d_model, d_ff), dtype=dtype, device=device),
        "w_out": dense_init(generator, (d_ff, d_model), dtype=dtype, device=device),
    }
    if act in GATED:
        params["w_gate"] = dense_init(generator, (d_model, d_ff), dtype=dtype, device=device)
    return params


def mlp(params, x: Tensor, act: str) -> Tensor:
    """``"gelu"`` is the tanh form, as ``jax.nn.gelu``'s default
    (``approximate=True``) is in the JAX package."""
    h = torch.einsum("bsd,df->bsf", x, params["w_in"])
    if act == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, params["w_gate"])
        h = F.silu(g) * h
    elif act == "geglu":  # gemma2 gated-GELU
        g = torch.einsum("bsd,df->bsf", x, params["w_gate"])
        h = F.gelu(g, approximate="tanh") * h
    elif act in ("gelu", "gelu_tanh"):
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(act)
    return torch.einsum("bsf,fd->bsd", h, params["w_out"])
