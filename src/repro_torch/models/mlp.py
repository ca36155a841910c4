"""Feed-forward blocks: SwiGLU (llama-family), GeGLU (gemma2) and GELU
(starcoder-family).

On a mesh (``mesh`` given, ``params`` this rank's slices under
``mlp_specs``) the block is Megatron's: ``w_in``/``w_gate`` hold this
rank's d_ff columns, ``w_out`` the same rows, and the output is one sum
over "model" in axis order, of f32 partials rounded once. A d_ff that does not divide the axis stays
whole, and then no sum is taken. Under autograd the input enters the
split region through ``collectives.enter`` and the sum is
``collectives.sum_partials``."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from . import collectives as C
from .common import MODEL_AX, Spec, dense_init

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


def mlp_specs(act: str, d_ff: int = 0, tp: int = 1) -> Dict[str, Spec]:
    ax = MODEL_AX if tp > 1 and d_ff % tp == 0 else None
    specs = {"w_in": Spec(None, ax), "w_out": Spec(ax, None)}
    if act in GATED:
        specs["w_gate"] = Spec(None, ax)
    return specs


def mlp(params, x: Tensor, act: str, mesh=None, specs=None) -> Tensor:
    """``"gelu"`` is the tanh form, as ``jax.nn.gelu``'s default
    (``approximate=True``) is in the JAX package. ``mesh`` and ``specs``:
    see the module docstring."""
    split = mesh is not None and specs["w_out"][0] == MODEL_AX and mesh.axis_size(MODEL_AX) > 1
    x_in = C.enter(mesh, x, MODEL_AX) if split else x  # the column-split region
    h = torch.einsum("bsd,df->bsf", x_in, params["w_in"])
    if act == "swiglu":
        g = torch.einsum("bsd,df->bsf", x_in, params["w_gate"])
        h = F.silu(g) * h
    elif act == "geglu":  # gemma2 gated-GELU
        g = torch.einsum("bsd,df->bsf", x_in, params["w_gate"])
        h = F.gelu(g, approximate="tanh") * h
    elif act in ("gelu", "gelu_tanh"):
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(act)
    if split:
        y = torch.einsum("bsf,fd->bsd", h.float(), params["w_out"].float())
        return C.sum_partials(mesh, y, MODEL_AX).to(x.dtype)
    return torch.einsum("bsf,fd->bsd", h, params["w_out"])
