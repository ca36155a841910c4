"""Mixture-of-Experts layer with SpGEMM-formulated dispatch: the paper's
sparse-times-dense multiply inside the LM stack.

The token→expert dispatch is a sparse matrix S (slots × tokens) with one 1
per kept assignment: dispatch = S @ X and the weighted combine = Sᵀ_w @ Y
are two calls of ``core.local_spgemm.spmm``, which on the card is the SpMM
kernel (``csrc/spmm.cu``). Each expert's slot block is a capacity bucket
sized from the router's histogram, as the paper's column batching sizes an
output block by a symbolic count.

The matrices keep the JAX package's padding: nnz = T·k, and a dropped
assignment has row E·cap and column T (the sentinels, which the kernel
skips). Which assignments are dropped follows the exclusive cumsum over
token-major (T·k) assignments; ``top_k`` breaks ties toward the lower
expert index, as ``lax.top_k`` does.

Expert parallelism: the JAX package's "a2a" (prefill) and "dense_ep"
(decode) modes shard experts over a mesh's "model" axis. The port runs on
one card, where both reduce to the same local computation; ``mode`` is kept
so callers name the mode the JAX package would use.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..core import local_spgemm
from ..core.sparse import SparseCOO
from .common import dense_init

Tensor = torch.Tensor

MODES = ("a2a", "dense_ep")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    normalize_topk: bool = True
    dispatch_mode: str = "spgemm"  # "spgemm" | "scatter" (equivalent; tested)


def init_moe(generator, d_model: int, cfg: MoEConfig, dtype=torch.float32,
             device="cuda") -> Dict[str, Tensor]:
    E, F_ = cfg.n_experts, cfg.d_expert

    def init(shape, in_axis=0, dt=dtype):
        return dense_init(generator, shape, in_axis, dt, device)

    params = {
        "router": init((d_model, E), dt=torch.float32),  # fp32 router
        "w_in": init((E, d_model, F_), 1),
        "w_gate": init((E, d_model, F_), 1),
        "w_out": init((E, F_, d_model), 1),
    }
    if cfg.n_shared:
        fs = cfg.n_shared * F_
        params["shared"] = {
            "w_in": init((d_model, fs)),
            "w_gate": init((d_model, fs)),
            "w_out": init((fs, d_model)),
        }
    return params


# ---------------------------------------------------------------------------
# routing + dispatch
# ---------------------------------------------------------------------------
def _route(x_flat: Tensor, router_w: Tensor, cfg: MoEConfig):
    """(top_p in x's dtype, top_e, aux loss): f32 router probabilities, the
    top k per token (ties to the lower expert), Switch-style balance loss."""
    logits = x_flat.float() @ router_w.float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps equal probabilities in index order
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :cfg.top_k], top_e[:, :cfg.top_k]
    if cfg.normalize_topk:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    E = router_w.shape[1]
    f = F.one_hot(top_e, E).float().sum(1).mean(0)  # fraction routed per expert (×k)
    aux = E * torch.sum(f / cfg.top_k * probs.mean(0))
    return top_p.to(x_flat.dtype), top_e, aux


def _capacity(T: int, cfg: MoEConfig) -> int:
    c = int(T * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return ((c + 7) // 8) * 8


def _dispatch_indices(top_e: Tensor, cfg: MoEConfig, cap: int):
    """(eid, slot, keep) of each (token, k) assignment, token-major: its
    expert, its slot in the expert's bucket (the exclusive count of earlier
    assignments to that expert) and whether that slot is under ``cap``."""
    eid = top_e.reshape(-1)  # (T*k,)
    onehot = F.one_hot(eid, cfg.n_experts)
    rank = torch.cumsum(onehot, dim=0) - onehot
    slot = torch.gather(rank, 1, eid[:, None])[:, 0]
    keep = slot < cap
    return eid, slot, keep


def _nnz(n: int, device) -> Tensor:
    """A 0-dim i32 count made on ``device`` (a fill: no host-to-device copy,
    which would wait for the card at every MoE layer)."""
    return torch.full((), n, dtype=torch.int32, device=device)


def _token_of(T: int, k: int, device) -> Tensor:
    return torch.arange(T, device=device).repeat_interleave(k)


def _dispatch(x_flat: Tensor, eid, slot, keep, cfg: MoEConfig, cap: int) -> Tensor:
    """(E, cap, D) expert input buffers: S @ X through the SpMM, with S the
    (E·cap × T) dispatch matrix; or a direct scatter ("scatter" mode)."""
    T, D = x_flat.shape
    Tk = eid.shape[0]
    token_of = _token_of(T, Tk // T, x_flat.device)
    E = cfg.n_experts
    if cfg.dispatch_mode == "spgemm":
        s = SparseCOO(
            rows=torch.where(keep, eid * cap + slot, E * cap).int(),
            cols=torch.where(keep, token_of, T).int(),
            vals=keep.to(x_flat.dtype),
            nnz=_nnz(Tk, x_flat.device),
            shape=(E * cap, T),
        )
        buf = local_spgemm.spmm(s, x_flat.contiguous())  # (E*cap, D)
        return buf.reshape(E, cap, D)
    buf = torch.zeros((E * cap, D), dtype=x_flat.dtype, device=x_flat.device)
    dest = (eid * cap + slot)[keep]
    return buf.index_add_(0, dest, x_flat[token_of[keep]]).reshape(E, cap, D)


def _combine(y_buf: Tensor, top_p, eid, slot, keep, T: int, cfg: MoEConfig,
             cap: int) -> Tensor:
    """Weighted gather back, (T, D): Sᵀ_w @ Y through the SpMM, or a gather
    and segment sum ("scatter" mode)."""
    E, _, D = y_buf.shape
    Tk = eid.shape[0]
    token_of = _token_of(T, Tk // T, y_buf.device)
    w = top_p.reshape(-1)  # (T*k,)
    if cfg.dispatch_mode == "spgemm":
        s = SparseCOO(
            rows=torch.where(keep, token_of, T).int(),
            cols=torch.where(keep, eid * cap + slot, E * cap).int(),
            vals=torch.where(keep, w, 0.0).to(y_buf.dtype),
            nnz=_nnz(Tk, y_buf.device),
            shape=(T, E * cap),
        )
        return local_spgemm.spmm(s, y_buf.reshape(E * cap, D).contiguous())
    src = y_buf[torch.where(keep, eid, 0), torch.where(keep, slot, 0)]  # (T*k, D)
    src = torch.where(keep[:, None], src * w[:, None], 0)
    out = torch.zeros((T, D), dtype=src.dtype, device=src.device)
    return out.index_add_(0, token_of, src)


def _expert_ffn(buf: Tensor, w_in: Tensor, w_gate: Tensor, w_out: Tensor) -> Tensor:
    """buf: (E, C, D); expert weights (E, D, F) / (E, F, D)."""
    h = torch.einsum("ecd,edf->ecf", buf, w_in)
    g = torch.einsum("ecd,edf->ecf", buf, w_gate)
    return torch.einsum("ecf,efd->ecd", F.silu(g) * h, w_out)


def _shared_ffn(params, x: Tensor) -> Tensor:
    h = x @ params["w_in"]
    g = x @ params["w_gate"]
    return (F.silu(g) * h) @ params["w_out"]


def moe_layer(params, x: Tensor, cfg: MoEConfig, mode: str = "a2a") -> Tuple[Tensor, Tensor]:
    """Returns (output (B,S,D), aux loss scalar). ``mode`` is the JAX
    package's expert-parallel mode ("a2a" or "dense_ep"); on one card both
    are this local computation."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    top_p, top_e, aux = _route(xf, params["router"], cfg)
    cap = _capacity(T, cfg)
    eid, slot, keep = _dispatch_indices(top_e, cfg, cap)
    buf = _dispatch(xf, eid, slot, keep, cfg, cap)  # (E, cap, D)
    y = _expert_ffn(buf, params["w_in"], params["w_gate"], params["w_out"])
    out = _combine(y, top_p, eid, slot, keep, T, cfg, cap)
    shared = params.get("shared")
    if shared is not None:
        out = out + _shared_ffn(shared, xf)
    return out.reshape(B, S, D), aux
