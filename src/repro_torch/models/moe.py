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

Expert parallelism over a mesh's "model" axis (``mesh`` given, ``params``
this rank's slices under ``moe_specs``: E/tp experts, the shared experts'
F/tp columns), the JAX package's two modes:

  * "a2a" (prefill): the sequence is split over "model" and each rank
    routes its own tokens, with the capacity of its local T; the SpMM
    dispatches them into (E, cap, D) buckets, one all-to-all sends each
    expert's buckets to the rank holding it, the local experts run on
    (E/tp, tp·cap, D), a second all-to-all brings the results back, the
    SpMM combines, and the sequence is gathered over "model" again. The
    expert-parallel analogue of the paper's AllToAll-Fiber.
  * "dense_ep" (decode, and "a2a" when S does not divide tp): every rank
    routes all its tokens, runs its slice of the experts on its slice of
    the buckets, and the buckets are summed over "model" (the slices are
    disjoint, so the sum is a gather), then combined.

Tokens are routed on the rank's own tokens in both, so a sharded layer
drops other assignments than one device would (capacity of the local T),
exactly as the JAX package's does. The aux loss is averaged over "model"
and the data axes. On one device both modes are one local computation.

Under autograd (``collectives``): in "a2a" each model rank routes its own
sequence chunk, so the router's gradient (and an unsplit shared expert's)
is summed over "model", the all-to-alls' backward is the same exchange,
and the shared experts' sum over "model" (other tokens' partials, as the
JAX package adds them) takes the sum of the cotangents; in "dense_ep"
every model rank routes the same tokens, so its aux mean over "model" is
a mean of one value.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..core import local_spgemm
from ..core.sparse import SparseCOO
from . import collectives as C
from .common import MODEL_AX, Spec, batch_axes, dense_init

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


def moe_specs(cfg: MoEConfig, tp: int = 1) -> Dict:
    e_ax = MODEL_AX if tp > 1 and cfg.n_experts % tp == 0 else None
    specs = {
        "router": Spec(None, None),
        "w_in": Spec(e_ax, None, None),
        "w_gate": Spec(e_ax, None, None),
        "w_out": Spec(e_ax, None, None),
    }
    if cfg.n_shared:
        fs_ax = MODEL_AX if tp > 1 and (cfg.n_shared * cfg.d_expert) % tp == 0 else None
        specs["shared"] = {
            "w_in": Spec(None, fs_ax),
            "w_gate": Spec(None, fs_ax),
            "w_out": Spec(fs_ax, None),
        }
    return specs


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


def _shared_ffn(params, x: Tensor, mesh=None, own_tokens: bool = False) -> Tensor:
    """The shared experts' FFN; with ``mesh`` the weights are this rank's
    F/tp slice and the output is summed over "model". ``own_tokens``: each
    model rank passes its own tokens ("a2a"), and the sum adds other
    tokens' partials, as the JAX package's does; every rank then uses the
    sum, so its backward sums the cotangents (``all_reduce``)."""
    if mesh is not None and not own_tokens:
        x = C.enter(mesh, x, MODEL_AX)
    h = x @ params["w_in"]
    g = x @ params["w_gate"]
    if mesh is None:
        return (F.silu(g) * h) @ params["w_out"]
    out = (F.silu(g) * h).float() @ params["w_out"].float()  # f32 partials, rounded once
    total = C.all_reduce if own_tokens else C.sum_partials
    return total(mesh, out, MODEL_AX).to(x.dtype)


def _routed(params, xf: Tensor, cfg: MoEConfig, experts):
    """Route ``xf`` (T, D), dispatch through the SpMM, map the (E, cap, D)
    buckets through ``experts`` (to every expert's output, wherever it
    ran), combine through the SpMM: (out (T, D), aux)."""
    T = xf.shape[0]
    top_p, top_e, aux = _route(xf, params["router"], cfg)
    cap = _capacity(T, cfg)
    eid, slot, keep = _dispatch_indices(top_e, cfg, cap)
    buf = _dispatch(xf, eid, slot, keep, cfg, cap)  # (E, cap, D)
    y = experts(buf)
    return _combine(y, top_p, eid, slot, keep, T, cfg, cap), aux


def moe_layer(params, x: Tensor, cfg: MoEConfig, mode: str = "a2a", mesh=None
              ) -> Tuple[Tensor, Tensor]:
    """Returns (output (B,S,D), aux loss scalar). ``mode`` is the JAX
    package's expert-parallel mode ("a2a" or "dense_ep"); without a mesh
    (or with a "model" axis of 1) both are one local computation. On a
    mesh, ``x`` is this rank's share of the batch and the output keeps
    that shape (see the module docstring)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    B, S, D = x.shape
    tp = mesh.axis_size(MODEL_AX) if mesh is not None else 1
    shared = params.get("shared")
    ffn = lambda buf: _expert_ffn(buf, params["w_in"], params["w_gate"],  # noqa: E731
                                  params["w_out"])
    own_tokens = False
    if tp == 1:
        out, aux = _routed(params, x.reshape(B * S, D), cfg, ffn)
        if shared is not None:
            out = out + _shared_ffn(shared, x.reshape(B * S, D))
        out = out.reshape(B, S, D)
    else:
        E = cfg.n_experts
        if E % tp:
            raise ValueError(f"{E} experts do not split over a model axis of {tp}")
        e_loc = E // tp
        shared_split = (cfg.n_shared * cfg.d_expert) % tp == 0
        own_tokens = mode == "a2a" and S % tp == 0
        if own_tokens:
            s_loc = S // tp
            xf = C.take_block(mesh, x, MODEL_AX, 1).reshape(B * s_loc, D)
            # every model rank routes its own chunk: the router's gradient
            # (and an unsplit shared expert's) sums over "model"
            params = {**dict(params.items()), "router": C.enter(mesh, params["router"], MODEL_AX)}
            if shared is not None and not shared_split:
                shared = {k: C.enter(mesh, w, MODEL_AX) for k, w in dict(shared.items()).items()}

            def experts(buf):
                cap = buf.shape[1]
                mine = C.all_to_all(mesh, buf.reshape(tp, e_loc, cap, D), MODEL_AX)
                y = ffn(mine.transpose(0, 1).reshape(e_loc, tp * cap, D))
                y = y.reshape(e_loc, tp, cap, D).transpose(0, 1)
                return C.all_to_all(mesh, y, MODEL_AX).reshape(E, cap, D)

            out, aux = _routed(params, xf, cfg, experts)
            if shared is not None:
                out = out + _shared_ffn(shared, xf, mesh if shared_split else None,
                                        own_tokens=True)
            out = C.gather(mesh, out.reshape(B, s_loc, D), MODEL_AX, 1)
        else:  # dense_ep
            xf = x.reshape(B * S, D)

            def experts(buf):
                y = ffn(C.take_block(mesh, buf, MODEL_AX, 0))
                return C.gather(mesh, y, MODEL_AX, 0)

            out, aux = _routed(params, xf, cfg, experts)
            if shared is not None:
                out = out + _shared_ffn(shared, xf, mesh if shared_split else None)
            out = out.reshape(B, S, D)
    if mesh is not None:
        # the mean over "model" of partials ("a2a": each rank's own tokens)
        # or of one value every model rank computed alike ("dense_ep")
        aux = (C.mean_of_partials(mesh, aux, (MODEL_AX,)) if own_tokens
               else C.mean_replicated(mesh, aux, MODEL_AX))
        aux = C.mean_of_partials(mesh, aux, batch_axes(mesh))
    return out, aux
