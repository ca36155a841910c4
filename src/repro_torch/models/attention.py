"""Grouped-query attention with RoPE, optional sliding window and soft-cap.

The JAX package's variants: GQA with any kv_heads (MQA kv=1 for
granite-20b, MHA for musicgen/zamba2), gemma2's local (sliding-window) /
global layers with logit soft-capping, prefill (causal over S) and decode
against a KV cache. Plain einsum and softmax, as the JAX package writes it:
the soft-cap comes before the mask, the mask fills with -1e30 (not -inf),
and the softmax runs in f32 and is cast to the compute dtype, none of which
``scaled_dot_product_attention`` keeps.

The cache branch writes the new keys and values into the given cache
tensors in place (the JAX package returns new arrays): a decode tick then
copies no cache.

Tensor parallelism over a mesh's "model" axis (``mesh`` given, ``params``
this rank's slices under ``attention_specs``), Megatron style: q/k/v hold
this rank's heads, ``wo`` its rows of those heads, and the block's output
is one sum over "model" in axis order, of f32 partials rounded to the
compute dtype once (a bf16 model then rounds as one device does). A head
dimension that does not divide the axis stays whole (MQA's single kv
head: every rank computes it and picks the kv head of each of its query
heads). When the cache's kv
heads cannot split, ``cache_specs`` splits its sequence instead
(``seq_sharded``): each rank writes the positions it holds, and attention
combines the ranks' partial softmaxes (flash-decoding): every query head
on every rank, the maximum over "model", then one sum of the rescaled
numerators and denominators. The cache is never gathered. Under autograd
(training, no cache) the block's input enters the head-split region
through ``collectives.enter`` (its cotangent summed over "model"), and a
kv head every rank holds enters where each rank picks its heads.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import collectives as C
from .common import MODEL_AX, Spec, apply_rope, dense_init, soft_cap

Tensor = torch.Tensor


def init_attention(generator, d_model: int, n_heads: int, kv_heads: int, head_dim: int,
                   dtype=torch.float32, device="cuda", pad_heads_to: int = 0
                   ) -> Dict[str, Tensor]:
    def init(shape, in_axis=0):
        return dense_init(generator, shape, in_axis, dtype, device)

    params = {
        "wq": init((d_model, n_heads, head_dim)),
        "wk": init((d_model, kv_heads, head_dim)),
        "wv": init((d_model, kv_heads, head_dim)),
        "wo": init((n_heads, head_dim, d_model)),
    }
    if pad_heads_to and pad_heads_to > n_heads:
        # exact head padding: each GQA group gets zero heads (zero wq rows
        # attend to garbage, zero wo rows keep it out of the output); real
        # head (g, j) lands at g*per_new + j, so _repeat_kv's query -> kv
        # group map is unchanged
        if pad_heads_to % kv_heads:
            raise ValueError(f"pad_heads_to {pad_heads_to} is not a multiple of "
                             f"kv_heads {kv_heads}")
        per_old = n_heads // kv_heads
        per_new = pad_heads_to // kv_heads
        wq = torch.zeros((d_model, pad_heads_to, head_dim), dtype=dtype, device=device)
        wo = torch.zeros((pad_heads_to, head_dim, d_model), dtype=dtype, device=device)
        for g in range(kv_heads):
            wq[:, g * per_new: g * per_new + per_old] = \
                params["wq"][:, g * per_old: (g + 1) * per_old]
            wo[g * per_new: g * per_new + per_old] = params["wo"][g * per_old: (g + 1) * per_old]
        params["wq"], params["wo"] = wq, wo
    return params


def attention_specs(n_heads: int = 0, kv_heads: int = 0, tp: int = 1) -> Dict[str, Spec]:
    """TP specs with divisibility fallbacks: a head dimension that does not
    divide the model axis stays whole (MQA kv=1, starcoder2's 36 heads at
    tp=16)."""
    q_ax = MODEL_AX if tp > 1 and n_heads % tp == 0 else None
    kv_ax = MODEL_AX if tp > 1 and kv_heads % tp == 0 else None
    return {
        "wq": Spec(None, q_ax, None),
        "wk": Spec(None, kv_ax, None),
        "wv": Spec(None, kv_ax, None),
        "wo": Spec(q_ax, None, None),
    }


def _repeat_kv(x: Tensor, n_rep: int) -> Tensor:
    """(B, S, kvH, hd) -> (B, S, kvH*n_rep, hd)"""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def _causal_mask(s_q: int, s_k: int, q_offset, window: Optional[int], device=None) -> Tensor:
    """(s_q, s_k) bool: key position <= query position (offset by
    ``q_offset``) and, with a window, within it."""
    qpos = torch.arange(s_q, device=device)[:, None] + q_offset
    kpos = torch.arange(s_k, device=device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _softmax_out(logits: Tensor, mask: Tensor, vf: Tensor, dtype, attn_softcap) -> Tensor:
    logits = soft_cap(logits, attn_softcap)
    logits = torch.where(mask[None, None], logits, -1e30)
    probs = torch.softmax(logits.float(), dim=-1).to(dtype)
    return torch.einsum("bhqs,bshk->bqhk", probs, vf.to(probs.dtype))


def attend(
    params,
    x: Tensor,  # (B, S, D)
    positions: Tensor,  # (B, S)
    *,
    rope_theta: float = 10_000.0,
    window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
    kv_cache: Optional[Tuple[Tensor, Tensor]] = None,  # (B, S_max, kvH, hd) x2
    cache_index=None,  # int: current fill level
    query_scale: Optional[float] = None,
    mesh=None,
    specs: Optional[Dict[str, Spec]] = None,
    seq_sharded: bool = False,
) -> Tuple[Tensor, Optional[Tuple[Tensor, Tensor]]]:
    """Returns (output (B,S,D), the kv cache written in place, or None).

    Prefill: kv_cache=None, causal over the block. With a cache: the block's
    keys and values are written at ``cache_index`` (the start clamped to
    ``S_max - S``, as ``jax.lax.dynamic_update_slice_in_dim`` clamps it) and
    the block attends over the whole cache, masked to positions <=
    ``cache_index`` + its own offset.

    On a mesh (see the module docstring) ``params`` are this rank's slices
    under ``specs`` (``attention_specs``) and the cache this rank's slice:
    its kv heads, or with ``seq_sharded`` every kv head over its share of
    the positions.
    """
    B, S, D = x.shape
    tp = mesh.axis_size(MODEL_AX) if mesh is not None else 1
    r = mesh.axis_index(MODEL_AX) if tp > 1 else 0
    q_sh = tp > 1 and specs["wq"][1] == MODEL_AX
    kv_sh = tp > 1 and specs["wk"][1] == MODEL_AX
    h_loc, kv_loc, hd = params["wq"].shape[1], params["wk"].shape[1], params["wq"].shape[2]
    n_rep = (h_loc * (tp if q_sh else 1)) // (kv_loc * (tp if kv_sh else 1))
    scale = query_scale if query_scale is not None else hd ** -0.5

    # heads split over "model": the replicated x enters the split region
    # (its cotangent summed over "model"); a kv head every rank holds is
    # computed from x as it is, and enters where each rank picks its heads
    xq = C.enter(mesh, x, MODEL_AX) if q_sh else x
    q = torch.einsum("bsd,dhk->bshk", xq, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", xq if kv_sh else x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", xq if kv_sh else x, params["wv"])
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    if seq_sharded:
        out = _attend_seq_sharded(mesh, q, k, v, kv_cache, int(cache_index), n_rep, scale,
                                  window, attn_softcap, q_sh, x.dtype)
        new_cache = kv_cache
    else:
        if q_sh and not kv_sh:  # every kv head here: the one of each local query head
            kv_of = (r * h_loc + torch.arange(h_loc, device=x.device)) // n_rep
            per_head = lambda t: C.enter(mesh, t, MODEL_AX)[:, :, kv_of]  # noqa: E731
        else:
            per_head = lambda t: _repeat_kv(t, n_rep)  # noqa: E731
        if kv_cache is None:
            kf, vf = per_head(k), per_head(v)
            logits = torch.einsum("bqhk,bshk->bhqs", q, kf) * scale
            mask = _causal_mask(S, S, 0, window, x.device)
            new_cache = None
        else:
            ck, cv = kv_cache
            s_max = ck.shape[1]
            if S > s_max:
                raise ValueError(f"a block of {S} positions does not fit a cache of {s_max}")
            index = int(cache_index)
            start = min(max(index, 0), s_max - S)
            ck[:, start:start + S] = k.to(ck.dtype)
            cv[:, start:start + S] = v.to(cv.dtype)
            kf, vf = per_head(ck), per_head(cv)
            logits = torch.einsum("bqhk,bshk->bhqs", q, kf.to(q.dtype)) * scale
            mask = _causal_mask(S, s_max, index, window, x.device)
            new_cache = (ck, cv)
        out = _softmax_out(logits, mask, vf, x.dtype, attn_softcap)

    if q_sh:  # this rank's heads' share, summed in f32 and rounded once
        y = torch.einsum("bqhk,hkd->bqd", out.float(), params["wo"].float())
        return C.sum_partials(mesh, y, MODEL_AX).to(x.dtype), new_cache
    return torch.einsum("bqhk,hkd->bqd", out, params["wo"]), new_cache


def _attend_seq_sharded(mesh, q, k, v, kv_cache, index: int, n_rep: int, scale, window,
                        attn_softcap, q_sh: bool, dtype) -> Tensor:
    """Attention over a cache whose positions are split over "model" (every
    kv head on every rank): the block's keys and values go to the ranks
    holding their positions, each rank scores every query head against its
    positions, and the partial softmaxes combine over "model" (one maximum,
    one sum of numerators and denominators). Returns this rank's query
    heads' output (B, S, H_loc, hd)."""
    B, S = q.shape[:2]
    h_loc = q.shape[2]
    tp, r = mesh.axis_size(MODEL_AX), mesh.axis_index(MODEL_AX)
    ck, cv = kv_cache
    s_loc = ck.shape[1]
    s_max, off = s_loc * tp, r * s_loc
    if S > s_max:
        raise ValueError(f"a block of {S} positions does not fit a cache of {s_max}")
    start = min(max(index, 0), s_max - S)
    lo, hi = max(start, off), min(start + S, off + s_loc)
    if lo < hi:
        ck[:, lo - off:hi - off] = k[:, lo - start:hi - start].to(ck.dtype)
        cv[:, lo - off:hi - off] = v[:, lo - start:hi - start].to(cv.dtype)
    if q_sh:  # every query head
        q = torch.cat(tuple(mesh.all_gather(q, MODEL_AX)), dim=2)
    kf, vf = _repeat_kv(ck, n_rep), _repeat_kv(cv, n_rep)
    logits = soft_cap(torch.einsum("bqhk,bshk->bhqs", q, kf.to(q.dtype)) * scale, attn_softcap)
    qpos = torch.arange(S, device=q.device)[:, None] + index
    kpos = torch.arange(off, off + s_loc, device=q.device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits, -1e30).float()
    top = mesh.pmax(logits.amax(-1), MODEL_AX)  # (B, H, S): a live position somewhere
    e = torch.exp(logits - top[..., None])
    num = torch.einsum("bhqs,bshk->bqhk", e, vf.float())
    den = e.sum(-1).permute(0, 2, 1)[..., None]  # (B, S, H, 1)
    both = mesh.psum(torch.cat([num, den], dim=-1), MODEL_AX)
    out = (both[..., :-1] / both[..., -1:]).to(dtype)
    if q_sh:
        out = out[:, :, r * h_loc:(r + 1) * h_loc]
    return out
