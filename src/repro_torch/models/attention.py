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
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .common import apply_rope, dense_init, soft_cap

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
) -> Tuple[Tensor, Optional[Tuple[Tensor, Tensor]]]:
    """Returns (output (B,S,D), the kv cache written in place, or None).

    Prefill: kv_cache=None, causal over the block. With a cache: the block's
    keys and values are written at ``cache_index`` (the start clamped to
    ``S_max - S``, as ``jax.lax.dynamic_update_slice_in_dim`` clamps it) and
    the block attends over the whole cache, masked to positions <=
    ``cache_index`` + its own offset.
    """
    B, S, D = x.shape
    n_heads = params["wq"].shape[1]
    kv_heads = params["wk"].shape[1]
    hd = params["wq"].shape[2]
    n_rep = n_heads // kv_heads
    scale = query_scale if query_scale is not None else hd ** -0.5

    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    if kv_cache is None:
        kf = _repeat_kv(k, n_rep)
        vf = _repeat_kv(v, n_rep)
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
        kf = _repeat_kv(ck, n_rep)
        vf = _repeat_kv(cv, n_rep)
        logits = torch.einsum("bqhk,bshk->bhqs", q, kf.to(q.dtype)) * scale
        mask = _causal_mask(S, s_max, index, window, x.device)
        new_cache = (ck, cv)

    out = _softmax_out(logits, mask, vf, x.dtype, attn_softcap)
    y = torch.einsum("bqhk,hkd->bqd", out, params["wo"])
    return y, new_cache
