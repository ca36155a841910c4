"""Decoder LM covering the JAX package's architecture families.

One ``ModelConfig`` describes dense (llama/starcoder/granite/minitron),
gemma2 (alternating local/global attention, soft-caps, post-norms, scaled
embeddings), MoE (deepseek-moe/olmoe, dispatch through the SpMM), SSM
(mamba2), hybrid (zamba2: a mamba backbone and one weight-shared attention
block after every ``hybrid_every`` layers) and embeds-input stubs (pixtral
vision / musicgen audio frontends).

The model is a ``common.ParamTree`` whose parameters keep the JAX package's
names, shapes and axis orders, with ``layers`` an ``nn.ModuleList`` (one
entry a layer, where the JAX package stacks them on a leading axis for
``lax.scan``). The JAX package keeps f32 master weights and casts every f32
parameter with ndim > 1 to the compute dtype inside each layer; the port
does the same at the point of use. A serving model (``init_params``'s
default) holds those parameters in the compute dtype already, where the
cast returns the tensor as it is; a training model (``master=True``) holds
f32 masters, which AdamW updates. 1-D parameters stay f32 in both.

``forward`` and ``lm_loss`` are differentiable. With ``cfg.remat`` and
grad enabled each layer (the hybrid: each group with its shared block)
runs under ``torch.utils.checkpoint`` and is recomputed in the backward,
where the JAX package wraps the same bodies in ``jax.checkpoint``.

Serving runs under ``torch.inference_mode()``. Caches keep the JAX
package's stacked layout (a leading layer axis, or one entry per
application of the hybrid's shared block) and are written in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn_mod
from . import mlp as mlp_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .common import ParamTree, dense_init, embed_init, rms_norm, soft_cap

Tensor = torch.Tensor

NO_WINDOW = 2**30  # a window wider than any sequence: unconstrained attention


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    act: str = "swiglu"
    rope_theta: float = 10_000.0
    family: str = "attn"  # "attn" | "ssm" | "hybrid"
    # gemma2-style features
    local_global_alt: bool = False
    window: Optional[int] = None
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    query_scale: Optional[float] = None
    use_post_norms: bool = False
    embed_scale: bool = False
    # MoE / SSM / hybrid
    moe: Optional[moe_mod.MoEConfig] = None
    ssm: Optional[ssm_mod.SSMConfig] = None
    hybrid_every: int = 6
    # IO
    input_mode: str = "tokens"  # "tokens" | "embeds" (modality-frontend stub)
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    supports_long_context: bool = False  # sub-quadratic decode state
    # Megatron-style vocab padding; padded logits are masked to -1e30, so
    # sampling is exact
    vocab_pad_multiple: int = 128
    # the JAX package's sharding knobs: pad attention heads per GQA group
    # with zero heads (function-exact); the activation sharding constraint
    # between layers (no effect on one card)
    pad_heads_to: int = 0
    act_sharding: Optional[str] = None

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab + m - 1) // m * m

    @property
    def eff_heads(self) -> int:
        return self.pad_heads_to or self.n_heads

    @property
    def hdim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def compute_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    def active_param_count(self) -> int:
        """Approximate activated params per token (for 6·N·D MODEL_FLOPS)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        if self.family in ("ssm", "hybrid"):
            cfg = self.ssm
            di = cfg.d_inner(D)
            per_layer = D * di * 2 + D * (2 * cfg.n_groups * cfg.d_state) + di * D
            if self.family == "hybrid":
                # shared attention block amortized over hybrid_every layers
                shared = (
                    D * self.n_heads * self.hdim * 2
                    + D * self.kv_heads * self.hdim * 2
                    + 3 * D * F
                )
                per_layer += shared // self.hybrid_every
        else:
            attn = D * self.n_heads * self.hdim * 2 + D * self.kv_heads * self.hdim * 2
            if self.moe:
                m = self.moe
                ffn = m.top_k * 3 * D * m.d_expert + m.n_shared * 3 * D * m.d_expert
            else:
                ffn = (3 if self.act == "swiglu" else 2) * D * F
            per_layer = attn + ffn
        return L * per_layer + V * D  # + unembed


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _as_model(cfg: ModelConfig, tree: Dict[str, Any], master: bool = False) -> ParamTree:
    """The model holding ``tree``: every tensor with ndim > 1 in the
    compute dtype (f32 with ``master``), the rest in f32."""
    cd = torch.float32 if master else cfg.compute_dtype

    def cast(node):
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [cast(v) for v in node]
        return node.to(cd if node.dim() > 1 else torch.float32)

    return ParamTree(cast(tree))


def _at_use(cfg: ModelConfig, node):
    """``node`` (a tensor, or a ``ParamTree`` or dict of them) with every
    f32 tensor of ndim > 1 in the compute dtype, as the JAX package casts a
    layer's parameters inside its body; a tensor already in that dtype is
    returned as it is."""
    if isinstance(node, torch.Tensor):
        if node.dtype == torch.float32 and node.dim() > 1:
            return node.to(cfg.compute_dtype)
        return node
    return {k: _at_use(cfg, v) for k, v in node.items()}


def _attn_block_init(cfg: ModelConfig, generator, dtype, device, pad_heads_to=0):
    return attn_mod.init_attention(generator, cfg.d_model, cfg.n_heads, cfg.kv_heads,
                                   cfg.hdim, dtype, device, pad_heads_to=pad_heads_to)


def init_params(cfg: ModelConfig, generator, device="cuda", master: bool = False) -> ParamTree:
    """The port's seeded init (other numbers than the JAX package's from
    the same seed). ``generator`` lives on ``device``; on the "meta" device
    (generator None) this gives the model's structure without memory.
    ``master`` keeps every parameter in f32 (the training model: the
    compute dtype is applied at use)."""
    dtype = torch.float32 if master else cfg.compute_dtype
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)  # noqa: E731
    params: Dict[str, Any] = {}
    if cfg.input_mode == "tokens":
        params["embed"] = embed_init(generator, (cfg.padded_vocab, cfg.d_model), dtype, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (cfg.d_model, cfg.padded_vocab),
                                       dtype=dtype, device=device)
    params["final_norm"] = zeros()

    layers: List[Dict[str, Any]] = []
    for _ in range(cfg.n_layers):
        if cfg.family == "attn":
            lp = {"ln1": zeros(), "ln2": zeros(),
                  "attn": _attn_block_init(cfg, generator, dtype, device, cfg.pad_heads_to)}
            if cfg.use_post_norms:
                lp["ln1_post"] = zeros()
                lp["ln2_post"] = zeros()
            if cfg.moe:
                lp["moe"] = moe_mod.init_moe(generator, cfg.d_model, cfg.moe, dtype, device)
            else:
                lp["mlp"] = mlp_mod.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act,
                                             dtype, device)
        elif cfg.family in ("ssm", "hybrid"):
            lp = {"ln": zeros(),
                  "mamba": ssm_mod.init_mamba2(generator, cfg.d_model, cfg.ssm, dtype, device)}
        else:
            raise ValueError(cfg.family)
        layers.append(lp)
    params["layers"] = layers
    if cfg.family == "hybrid":
        params["shared_block"] = {
            "ln1": zeros(), "ln2": zeros(),
            "attn": _attn_block_init(cfg, generator, dtype, device),
            "mlp": mlp_mod.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act, dtype, device),
        }
    return _as_model(cfg, params, master)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer attention window (gemma2 alternation: even layers local,
    odd global); NO_WINDOW where unconstrained."""
    if cfg.local_global_alt:
        return [cfg.window if i % 2 == 0 else NO_WINDOW for i in range(cfg.n_layers)]
    return [cfg.window if cfg.window is not None else NO_WINDOW] * cfg.n_layers


def _attn_layer_fwd(cfg: ModelConfig, lp, h, positions, window,
                    kv_cache=None, cache_index=None, moe_mode="a2a"):
    att, new_cache = attn_mod.attend(
        lp["attn"], rms_norm(h, lp["ln1"]), positions,
        rope_theta=cfg.rope_theta, window=window,
        attn_softcap=cfg.attn_softcap, query_scale=cfg.query_scale,
        kv_cache=kv_cache, cache_index=cache_index,
    )
    if cfg.use_post_norms:
        att = rms_norm(att, lp["ln1_post"])
    h = h + att
    ff_in = rms_norm(h, lp["ln2"])
    if cfg.moe:
        ff, aux = moe_mod.moe_layer(lp["moe"], ff_in, cfg.moe, mode=moe_mode)
    else:
        ff, aux = mlp_mod.mlp(lp["mlp"], ff_in, cfg.act), None
    if cfg.use_post_norms:
        ff = rms_norm(ff, lp["ln2_post"])
    return h + ff, aux, new_cache


def _shared_block_fwd(cfg: ModelConfig, sp, h, positions, kv_cache=None, cache_index=None):
    att, _ = attn_mod.attend(
        sp["attn"], rms_norm(h, sp["ln1"]), positions,
        rope_theta=cfg.rope_theta, query_scale=cfg.query_scale,
        kv_cache=kv_cache, cache_index=cache_index,
    )
    h = h + att
    return h + mlp_mod.mlp(sp["mlp"], rms_norm(h, sp["ln2"]), cfg.act)


def _embed(cfg: ModelConfig, params, inputs: Tensor) -> Tensor:
    cd = cfg.compute_dtype
    if cfg.input_mode == "tokens":  # cast after the gather: no cast copy of the table
        h = params["embed"][inputs.long()].to(cd)
    else:
        h = inputs.to(cd)
    if cfg.embed_scale:  # sqrt(d_model) in f32, rounded to the compute dtype
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32).to(cd)
    return h


def _mask_pad_vocab(cfg: ModelConfig, logits: Tensor) -> Tensor:
    """Padded vocab entries get -1e30 so softmax/argmax are exact."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    live = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
    return torch.where(live, logits, -1e30)


def _logits(cfg: ModelConfig, params, h: Tensor) -> Tensor:
    """(B, S, padded vocab) f32: final norm, unembed, soft-cap, pad mask."""
    h = rms_norm(h, params["final_norm"])
    w_out = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.einsum("bsd,dv->bsv", h, w_out.to(cfg.compute_dtype))
    return _mask_pad_vocab(cfg, soft_cap(logits.float(), cfg.final_softcap))


def _mamba_groups(cfg: ModelConfig) -> List[range]:
    """The hybrid's layer groups, each followed by one application of the
    shared block."""
    k = cfg.hybrid_every
    if cfg.n_layers % k:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of hybrid_every {k}")
    return [range(g * k, (g + 1) * k) for g in range(cfg.n_layers // k)]


# ---------------------------------------------------------------------------
# forward (training, and prefill without a cache)
# ---------------------------------------------------------------------------
def _remat(cfg: ModelConfig, body, *args):
    """``body(*args)``, recomputed in the backward when ``cfg.remat`` and
    grad are on (``jax.checkpoint`` of the JAX package's scan bodies)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(body, *args, use_reentrant=False)
    return body(*args)


def forward(cfg: ModelConfig, params, inputs: Tensor) -> Tuple[Tensor, Tensor]:
    """inputs (B,S) tokens or (B,S,D) embeds. Returns (logits (B,S,padded
    vocab) f32, aux loss scalar). Differentiable; run it under
    ``torch.no_grad()`` or ``inference_mode()`` to serve."""
    h = _embed(cfg, params, inputs)
    B, S = h.shape[0], h.shape[1]
    positions = torch.arange(S, device=h.device).expand(B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    layers = params["layers"]
    if cfg.family == "attn":
        def body(h, lp, window):
            h, aux, _ = _attn_layer_fwd(cfg, _at_use(cfg, lp), h, positions, window)
            return h, aux

        for lp, window in zip(layers, _layer_windows(cfg)):
            h, aux = _remat(cfg, body, h, lp, window)
            if aux is not None:
                aux_total = aux_total + aux
    elif cfg.family == "ssm":
        def body(h, lp):
            return h + ssm_mod.mamba2_block(_at_use(cfg, lp["mamba"]), rms_norm(h, lp["ln"]),
                                            cfg.ssm)

        for lp in layers:
            h = _remat(cfg, body, h, lp)
    else:  # hybrid
        def group_body(h, group):
            for i in group:
                lp = layers[i]
                h = h + ssm_mod.mamba2_block(_at_use(cfg, lp["mamba"]), rms_norm(h, lp["ln"]),
                                             cfg.ssm)
            return _shared_block_fwd(cfg, _at_use(cfg, params["shared_block"]), h, positions)

        for group in _mamba_groups(cfg):
            h = _remat(cfg, group_body, h, group)
    return _logits(cfg, params, h), aux_total


def lm_loss(cfg: ModelConfig, params, inputs: Tensor, targets: Tensor,
            aux_weight: float = 0.01) -> Tensor:
    """Mean next-token cross entropy over (B, S) plus ``aux_weight`` times
    the MoE balance loss: the JAX package's ``lm_loss`` on one device,
    whose vocab-parallel form (``_sharded_xent``) it equals on a 1 x 1 mesh.
    The padded vocab's logits are -1e30, so they take no probability."""
    logits, aux = forward(cfg, params, inputs)
    lse = torch.logsumexp(logits, dim=-1)  # (B, S)
    target = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (lse - target).mean() + aux_weight * aux


# ---------------------------------------------------------------------------
# serving: KV / SSM state caches, prefill, single-token decode
# ---------------------------------------------------------------------------
@torch.inference_mode()
def init_cache(cfg: ModelConfig, batch: int, s_max: int, device="cuda") -> Dict[str, Tensor]:
    """Decode state. Attention: k/v (L, B, S_max, kvH, hd). SSM: conv (L, B,
    d_conv-1, conv_dim) in the compute dtype and ssm (L, B, H, P, N) in
    f32. Hybrid: the SSM states and k/v per application of the shared
    block."""
    cd = cfg.compute_dtype
    cache: Dict[str, Tensor] = {}
    if cfg.family in ("ssm", "hybrid"):
        states = [ssm_mod.init_mamba2_state(cfg.ssm, cfg.d_model, batch, cd, device)
                  for _ in range(cfg.n_layers)]
        cache["conv"] = torch.stack([conv for conv, _ in states])
        cache["ssm"] = torch.stack([st for _, st in states])
    if cfg.family in ("attn", "hybrid"):
        n = cfg.n_layers if cfg.family == "attn" else cfg.n_layers // cfg.hybrid_every
        shape = (n, batch, s_max, cfg.kv_heads, cfg.hdim)
        cache["k"] = torch.zeros(shape, dtype=cd, device=device)
        cache["v"] = torch.zeros(shape, dtype=cd, device=device)
    return cache


def _run_cached(cfg: ModelConfig, params, cache, h, positions, cache_index, decode: bool):
    """Every layer over h with the cache written in place: ``decode`` runs
    the recurrent SSM step and the MoE's "dense_ep" mode, else the chunked
    SSM scan and "a2a" (the JAX package's prefill and decode)."""
    layers = params["layers"]

    def mamba(i, h):
        lp = layers[i]
        x, state = rms_norm(h, lp["ln"]), (cache["conv"][i], cache["ssm"][i])
        mp = _at_use(cfg, lp["mamba"])
        if decode:
            out, (conv, st) = ssm_mod.mamba2_decode_step(mp, x, cfg.ssm, state)
        else:
            out, (conv, st) = ssm_mod.mamba2_block(mp, x, cfg.ssm, state=state,
                                                   return_state=True)
        cache["conv"][i] = conv
        cache["ssm"][i] = st
        return h + out

    if cfg.family == "attn":
        mode = "dense_ep" if decode else "a2a"
        for i, (lp, window) in enumerate(zip(layers, _layer_windows(cfg))):
            h, _, _ = _attn_layer_fwd(cfg, _at_use(cfg, lp), h, positions, window,
                                      kv_cache=(cache["k"][i], cache["v"][i]),
                                      cache_index=cache_index, moe_mode=mode)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            h = mamba(i, h)
    else:  # hybrid
        for g, group in enumerate(_mamba_groups(cfg)):
            for i in group:
                h = mamba(i, h)
            h = _shared_block_fwd(cfg, _at_use(cfg, params["shared_block"]), h, positions,
                                  kv_cache=(cache["k"][g], cache["v"][g]),
                                  cache_index=cache_index)
    return h


@torch.inference_mode()
def decode_step(cfg: ModelConfig, params, cache: Dict[str, Tensor], inputs: Tensor,
                cache_index) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One new token for every sequence: inputs (B,1) tokens or (B,1,D)
    embeds, ``cache_index`` (int) the number of tokens already in the cache.
    Returns (logits (B, vocab) f32, the cache, updated in place)."""
    h = _embed(cfg, params, inputs)
    positions = torch.full((h.shape[0], 1), int(cache_index), device=h.device)
    h = _run_cached(cfg, params, cache, h, positions, cache_index, decode=True)
    return _logits(cfg, params, h)[:, 0, :cfg.vocab], cache


@torch.inference_mode()
def prefill(cfg: ModelConfig, params, inputs: Tensor, s_max: int
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Forward over the prompt (B,S) / (B,S,D), building the decode cache.
    Returns (last-position logits (B, vocab) f32, cache filled to S)."""
    B, S = inputs.shape[0], inputs.shape[1]
    cache = init_cache(cfg, B, s_max, inputs.device)
    h = _embed(cfg, params, inputs)
    positions = torch.arange(S, device=h.device).expand(B, S)
    h = _run_cached(cfg, params, cache, h, positions, 0, decode=False)
    return _logits(cfg, params, h[:, -1:])[:, 0, :cfg.vocab], cache
