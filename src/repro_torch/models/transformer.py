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

Serving on a process mesh (``launch.mesh``; ``prefill``, ``decode_step``
and ``init_cache`` take ``mesh``): the model is this rank's slices under
``param_specs(cfg, tp)`` (``shard_tree``, ``init_params(..., mesh=)`` or
``core.convert.lm_params_from_reference(..., mesh=)``) and the cache its
slice under ``cache_specs``. Inputs and logits are global: the batch is
split over the data axes when it divides them (else every data rank runs
all of it, as the JAX package's step builders replicate a batch of 1),
and the logits are gathered over "model" (vocab) and the data axes once.
Over "model": an untied embedding splits its hidden dimension (gathered
after the lookup), a tied one its vocab (a masked lookup, summed);
attention and the MLP are Megatron's, the MoE expert parallel ("a2a" at
prefill, "dense_ep" at decode), and the residual stream stays whole on
every rank: the JAX package's ``_act_constraint`` and
``_gather_for_attn`` act only under ``act_sharding="seq"``, which no
config sets, and are not ported. The Mamba2 blocks of the ssm and hybrid
families are tensor parallel as ``ssm`` describes, and the hybrid's
shared block is Megatron's attention and MLP, its KV cache split as an
attention layer's.

Training on a mesh (``forward``/``lm_loss(..., mesh=)``, or
``lm_loss_shard`` on this rank's share of the batch): the same paths,
every collective differentiable (``collectives``), the MoE in "a2a", and
the vocab-parallel cross entropy (``_VocabParallelXent``). Every rank
holds the global loss, and its gradient is what its share of the batch
contributes; summed over the data axes it is the gradient of the loss.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn_mod
from . import collectives as C
from . import mlp as mlp_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .common import (MODEL_AX, ParamTree, Spec, batch_axes, batch_shard, dense_init,
                     embed_init, gather_tensor, leaf_spec, rms_norm, shard_index, shard_tensor,
                     soft_cap, unflatten)

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


def init_params(cfg: ModelConfig, generator, device="cuda", master: bool = False,
                mesh=None) -> ParamTree:
    """The port's seeded init (other numbers than the JAX package's from
    the same seed). ``generator`` lives on ``device``; on the "meta" device
    (generator None) this gives the model's structure without memory.
    ``master`` keeps every parameter in f32 (the training model: the
    compute dtype is applied at use). With ``mesh`` each block is drawn
    whole (the same model for one seed on any mesh) and cut to this
    rank's slices under ``param_specs`` at once, so no rank holds the
    whole model."""
    dtype = torch.float32 if master else cfg.compute_dtype
    specs = param_specs(cfg, _tp(mesh)) if mesh is not None else None

    def cut(tree, name):
        if specs is None:
            return tree
        if isinstance(tree, dict):
            return {k: cut(v, f"{name}.{k}") for k, v in tree.items()}
        return shard_tensor(tree, leaf_spec(specs, name), mesh)

    zeros = lambda: torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)  # noqa: E731
    params: Dict[str, Any] = {}
    if cfg.input_mode == "tokens":
        params["embed"] = cut(embed_init(generator, (cfg.padded_vocab, cfg.d_model), dtype,
                                         device), "embed")
    if not cfg.tie_embeddings:
        params["lm_head"] = cut(dense_init(generator, (cfg.d_model, cfg.padded_vocab),
                                           dtype=dtype, device=device), "lm_head")
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
        layers.append(cut(lp, f"layers.{len(layers)}"))
    params["layers"] = layers
    if cfg.family == "hybrid":
        params["shared_block"] = cut({
            "ln1": zeros(), "ln2": zeros(),
            "attn": _attn_block_init(cfg, generator, dtype, device),
            "mlp": mlp_mod.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act, dtype, device),
        }, "shared_block")
    return _as_model(cfg, params, master)


def param_specs(cfg: ModelConfig, tp: int = 1) -> Dict[str, Any]:
    """The spec tree of the parameters (``layers`` stacked, a leading None),
    the JAX package's: tp is the "model" axis's size, and a dimension that
    does not divide it stays whole."""
    d_ax = MODEL_AX if tp > 1 and cfg.d_model % tp == 0 else None
    v_ax = MODEL_AX if tp > 1 and cfg.padded_vocab % tp == 0 else None
    specs: Dict[str, Any] = {"final_norm": Spec(None)}
    if cfg.input_mode == "tokens":
        # untied: split the hidden dimension (the lookup needs no sum);
        # tied: split the vocab, so the unembed keeps the logits vocab-split
        specs["embed"] = Spec(v_ax, None) if cfg.tie_embeddings else Spec(None, d_ax)
    if not cfg.tie_embeddings:
        specs["lm_head"] = Spec(None, v_ax)

    def stack(node):  # prepend the (whole) layer axis
        if isinstance(node, Spec):
            return Spec(None, *node)
        return {k: stack(v) for k, v in node.items()}

    if cfg.family == "attn":
        lp = {"ln1": Spec(None), "ln2": Spec(None),
              "attn": attn_mod.attention_specs(cfg.eff_heads, cfg.kv_heads, tp)}
        if cfg.use_post_norms:
            lp["ln1_post"] = Spec(None)
            lp["ln2_post"] = Spec(None)
        if cfg.moe:
            lp["moe"] = moe_mod.moe_specs(cfg.moe, tp)
        else:
            lp["mlp"] = mlp_mod.mlp_specs(cfg.act, cfg.d_ff, tp)
        specs["layers"] = stack(lp)
    else:
        specs["layers"] = stack({"ln": Spec(None),
                                 "mamba": ssm_mod.mamba2_specs(cfg.ssm, cfg.d_model, tp)})
        if cfg.family == "hybrid":
            specs["shared_block"] = {
                "ln1": Spec(None),
                "ln2": Spec(None),
                "attn": attn_mod.attention_specs(cfg.n_heads, cfg.kv_heads, tp),
                "mlp": mlp_mod.mlp_specs(cfg.act, cfg.d_ff, tp),
            }
    return specs


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameters' shapes as the JAX package's tree holds them, in
    ``param_specs``' tree: ``layers`` stacked on a leading layer axis."""
    flat: Dict[str, Tuple[int, ...]] = {}
    for name, p in init_params(cfg, None, "meta").named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            flat[".".join(["layers"] + parts[2:])] = (cfg.n_layers,) + tuple(p.shape)
        else:
            flat[name] = tuple(p.shape)
    return unflatten(flat)


def cache_specs(cfg: ModelConfig, mesh, batch: Optional[int] = None,
                s_max: Optional[int] = None) -> Dict[str, Any]:
    """The cache's spec tree, the JAX package's: the batch over the data
    axes (when it divides them), kv heads over "model"; when the kv heads
    cannot split (MQA, kv < tp) the SEQUENCE splits over "model" instead
    (when s_max divides it), and attention combines partial softmaxes
    over it (flash-decoding)."""
    dp = batch_axes(mesh)
    bspec = dp if batch is None else batch_shard(mesh, batch)
    tp = mesh.shape[MODEL_AX]
    head_ax = MODEL_AX if cfg.kv_heads % tp == 0 and cfg.kv_heads >= tp else None
    seq_ax = None
    if head_ax is None and tp > 1 and (s_max is None or s_max % tp == 0):
        seq_ax = MODEL_AX
    specs: Dict[str, Any] = {}
    if cfg.family in ("attn", "hybrid"):
        specs["k"] = Spec(None, bspec, seq_ax, head_ax, None)
        specs["v"] = Spec(None, bspec, seq_ax, head_ax, None)
    if cfg.family in ("ssm", "hybrid"):
        nh = cfg.ssm.n_heads(cfg.d_model)
        ssm_head_ax = MODEL_AX if nh % tp == 0 else None
        specs["conv"] = Spec(None, bspec, None, None)
        specs["ssm"] = Spec(None, bspec, ssm_head_ax, None, None)
    return specs


def _tp(mesh) -> int:
    return mesh.shape.get(MODEL_AX, 1) if mesh is not None else 1


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
                    kv_cache=None, cache_index=None, moe_mode="a2a", mesh=None, tp_specs=None,
                    seq_sharded=False):
    """One attention layer. On a mesh ``lp`` holds this rank's slices and
    ``tp_specs`` the layer's ``{"attn": ..., "mlp": ...}`` specs."""
    tp_specs = tp_specs or {}
    att, new_cache = attn_mod.attend(
        lp["attn"], rms_norm(h, lp["ln1"]), positions,
        rope_theta=cfg.rope_theta, window=window,
        attn_softcap=cfg.attn_softcap, query_scale=cfg.query_scale,
        kv_cache=kv_cache, cache_index=cache_index,
        mesh=mesh, specs=tp_specs.get("attn"), seq_sharded=seq_sharded,
    )
    if cfg.use_post_norms:
        att = rms_norm(att, lp["ln1_post"])
    h = h + att
    ff_in = rms_norm(h, lp["ln2"])
    if cfg.moe:
        ff, aux = moe_mod.moe_layer(lp["moe"], ff_in, cfg.moe, mode=moe_mode, mesh=mesh)
    else:
        ff, aux = mlp_mod.mlp(lp["mlp"], ff_in, cfg.act, mesh, tp_specs.get("mlp")), None
    if cfg.use_post_norms:
        ff = rms_norm(ff, lp["ln2_post"])
    return h + ff, aux, new_cache


def _shared_block_fwd(cfg: ModelConfig, sp, h, positions, kv_cache=None, cache_index=None,
                      mesh=None, tp_specs=None, seq_sharded=False):
    """The hybrid's shared block. On a mesh ``sp`` holds this rank's slices
    and ``tp_specs`` the block's ``{"attn": ..., "mlp": ...}`` specs."""
    tp_specs = tp_specs or {}
    att, _ = attn_mod.attend(
        sp["attn"], rms_norm(h, sp["ln1"]), positions,
        rope_theta=cfg.rope_theta, query_scale=cfg.query_scale,
        kv_cache=kv_cache, cache_index=cache_index,
        mesh=mesh, specs=tp_specs.get("attn"), seq_sharded=seq_sharded,
    )
    h = h + att
    return h + mlp_mod.mlp(sp["mlp"], rms_norm(h, sp["ln2"]), cfg.act, mesh,
                           tp_specs.get("mlp"))


def _embed(cfg: ModelConfig, params, inputs: Tensor, mesh=None) -> Tensor:
    cd = cfg.compute_dtype
    if cfg.input_mode == "tokens":  # cast after the gather: no cast copy of the table
        table, tok = params["embed"], inputs.long()
        split = _vocab_split(cfg, mesh) if cfg.tie_embeddings else None
        if split is not None:  # this rank's vocab rows: a masked lookup, summed
            off = split * table.shape[0]
            local = tok - off
            hit = (local >= 0) & (local < table.shape[0])
            h = torch.where(hit[..., None], table[local.clamp(0, table.shape[0] - 1)], 0)
            h = C.sum_partials(mesh, h, MODEL_AX)
        else:
            h = table[tok]
            if mesh is not None and table.shape[1] < cfg.d_model:  # hidden split: gather
                h = C.gather(mesh, h, MODEL_AX, 2)
        h = h.to(cd)
    else:
        h = inputs.to(cd)
    if cfg.embed_scale:  # sqrt(d_model) in f32, rounded to the compute dtype
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32).to(cd)
    return h


def _vocab_split(cfg: ModelConfig, mesh) -> Optional[int]:
    """This rank's vocab block when the unembed splits the vocab over
    "model", else None."""
    if _tp(mesh) == 1:
        return None
    spec = param_specs(cfg, _tp(mesh))["embed" if cfg.tie_embeddings else "lm_head"]
    ax = spec[0] if cfg.tie_embeddings else spec[1]
    return mesh.axis_index(MODEL_AX) if ax == MODEL_AX else None


def _mask_pad_vocab(cfg: ModelConfig, logits: Tensor, offset: int = 0) -> Tensor:
    """Padded vocab entries get -1e30 so softmax/argmax are exact;
    ``logits`` hold the vocab from ``offset`` on."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    live = torch.arange(offset, offset + logits.shape[-1], device=logits.device) < cfg.vocab
    return torch.where(live, logits, -1e30)


def _logits_block(cfg: ModelConfig, params, h: Tensor, mesh=None) -> Tuple[Tensor, int]:
    """(logits f32 of this rank's vocab block, the block's first vocab
    entry): final norm, unembed, soft-cap, pad mask. Without a vocab split
    the block is the whole padded vocab."""
    h = rms_norm(h, params["final_norm"])
    w_out = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    split = _vocab_split(cfg, mesh)
    if split is not None:  # the replicated h enters the vocab-split unembed
        h = C.enter(mesh, h, MODEL_AX)
    logits = torch.einsum("bsd,dv->bsv", h, w_out.to(cfg.compute_dtype))
    offset = 0 if split is None else split * w_out.shape[1]
    return _mask_pad_vocab(cfg, soft_cap(logits.float(), cfg.final_softcap), offset), offset


def _logits(cfg: ModelConfig, params, h: Tensor, mesh=None) -> Tensor:
    """(B, S, padded vocab) f32. On a mesh whose "model" axis splits the
    vocab, each rank computes its block and the blocks are gathered once."""
    logits, _ = _logits_block(cfg, params, h, mesh)
    if _vocab_split(cfg, mesh) is not None:
        logits = C.gather(mesh, logits, MODEL_AX, 2)
    return logits


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


def _hidden(cfg: ModelConfig, params, inputs: Tensor, shard: Optional["_Shard"] = None
            ) -> Tuple[Tensor, Tensor]:
    """(the last layer's output, aux loss): the embedding and every layer,
    on this rank's share of the batch with ``shard``."""
    mesh = shard.mesh if shard is not None else None
    tp_kw = dict(mesh=mesh, tp_specs=shard.layer) if shard is not None else {}
    shared_kw = dict(mesh=mesh, tp_specs=shard.shared) if shard is not None else {}
    ssm_kw = dict(mesh=mesh, specs=shard.layer["mamba"]) if shard is not None else {}
    h = _embed(cfg, params, inputs, mesh)
    B, S = h.shape[0], h.shape[1]
    positions = torch.arange(S, device=h.device).expand(B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    layers = params["layers"]
    if cfg.family == "attn":
        def body(h, lp, window):
            h, aux, _ = _attn_layer_fwd(cfg, _at_use(cfg, lp), h, positions, window, **tp_kw)
            return h, aux

        for lp, window in zip(layers, _layer_windows(cfg)):
            h, aux = _remat(cfg, body, h, lp, window)
            if aux is not None:
                aux_total = aux_total + aux
    elif cfg.family == "ssm":
        def body(h, lp):
            return h + ssm_mod.mamba2_block(_at_use(cfg, lp["mamba"]), rms_norm(h, lp["ln"]),
                                            cfg.ssm, **ssm_kw)

        for lp in layers:
            h = _remat(cfg, body, h, lp)
    else:  # hybrid
        def group_body(h, group):
            for i in group:
                lp = layers[i]
                h = h + ssm_mod.mamba2_block(_at_use(cfg, lp["mamba"]), rms_norm(h, lp["ln"]),
                                             cfg.ssm, **ssm_kw)
            return _shared_block_fwd(cfg, _at_use(cfg, params["shared_block"]), h, positions,
                                     **shared_kw)

        for group in _mamba_groups(cfg):
            h = _remat(cfg, group_body, h, group)
    return h, aux_total


def forward(cfg: ModelConfig, params, inputs: Tensor, mesh=None) -> Tuple[Tensor, Tensor]:
    """inputs (B,S) tokens or (B,S,D) embeds. Returns (logits (B,S,padded
    vocab) f32, aux loss scalar). Differentiable; run it under
    ``torch.no_grad()`` or ``inference_mode()`` to serve. With ``mesh``:
    global inputs and logits, this rank's model slices (``param_specs``),
    the batch split over the data axes (it must divide them), the MoE in
    "a2a" mode, as the JAX package's training forward."""
    if mesh is None:
        h, aux = _hidden(cfg, params, inputs)
        return _logits(cfg, params, h), aux
    shard = _Shard(cfg, mesh, inputs.shape[0], train=True)
    h, aux = _hidden(cfg, params, shard.local(inputs), shard)
    logits = _logits(cfg, params, h, mesh)
    return C.gather(mesh, logits, shard.batch, 0), aux


def lm_loss(cfg: ModelConfig, params, inputs: Tensor, targets: Tensor, mesh=None,
            aux_weight: float = 0.01) -> Tensor:
    """Mean next-token cross entropy over (B, S) plus ``aux_weight`` times
    the MoE balance loss: the JAX package's ``lm_loss``. The padded vocab's
    logits are -1e30, so they take no probability. With ``mesh``: global
    inputs and targets (``lm_loss_shard`` takes this rank's share)."""
    if mesh is None:
        logits, aux = forward(cfg, params, inputs)
        lse = torch.logsumexp(logits, dim=-1)  # (B, S)
        target = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
        return (lse - target).mean() + aux_weight * aux
    shard = _Shard(cfg, mesh, inputs.shape[0], train=True)
    return lm_loss_shard(cfg, params, shard.local(inputs), shard.local(targets), mesh,
                         aux_weight)


def lm_loss_shard(cfg: ModelConfig, params, inputs: Tensor, targets: Tensor, mesh,
                  aux_weight: float = 0.01) -> Tensor:
    """``lm_loss`` on ``mesh`` from this rank's share of the global batch
    (split over the data axes): the JAX package's mesh loss, ``nll.mean()``
    over the global batch (each rank's mean, averaged over the data axes)
    plus ``aux_weight`` times the aux mean over every axis, the same value
    on every rank. Its gradient on a rank is what that rank's share
    contributes: summed over the data axes, the gradient of the loss. The
    cross entropy is vocab-parallel (``_VocabParallelXent``) when the
    unembed splits the vocab over "model"."""
    shard = _Shard(cfg, mesh, inputs.shape[0] * _dp_size(mesh), train=True)
    h, aux = _hidden(cfg, params, inputs, shard)
    logits, offset = _logits_block(cfg, params, h, mesh)
    if _vocab_split(cfg, mesh) is None:
        lse = torch.logsumexp(logits, dim=-1)
        nll = lse - torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    else:
        nll = _VocabParallelXent.apply(logits, targets.long(), mesh, offset)
    return C.mean_of_partials(mesh, nll.mean(), batch_axes(mesh)) + aux_weight * aux


def _dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in batch_axes(mesh))


class _VocabParallelXent(torch.autograd.Function):
    """Megatron's vocab-parallel cross entropy, the JAX package's
    ``_vp_xent_local``: ``lg`` (b, s, v_loc) f32 is this rank's vocab block
    (from ``offset``), the result (b, s) the nll, the same on every model
    rank: the maximum over "model", one sum of the exponentials, the
    target's logit picked by the rank holding it and summed. Backward:
    (softmax − onehot)·g on this rank's block, with g the whole cotangent
    every rank holds (the nll is replicated over "model")."""

    @staticmethod
    def forward(ctx, lg, targets, mesh, offset):
        v_loc = lg.shape[-1]
        m = mesh.pmax(lg.amax(-1), MODEL_AX)  # (b, s)
        s = mesh.psum(torch.exp(lg - m[..., None]).sum(-1), MODEL_AX)
        lse = m + torch.log(s)
        t_loc = targets - offset
        in_range = (t_loc >= 0) & (t_loc < v_loc)
        tl = torch.gather(lg, -1, t_loc.clamp(0, v_loc - 1)[..., None])[..., 0]
        tl = mesh.psum(torch.where(in_range, tl, 0.0), MODEL_AX)
        ctx.save_for_backward(lg, lse, t_loc, in_range)
        return lse - tl

    @staticmethod
    def backward(ctx, g):
        lg, lse, t_loc, in_range = ctx.saved_tensors
        d = torch.exp(lg - lse[..., None])  # softmax
        hit = torch.where(in_range, t_loc, 0)[..., None]
        d.scatter_add_(-1, hit, -in_range[..., None].to(d.dtype))  # − onehot
        return d * g[..., None], None, None, None


# ---------------------------------------------------------------------------
# serving: KV / SSM state caches, prefill, single-token decode
# ---------------------------------------------------------------------------
@torch.inference_mode()
def init_cache(cfg: ModelConfig, batch: int, s_max: int, device="cuda", mesh=None
               ) -> Dict[str, Tensor]:
    """Decode state. Attention: k/v (L, B, S_max, kvH, hd). SSM: conv (L, B,
    d_conv-1, conv_dim) in the compute dtype and ssm (L, B, H, P, N) in
    f32. Hybrid: the SSM states and k/v per application of the shared
    block. With ``mesh``: this rank's slice under ``cache_specs``."""
    cd = cfg.compute_dtype
    specs = cache_specs(cfg, mesh, batch, s_max) if mesh is not None else None
    cache: Dict[str, Tensor] = {}
    if cfg.family in ("ssm", "hybrid"):
        states = [ssm_mod.init_mamba2_state(cfg.ssm, cfg.d_model, batch, cd, device)
                  for _ in range(cfg.n_layers)]
        cache["conv"] = torch.stack([conv for conv, _ in states])
        cache["ssm"] = torch.stack([st for _, st in states])
    if cfg.family in ("attn", "hybrid"):
        n = cfg.n_layers if cfg.family == "attn" else cfg.n_layers // cfg.hybrid_every
        shape = (n, batch, s_max, cfg.kv_heads, cfg.hdim)
        if specs is not None:
            shape = _local_shape(shape, specs["k"], mesh)
        cache["k"] = torch.zeros(shape, dtype=cd, device=device)
        cache["v"] = torch.zeros(shape, dtype=cd, device=device)
    if specs is not None:
        for name in ("conv", "ssm"):
            if name in cache:
                cache[name] = shard_tensor(cache[name], specs[name], mesh)
    return cache


def _local_shape(shape, spec, mesh):
    return tuple(n // shard_index(mesh, e)[1] for n, e in zip(shape, spec))


class _Shard:
    """What a model call on a mesh needs: the mesh, the layer specs of
    tensor parallelism (``layer``: an attention layer's, or a Mamba2
    block's under "mamba"; ``shared``: the hybrid's shared block's),
    whether the batch is split over the data axes, and whether the
    cache's sequence is split over "model"."""

    def __init__(self, cfg: ModelConfig, mesh, batch: int, s_max: Optional[int] = None,
                 train: bool = False):
        self.mesh = mesh
        tp = _tp(mesh)
        self.layer = {"attn": attn_mod.attention_specs(cfg.eff_heads, cfg.kv_heads, tp),
                      "mlp": mlp_mod.mlp_specs(cfg.act, cfg.d_ff, tp),
                      "mamba": ssm_mod.mamba2_specs(cfg.ssm, cfg.d_model, tp) if cfg.ssm
                      else None}
        self.shared = {"attn": attn_mod.attention_specs(cfg.n_heads, cfg.kv_heads, tp),
                       "mlp": self.layer["mlp"]}
        self.batch = batch_shard(mesh, batch)
        if train:  # no cache; the batch must split, as the reference's in_shardings ask
            if batch_axes(mesh) and not self.batch:
                raise ValueError(f"a training batch of {batch} does not split over the data "
                                 f"axes {mesh.shape}")
            self.seq_sharded = False
            return
        k_spec = cache_specs(cfg, mesh, batch, s_max).get("k")
        self.seq_sharded = k_spec is not None and k_spec[2] == MODEL_AX

    def local(self, x: Tensor) -> Tensor:
        """This rank's share of the global batch ``x``."""
        return shard_tensor(x, Spec(self.batch), self.mesh) if self.batch else x

    def whole(self, y: Tensor) -> Tensor:
        """The global batch from every rank's share ``y``."""
        return gather_tensor(y, Spec(self.batch), self.mesh) if self.batch else y


def _run_cached(cfg: ModelConfig, params, cache, h, positions, cache_index, decode: bool,
                shard: Optional[_Shard] = None):
    """Every layer over h with the cache written in place: ``decode`` runs
    the recurrent SSM step and the MoE's "dense_ep" mode, else the chunked
    SSM scan and "a2a" (the JAX package's prefill and decode)."""
    layers = params["layers"]
    mesh = shard.mesh if shard is not None else None
    tp_kw = dict(mesh=mesh, tp_specs=shard.layer, seq_sharded=shard.seq_sharded) if shard else {}
    shared_kw = dict(mesh=mesh, tp_specs=shard.shared, seq_sharded=shard.seq_sharded) \
        if shard else {}
    ssm_kw = dict(mesh=mesh, specs=shard.layer["mamba"]) if shard else {}

    def mamba(i, h):
        lp = layers[i]
        x, state = rms_norm(h, lp["ln"]), (cache["conv"][i], cache["ssm"][i])
        mp = _at_use(cfg, lp["mamba"])
        if decode:
            out, (conv, st) = ssm_mod.mamba2_decode_step(mp, x, cfg.ssm, state, **ssm_kw)
        else:
            out, (conv, st) = ssm_mod.mamba2_block(mp, x, cfg.ssm, state=state,
                                                   return_state=True, **ssm_kw)
        cache["conv"][i] = conv
        cache["ssm"][i] = st
        return h + out

    if cfg.family == "attn":
        mode = "dense_ep" if decode else "a2a"
        for i, (lp, window) in enumerate(zip(layers, _layer_windows(cfg))):
            h, _, _ = _attn_layer_fwd(cfg, _at_use(cfg, lp), h, positions, window,
                                      kv_cache=(cache["k"][i], cache["v"][i]),
                                      cache_index=cache_index, moe_mode=mode, **tp_kw)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            h = mamba(i, h)
    else:  # hybrid
        for g, group in enumerate(_mamba_groups(cfg)):
            for i in group:
                h = mamba(i, h)
            h = _shared_block_fwd(cfg, _at_use(cfg, params["shared_block"]), h, positions,
                                  kv_cache=(cache["k"][g], cache["v"][g]),
                                  cache_index=cache_index, **shared_kw)
    return h


@torch.inference_mode()
def decode_step(cfg: ModelConfig, params, cache: Dict[str, Tensor], inputs: Tensor,
                cache_index, mesh=None, s_max: Optional[int] = None
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One new token for every sequence: inputs (B,1) tokens or (B,1,D)
    embeds, ``cache_index`` (int) the number of tokens already in the cache.
    Returns (logits (B, vocab) f32, the cache, updated in place). With
    ``mesh``: global inputs and logits, this rank's model and cache slice
    under ``cache_specs(cfg, mesh, B, s_max)`` (``s_max`` the global cache
    length; None as the JAX package's ``build_decode_step`` takes it)."""
    shard = _Shard(cfg, mesh, inputs.shape[0], s_max) if mesh is not None else None
    if shard is not None:
        inputs = shard.local(inputs)
    h = _embed(cfg, params, inputs, mesh)
    positions = torch.full((h.shape[0], 1), int(cache_index), device=h.device)
    h = _run_cached(cfg, params, cache, h, positions, cache_index, decode=True, shard=shard)
    logits = _logits(cfg, params, h, mesh)[:, 0, :cfg.vocab]
    return (shard.whole(logits) if shard is not None else logits), cache


@torch.inference_mode()
def prefill(cfg: ModelConfig, params, inputs: Tensor, s_max: int, mesh=None
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Forward over the prompt (B,S) / (B,S,D), building the decode cache.
    Returns (last-position logits (B, vocab) f32, cache filled to S). With
    ``mesh``: global inputs and logits, this rank's model and cache slice."""
    B, S = inputs.shape[0], inputs.shape[1]
    shard = _Shard(cfg, mesh, B, s_max) if mesh is not None else None
    cache = init_cache(cfg, B, s_max, inputs.device, mesh)
    if shard is not None:
        inputs = shard.local(inputs)
    h = _embed(cfg, params, inputs, mesh)
    positions = torch.arange(S, device=h.device).expand(h.shape[0], S)
    h = _run_cached(cfg, params, cache, h, positions, 0, decode=False, shard=shard)
    logits = _logits(cfg, params, h[:, -1:], mesh)[:, 0, :cfg.vocab]
    return (shard.whole(logits) if shard is not None else logits), cache
