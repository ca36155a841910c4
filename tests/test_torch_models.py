"""The port's LM stack (``repro_torch.models``, ``repro_torch.configs``,
``core.convert.lm_params_from_reference``) against the JAX package's
``repro.models`` and ``repro.configs``, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
weights are the JAX package's seeded init, carried over by the converter.
The JAX side runs under a 1x1 ("data", "model") mesh (its ``moe_layer``
needs one); each architecture's JAX results are computed once per module.

Tolerances: f32 within rtol = atol = 1e-4 (sums in another order; the
MoE's SpMM sums in another order than its segment sum); one bf16 case
(granite SMOKE with dtype "bfloat16") within rtol = atol = 5e-2, since the
two frameworks round bf16 at other places. The MoE's routing decisions
(capacity, expert, slot, kept or dropped) are equal exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import AxisType, make_mesh, set_mesh
from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import applicable as j_applicable
from repro.configs import get_config as j_get_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro_torch.configs import ARCHS, SHAPES, applicable, get_config
from repro_torch.core.convert import lm_params_from_reference
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
B, S, S_MAX = 2, 8, 12


@pytest.fixture(scope="module")
def mesh():
    dev = np.array(jax.devices()[:1]).reshape(1, 1)
    return make_mesh(dev, ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def t(x):
    return torch.as_tensor(np.array(x, copy=True))


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, dtype=np.float32), **tol)


def params_np(tree):
    return jax.tree.map(np.asarray, tree)


def normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_registry_matches():
    assert ARCHS == J_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    for shape in SHAPES:
        for long in (False, True):
            assert applicable("ssm", long, shape) == j_applicable("ssm", long, shape)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match(arch, smoke):
    got, want = get_config(arch, smoke), j_get_config(arch, smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.padded_vocab, got.eff_heads, got.hdim) == \
        (want.padded_vocab, want.eff_heads, want.hdim)
    assert got.compute_dtype == {"bfloat16": torch.bfloat16, "float32": torch.float32}[got.dtype]
    assert got.active_param_count() == want.active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_full_width(arch):
    """Every full configuration's parameter count, the JAX package's from
    its init's shapes alone, the port's from its model on the meta device."""
    cfg = j_get_config(arch)
    shapes = jax.eval_shape(lambda k: jtfm.init_params(cfg, k), jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    got = tcommon.param_count(ttfm.init_params(get_config(arch), None, "meta"))
    assert got == want


# ---------------------------------------------------------------------------
# common and mlp
# ---------------------------------------------------------------------------
def test_rms_norm_and_soft_cap():
    rng = np.random.default_rng(0)
    x, scale = normal(rng, 3, 5, 16, scale=3.0), normal(rng, 16)
    close(tcommon.rms_norm(t(x), t(scale)), jcommon.rms_norm(x, scale))
    close(tcommon.soft_cap(t(x), 2.5), jcommon.soft_cap(x, 2.5))
    xt = t(x)
    assert tcommon.soft_cap(xt, None) is xt


@pytest.mark.parametrize("theta", [10_000.0, 1e6])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = normal(rng, 2, 6, 4, 16)
    pos = rng.integers(0, 500, (2, 6)).astype(np.int32)
    close(tcommon.apply_rope(t(x), t(pos), theta), jcommon.apply_rope(x, pos, theta))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "gelu_tanh"])
def test_mlp_acts(act):
    rng = np.random.default_rng(2)
    params = params_np(jmlp.init_mlp(jax.random.PRNGKey(3), 16, 32, act))
    x = normal(rng, 2, 5, 16)
    close(tmlp.mlp({k: t(v) for k, v in params.items()}, t(x), act),
          jmlp.mlp(params, x, act))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
ATTN_CASES = {
    # (n_heads, kv_heads, pad_heads_to, window, soft_cap)
    "gqa": (4, 2, 0, None, None),
    "mqa": (4, 1, 0, None, None),
    "mha_window_softcap": (4, 4, 0, 3, 50.0),
    "padded_heads": (4, 2, 6, None, None),
}


def _attn_case(name, seed=4):
    nh, kvh, pad, window, cap = ATTN_CASES[name]
    params = params_np(jattn.init_attention(jax.random.PRNGKey(seed), 32, nh, kvh, 8,
                                            pad_heads_to=pad))
    return params, {k: t(v) for k, v in params.items()}, dict(window=window, attn_softcap=cap)


@pytest.mark.parametrize("name", ATTN_CASES)
def test_attend_prefill(name):
    jp, tp, kw = _attn_case(name)
    rng = np.random.default_rng(5)
    x = normal(rng, 2, 7, 32)
    pos = np.broadcast_to(np.arange(7), (2, 7)).astype(np.int32)
    y, cache = tattn.attend(tp, t(x), t(pos), **kw)
    want, _ = jattn.attend(jp, x, pos, **kw)
    assert cache is None
    close(y, want)


@pytest.mark.parametrize("index,s", [(0, 1), (3, 1), (5, 3), (10, 1), (10, 3)],
                         ids=["i0", "i3", "block", "clamped", "clamped_block"])
@pytest.mark.parametrize("name", ATTN_CASES)
def test_attend_cache(name, index, s):
    """Writes at ``index`` (clamped to S_max - S, as dynamic_update_slice
    clamps: S_max = 10 here) and attends over the whole cache."""
    jp, tp, kw = _attn_case(name)
    rng = np.random.default_rng(6)
    kvh = jp["wk"].shape[1]
    x = normal(rng, 2, s, 32)
    pos = np.full((2, s), index, np.int32) + np.arange(s, dtype=np.int32)
    ck, cv = normal(rng, 2, 10, kvh, 8), normal(rng, 2, 10, kvh, 8)
    y, (nk, nv) = tattn.attend(tp, t(x), t(pos), kv_cache=(t(ck), t(cv)),
                               cache_index=index, **kw)
    want, (wk, wv) = jattn.attend(jp, x, pos, kv_cache=(ck, cv), cache_index=jnp.int32(index),
                                  **kw)
    close(y, want)
    close(nk, wk)
    close(nv, wv)


def test_padded_heads_are_exact():
    """The port's own padded init computes what its real heads compute."""
    g = torch.Generator().manual_seed(0)
    padded = tattn.init_attention(g, 32, 4, 2, 8, device="cpu", pad_heads_to=6)
    real = dict(padded, wq=padded["wq"][:, [0, 1, 3, 4]], wo=padded["wo"][[0, 1, 3, 4]])
    assert not padded["wq"][:, [2, 5]].any() and not padded["wo"][[2, 5]].any()
    x = torch.randn(2, 5, 32, generator=g)
    pos = torch.arange(5).expand(2, 5)
    torch.testing.assert_close(tattn.attend(padded, x, pos)[0], tattn.attend(real, x, pos)[0],
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def _moe_setup(n_shared=1, capacity_factor=1.25, T=24, seed=7):
    cfg_j = jmoe.MoEConfig(n_experts=8, top_k=2, d_expert=16, n_shared=n_shared,
                           capacity_factor=capacity_factor)
    cfg_t = tmoe.MoEConfig(**dataclasses.asdict(cfg_j))
    params = params_np(jmoe.init_moe(jax.random.PRNGKey(seed), 32, cfg_j))
    x = normal(np.random.default_rng(seed), T, 32)
    return cfg_j, cfg_t, params, x


def _tparams(params):
    return {k: _tparams(v) if isinstance(v, dict) else t(v) for k, v in params.items()}


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["cf1.25", "cf0.5_drops"])
def test_moe_routing_exact(capacity_factor):
    cfg_j, cfg_t, params, x = _moe_setup(capacity_factor=capacity_factor, T=40)
    tp, te, taux = tmoe._route(t(x), t(params["router"]), cfg_t)
    jp_, je, jaux = jmoe._route(x, params["router"], cfg_j)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    close(tp, jp_)
    close(taux, jaux)
    for T in (1, 7, 8, 40, 512):
        assert tmoe._capacity(T, cfg_t) == jmoe._capacity(T, cfg_j)
    cap = tmoe._capacity(40, cfg_t)
    got = tmoe._dispatch_indices(te, cfg_t, cap)
    want = jmoe._dispatch_indices(je, cfg_j, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool((~got[2]).any()) == (capacity_factor < 1)  # drops only when starved


def test_moe_top_k_ties_to_lower_index():
    cfg = tmoe.MoEConfig(n_experts=4, top_k=2, d_expert=4)
    x = torch.ones(3, 2)
    router = torch.zeros(2, 4)  # every expert equally likely
    _, top_e, _ = tmoe._route(x, router, cfg)
    _, want, _ = jmoe._route(np.ones((3, 2), np.float32), np.zeros((2, 4), np.float32),
                             jmoe.MoEConfig(n_experts=4, top_k=2, d_expert=4))
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(want))
    assert top_e.tolist() == [[0, 1]] * 3


@pytest.mark.parametrize("mode", ["spgemm", "scatter"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["cf1.25", "cf0.5_drops"])
def test_moe_dispatch_combine(mode, capacity_factor):
    cfg_j, cfg_t, params, x = _moe_setup(capacity_factor=capacity_factor, T=40)
    cfg_j = dataclasses.replace(cfg_j, dispatch_mode=mode)
    cfg_t = dataclasses.replace(cfg_t, dispatch_mode=mode)
    top_p, top_e, _ = jmoe._route(x, params["router"], cfg_j)
    cap = jmoe._capacity(40, cfg_j)
    idx_j = jmoe._dispatch_indices(top_e, cfg_j, cap)
    idx_t = [t(a).long() if a.dtype != bool else t(a) for a in map(np.asarray, idx_j)]
    buf_t = tmoe._dispatch(t(x), *idx_t, cfg_t, cap)
    buf_j = jmoe._dispatch(x, *idx_j, cfg_j, cap)
    close(buf_t, buf_j)
    y = normal(np.random.default_rng(8), 8, cap, 32)
    close(tmoe._combine(t(y), t(top_p), *idx_t, 40, cfg_t, cap),
          jmoe._combine(y, top_p, *idx_j, 40, cfg_j, cap))


@pytest.mark.parametrize("mode", ["a2a", "dense_ep"])
@pytest.mark.parametrize("dispatch", ["spgemm", "scatter"])
def test_moe_layer(mesh, mode, dispatch):
    cfg_j, cfg_t, params, x = _moe_setup(n_shared=1, T=24)
    cfg_j = dataclasses.replace(cfg_j, dispatch_mode=dispatch)
    cfg_t = dataclasses.replace(cfg_t, dispatch_mode=dispatch)
    x3 = x.reshape(2, 12, 32)
    out, aux = tmoe.moe_layer(_tparams(params), t(x3), cfg_t, mode=mode)
    with set_mesh(mesh):
        want, want_aux = jmoe.moe_layer(params, x3, cfg_j, mesh, mode=mode)
    close(out, want)
    close(aux, want_aux)


def test_moe_layer_rejects_unknown_mode():
    _, cfg_t, params, x = _moe_setup()
    with pytest.raises(ValueError, match="mode"):
        tmoe.moe_layer(_tparams(params), t(x[None]), cfg_t, mode="ring")


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------
SSM_CFG = dict(d_state=8, head_dim=8, expand=2, d_conv=4, chunk=4)


def test_ssd_chunked():
    rng = np.random.default_rng(9)
    x, b, c = normal(rng, 2, 12, 4, 8), normal(rng, 2, 12, 1, 8), normal(rng, 2, 12, 1, 8)
    a_dt = -np.abs(normal(rng, 2, 12, 4, scale=0.5))
    h0 = normal(rng, 2, 4, 8, 8)
    y, h = tssm.ssd_chunked(t(x), t(a_dt), t(b), t(c), 4, h0=t(h0))
    wy, wh = jssm.ssd_chunked(x, a_dt, b, c, 4, h0=h0)
    close(y, wy)
    close(h, wh)


def _mamba_setup(seed=10):
    cfg_j = jssm.SSMConfig(**SSM_CFG)
    cfg_t = tssm.SSMConfig(**SSM_CFG)
    params = params_np(jssm.init_mamba2(jax.random.PRNGKey(seed), 16, cfg_j))
    return cfg_j, cfg_t, params, _tparams(params)


@pytest.mark.parametrize("seq", [3, 8, 10], ids=["short", "chunks", "padded"])
def test_mamba2_block_with_state(seq):
    cfg_j, cfg_t, jp, tp = _mamba_setup()
    rng = np.random.default_rng(11)
    x = normal(rng, 2, seq, 16)
    conv, st = normal(rng, 2, 3, 48, scale=0.3), normal(rng, 2, 4, 8, 8, scale=0.3)
    out, (nconv, nst) = tssm.mamba2_block(tp, t(x), cfg_t, state=(t(conv), t(st)),
                                          return_state=True)
    wout, (wconv, wst) = jssm.mamba2_block(jp, x, cfg_j, state=(conv, st), return_state=True)
    close(out, wout)
    close(nconv, wconv)
    close(nst, wst)
    close(tssm.mamba2_block(tp, t(x), cfg_t), jssm.mamba2_block(jp, x, cfg_j))


def test_mamba2_decode_step():
    cfg_j, cfg_t, jp, tp = _mamba_setup()
    rng = np.random.default_rng(12)
    x = normal(rng, 2, 1, 16)
    conv, st = normal(rng, 2, 3, 48, scale=0.3), normal(rng, 2, 4, 8, 8, scale=0.3)
    out, (nconv, nst) = tssm.mamba2_decode_step(tp, t(x), cfg_t, (t(conv), t(st)))
    wout, (wconv, wst) = jssm.mamba2_decode_step(jp, x, cfg_j, (conv, st))
    close(out, wout)
    close(nconv, wconv)
    close(nst, wst)


# ---------------------------------------------------------------------------
# whole models: forward, prefill (every cache leaf), decode
# ---------------------------------------------------------------------------
def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return normal(rng, B, S + 1, cfg.d_model)


def _reference_run(cfg, mesh, seed):
    params = jtfm.init_params(cfg, jax.random.PRNGKey(seed))
    seq = _inputs(cfg, seed)
    with set_mesh(mesh):
        logits, aux = jtfm.forward(cfg, params, seq[:, :S], mesh)
        plog, cache = jtfm.prefill(cfg, params, seq[:, :S], s_max=S_MAX, mesh=mesh)
        dlog, dcache = jtfm.decode_step(cfg, params, cache, seq[:, S:], jnp.int32(S), mesh)
    return {"params": params_np(params), "seq": seq, "forward": (logits, aux),
            "prefill": (plog, params_np(cache)), "decode": (dlog, params_np(dcache))}


@pytest.fixture(scope="module")
def reference_runs(mesh):
    runs = {}

    def get(arch):
        if arch not in runs:
            runs[arch] = _reference_run(j_get_config(arch, smoke=True), mesh, seed=13)
        return runs[arch]

    return get


def _port_model(arch, ref):
    cfg = get_config(arch, smoke=True)
    return cfg, lm_params_from_reference(cfg, ref["params"], "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(arch, reference_runs):
    ref = reference_runs(arch)
    cfg, model = _port_model(arch, ref)
    logits, aux = ttfm.forward(cfg, model, t(ref["seq"][:, :S]))
    assert logits.shape == (B, S, cfg.padded_vocab)
    close(logits, ref["forward"][0])
    close(aux, ref["forward"][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match(arch, reference_runs):
    ref = reference_runs(arch)
    cfg, model = _port_model(arch, ref)
    logits, cache = ttfm.prefill(cfg, model, t(ref["seq"][:, :S]), S_MAX)
    want_logits, want_cache = ref["prefill"]
    close(logits, want_logits)
    assert sorted(cache) == sorted(want_cache)
    for name, leaf in cache.items():
        assert leaf.dtype == torch.float32, name  # SMOKE configs compute in f32
        close(leaf, want_cache[name])
    dlog, dcache = ttfm.decode_step(cfg, model, cache, t(ref["seq"][:, S:]), S)
    want_dlog, want_dcache = ref["decode"]
    assert dlog.shape == (B, cfg.vocab)
    close(dlog, want_dlog)
    for name, leaf in dcache.items():
        close(leaf, want_dcache[name])


def test_granite_bf16(mesh):
    """One bf16 model: granite SMOKE computing in bfloat16."""
    cfg_j = dataclasses.replace(j_get_config("granite-20b", smoke=True), dtype="bfloat16")
    cfg = dataclasses.replace(get_config("granite-20b", smoke=True), dtype="bfloat16")
    ref = _reference_run(cfg_j, mesh, seed=14)
    model = lm_params_from_reference(cfg, ref["params"], "cpu")
    assert model.layers[0].attn.wq.dtype == torch.bfloat16
    assert model.layers[0].ln1.dtype == model.final_norm.dtype == torch.float32
    seq = t(ref["seq"])
    close(ttfm.forward(cfg, model, seq[:, :S])[0], ref["forward"][0], BF16_TOL)
    logits, cache = ttfm.prefill(cfg, model, seq[:, :S], S_MAX)
    close(logits, ref["prefill"][0], BF16_TOL)
    for name, leaf in cache.items():
        assert leaf.dtype == torch.bfloat16
        close(leaf, np.asarray(ref["prefill"][1][name], np.float32), BF16_TOL)
    dlog, _ = ttfm.decode_step(cfg, model, cache, seq[:, S:], S)
    close(dlog, ref["decode"][0], BF16_TOL)


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-2.7b", "musicgen-large",
                                  "deepseek-moe-16b"])
def test_converter_counts_and_layout(arch, reference_runs):
    ref = reference_runs(arch)
    cfg, model = _port_model(arch, ref)
    assert tcommon.param_count(model) == jcommon.param_count(ref["params"])
    assert len(model.layers) == cfg.n_layers
    layers = ref["params"]["layers"]
    for i, lp in enumerate(model.layers):  # layer i of the stack, unchanged (f32 configs)
        if cfg.family == "attn":
            np.testing.assert_array_equal(lp.attn.wq.numpy(), layers["attn"]["wq"][i])
        else:
            np.testing.assert_array_equal(lp.mamba.w_in_z.numpy(), layers["mamba"]["w_in_z"][i])
    assert ("embed" in model) == (cfg.input_mode == "tokens")
    assert ("lm_head" in model) == (not cfg.tie_embeddings)


@pytest.mark.parametrize("damage", ["extra", "missing", "shape"])
def test_converter_raises(damage):
    cfg_j = j_get_config("deepseek-moe-16b", smoke=True)
    params = params_np(jtfm.init_params(cfg_j, jax.random.PRNGKey(0)))
    moe = params["layers"]["moe"]
    if damage == "extra":
        moe["shared"]["bias"] = np.zeros((2, 64), np.float32)
    elif damage == "missing":
        del moe["shared"]["w_gate"]
    else:
        params["final_norm"] = np.zeros((65,), np.float32)
    with pytest.raises(ValueError, match="deepseek"):
        lm_params_from_reference(get_config("deepseek-moe-16b", smoke=True), params, "cpu")
