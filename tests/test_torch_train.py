"""The port's training pieces against the JAX package's, on the CPU: the
differentiable SpMM (``kernels.spmm_kernel.SpmmFunction`` through
``core.local_spgemm.spmm``), the MoE layer's and ``lm_loss``'s gradients,
AdamW (``optim.adamw``), top-k compression (``optim.compress``) and the
data pipeline's contract (``data.pipeline``).

Inputs are made with numpy from a seed and handed to both packages; the
weights are the JAX package's seeded init, carried over by the converter
with ``master=True`` (f32 masters, as the JAX package keeps them). The JAX
side runs under a 1x1 ("data", "model") mesh where it needs one, so its
loss is the vocab-parallel ``_sharded_xent``, which equals the port's
single-device loss there.

Tolerances: the SpMM's gradients within rtol 1e-5 / atol 1e-6 in f32 (the
port sums each dB row and each dvals dot in another order than JAX's
segment sum); ``gradcheck`` in f64 at its defaults. Losses within rtol
1e-5, gradients within rtol 1e-4 / atol 1e-6 (whole models: sums in other
orders through every layer; a whole model's gradients take an atol
scaled to each tensor, see ``close_model_grad``). AdamW after 3 steps
within rtol 1e-6 (the
same elementwise f32 arithmetic; the global norm sums in another order).
Top-k compression is exact: the same indices, values and residuals.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import AxisType, make_mesh, set_mesh
from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.core import local_spgemm as jlocal
from repro.core.sparse import SparseCOO as JSparseCOO
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import local_spgemm as tlocal
from repro_torch.core import semiring as tsr
from repro_torch.core.convert import lm_params_from_reference
from repro_torch.core.sparse import SparseCOO
from repro_torch.data import DataConfig, Prefetcher, synthetic_batch
from repro_torch.kernels import spmm_kernel
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress
from repro_torch.train import value_and_grad

SPMM_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# A whole model's gradient entry is a sum over every position and layer
# that reaches it, and may cancel to far below its terms. Both packages'
# f32 gradients were held against the port's f64 gradient of the same
# inputs (every parameter, the ten SMOKE archs; tools/torch_grad_f64.py):
# each f32 result is within
# 1.5e-6 of its tensor's largest entry on zamba2's embed and within 3e-5
# on the small A_log tensors, so two f32 results may differ by the sum of
# two such errors. The atol of a whole-model gradient is therefore
# GRAD_MAX_ATOL times the tensor's largest |entry| (never under GRAD_TOL's
# 1e-6): 1e-5 is ~3x the two errors on embed, while a real fault (a lost
# or doubled term) moves an entry by the size of a term.
GRAD_MAX_ATOL = 1e-5
B, S = 2, 8


@pytest.fixture(scope="module")
def mesh():
    dev = np.array(jax.devices()[:1]).reshape(1, 1)
    return make_mesh(dev, ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def t(x, dtype=None):
    return torch.as_tensor(np.array(x, copy=True), dtype=dtype)


def close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, dtype=np.float32), **tol)


def close_model_grad(got, want):
    """A whole model's gradient: rtol GRAD_TOL's, atol scaled to ``want``'s
    largest entry (see GRAD_MAX_ATOL)."""
    want = np.asarray(want, dtype=np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    close(got, want, dict(rtol=GRAD_TOL["rtol"],
                          atol=max(GRAD_TOL["atol"], GRAD_MAX_ATOL * scale)))


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def unstack(tree, path=()):
    """{port parameter name: array} of a JAX parameter tree (layers unstacked)."""
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out.update(unstack(node, path + (name,)))
        elif path and path[0] == "layers":
            arr = np.asarray(node)
            for i in range(arr.shape[0]):
                out[".".join(("layers", str(i)) + path[1:] + (name,))] = arr[i]
        else:
            out[".".join(path + (name,))] = np.asarray(node)
    return out


# ---------------------------------------------------------------------------
# the differentiable SpMM
# ---------------------------------------------------------------------------
def _entries(seed, m, k, cap, nnz, sentinels=True):
    """Padded COO entries of an (m, k) A: ``nnz`` valid slots of ``cap``,
    some with the sentinel row m or column k (padding the kernel skips),
    the tail past ``nnz`` holding junk indices."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, cap).astype(np.int32)
    cols = rng.integers(0, k, cap).astype(np.int32)
    if sentinels:
        rows[1::5] = m
        cols[2::7] = k
    rows[nnz:] = rng.integers(0, m, cap - nnz)
    return rows, cols, normal(rng, cap)


def _coo(rows, cols, vals, nnz, shape):
    return SparseCOO(rows=t(rows), cols=t(cols), vals=vals,
                     nnz=torch.tensor(nnz, dtype=torch.int32), shape=shape)


@pytest.mark.parametrize("grads", ["vals_and_b", "b_only", "vals_only"])
def test_spmm_function_gradcheck_f64(grads):
    m, k, n, cap, nnz = 6, 5, 3, 24, 20
    rows, cols, vals = _entries(0, m, k, cap, nnz)
    v = t(vals, torch.float64).requires_grad_(grads != "b_only")
    b = t(normal(np.random.default_rng(1), k, n), torch.float64).requires_grad_(
        grads != "vals_only")

    def f(v, b):
        return tlocal.spmm(_coo(rows, cols, v, nnz, (m, k)), b)

    assert torch.autograd.gradcheck(f, (v, b))


def _jax_spmm_grads(rows, cols, vals, b, nnz, shape, cot):
    def f(v, bb):
        a = JSparseCOO(rows=jnp.asarray(rows), cols=jnp.asarray(cols), vals=v,
                       nnz=jnp.int32(nnz), shape=shape)
        return jnp.sum(jlocal.spmm(a, bb) * cot)

    return jax.grad(f, argnums=(0, 1))(jnp.asarray(vals), jnp.asarray(b))


@pytest.mark.parametrize("kind", ["dispatch", "combine"])
def test_spmm_grads_match_jax(kind):
    """Dispatch-like: S (slots x tokens) with constant 1s, only dB; and
    combine-like: its weighted transpose, dvals and dB; with sentinels."""
    m, k, n, cap, nnz = (40, 16, 8, 32, 30) if kind == "dispatch" else (16, 40, 8, 32, 30)
    rows, cols, vals = _entries(2, m, k, cap, nnz)
    if kind == "dispatch":
        vals = np.ones(cap, np.float32)
    rng = np.random.default_rng(3)
    b, cot = normal(rng, k, n), normal(rng, m, n)
    jdv, jdb = _jax_spmm_grads(rows, cols, vals, b, nnz, (m, k), cot)
    v = t(vals).requires_grad_(kind == "combine")
    bt = t(b).requires_grad_(True)
    out = tlocal.spmm(_coo(rows, cols, v, nnz, (m, k)), bt)
    out.backward(t(cot))
    close(bt.grad, jdb, SPMM_TOL)
    if kind == "combine":
        close(v.grad, jdv, SPMM_TOL)
    else:
        assert v.grad is None


def test_spmm_sentinels_stay_dead_after_swap():
    """dB = Aᵀ·G launches the SpMM on the swapped entries: an old sentinel
    row m is column m there and an old sentinel column k is row k there;
    neither may reach dB, and their dvals are 0. Large values sit on the
    sentinel entries so a leak would show."""
    m, k, n = 5, 4, 3
    rows = np.array([0, 5, 2, 4, 1, 3], np.int32)  # entry 1: sentinel row m
    cols = np.array([1, 0, 4, 3, 2, 0], np.int32)  # entry 2: sentinel column k
    vals = np.array([1.0, 1e6, -1e6, 2.0, 3.0, -1.0], np.float32)
    rng = np.random.default_rng(4)
    b, g = normal(rng, k, n), normal(rng, m, n)
    v, bt = t(vals).requires_grad_(True), t(b).requires_grad_(True)
    spmm_kernel.SpmmFunction.apply(t(rows), t(cols), v, bt, m).backward(t(g))
    live = (rows < m) & (cols < k)
    dense = np.zeros((m, k), np.float32)
    np.add.at(dense, (rows[live], cols[live]), vals[live])
    np.testing.assert_allclose(bt.grad.numpy(), dense.T @ g, rtol=1e-6)
    want_dv = np.where(live, (g[np.minimum(rows, m - 1)] * b[np.minimum(cols, k - 1)]).sum(1), 0)
    np.testing.assert_allclose(v.grad.numpy(), want_dv, rtol=1e-6)
    assert v.grad[1] == 0 and v.grad[2] == 0


def test_spmm_backward_computes_only_what_is_asked(monkeypatch):
    calls = {"spmm": [], "dvals": 0}
    spmm, dvals = spmm_kernel.spmm, spmm_kernel.spmm_dvals

    def counted_spmm(rows, cols, vals, b, m, out=None):
        calls["spmm"].append(m)
        return spmm(rows, cols, vals, b, m, out=out)

    def counted_dvals(*args, **kw):
        calls["dvals"] += 1
        return dvals(*args, **kw)

    monkeypatch.setattr(spmm_kernel, "spmm", counted_spmm)
    monkeypatch.setattr(spmm_kernel, "spmm_dvals", counted_dvals)
    m, k, n = 7, 6, 4
    rows, cols, vals = _entries(5, m, k, 12, 12)
    b = t(normal(np.random.default_rng(6), k, n))
    # dispatch: constant values -> the forward and dB (k rows), no dvals
    bt = b.clone().requires_grad_(True)
    tlocal.spmm(_coo(rows, cols, t(vals), 12, (m, k)), bt).sum().backward()
    assert calls == {"spmm": [m, k], "dvals": 0}
    # a values-only gradient: the forward and dvals, no dB
    calls["spmm"].clear()
    v = t(vals).requires_grad_(True)
    tlocal.spmm(_coo(rows, cols, v, 12, (m, k)), b).sum().backward()
    assert calls == {"spmm": [m], "dvals": 1}
    # no gradient needed: the plain path, not the Function
    calls.update(spmm=[], dvals=0)
    with torch.no_grad():
        tlocal.spmm(_coo(rows, cols, v, 12, (m, k)), bt)
    assert calls == {"spmm": [], "dvals": 0}


def test_differentiable_spmm_refuses_semirings_and_out():
    rows, cols, vals = _entries(7, 4, 4, 8, 8, sentinels=False)
    a = _coo(rows, cols, t(vals).requires_grad_(True), 8, (4, 4))
    b = torch.ones(4, 2)
    with pytest.raises(ValueError, match="plus_times"):
        tlocal.spmm(a, b, tsr.MIN_PLUS)
    with pytest.raises(ValueError, match="into out"):
        tlocal.spmm(a, b, out=torch.zeros(4, 2))


# ---------------------------------------------------------------------------
# the MoE layer and lm_loss
# ---------------------------------------------------------------------------
def _moe_case(dispatch, seed=7, T=24, D=32):
    cfg_j = jmoe.MoEConfig(n_experts=8, top_k=2, d_expert=16, n_shared=1,
                           dispatch_mode=dispatch)
    cfg_t = tmoe.MoEConfig(**dataclasses.asdict(cfg_j))
    params = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed), D, cfg_j))
    rng = np.random.default_rng(seed)
    return cfg_j, cfg_t, params, normal(rng, 2, T // 2, D), normal(rng, 2, T // 2, D)


@pytest.mark.parametrize("dispatch", ["spgemm", "scatter"])
def test_moe_layer_grads_match_jax(mesh, dispatch):
    """d/d(params, x) of sum(out · cot) + aux, the aux loss weighted 0.5 so
    its gradient (through the router) counts."""
    cfg_j, cfg_t, params, x, cot = _moe_case(dispatch)

    def jloss(p, xx):
        out, aux = jmoe.moe_layer(p, xx, cfg_j, mesh, mode="a2a")
        return jnp.sum(out * cot) + 0.5 * aux

    with set_mesh(mesh):
        jl, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(params, x)
    tparams = jax.tree.map(lambda a: t(a).requires_grad_(True), params)
    xt = t(x).requires_grad_(True)
    out, aux = tmoe.moe_layer(tparams, xt, cfg_t, mode="a2a")
    loss = (out * t(cot)).sum() + 0.5 * aux
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=LOSS_RTOL)
    close(xt.grad, jgx, GRAD_TOL)
    for name, want in unstack(jax.tree.map(np.asarray, jgp)).items():
        got = tparams
        for part in name.split("."):
            got = got[part]
        close(got.grad, want, GRAD_TOL)


def _lm_case(arch, seed=11):
    cfg = j_get_config(arch, smoke=True)
    params = jax.tree.map(np.asarray, jtfm.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        inputs = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    else:
        inputs = normal(rng, B, S, cfg.d_model)
    targets = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return cfg, params, inputs, targets


@pytest.fixture(scope="module")
def lm_grads(mesh):
    """The JAX package's (loss, grads) of ``lm_loss`` per SMOKE arch, once."""
    runs = {}

    def get(arch):
        if arch not in runs:
            cfg, params, inputs, targets = _lm_case(arch)
            fn = jax.jit(jax.value_and_grad(
                lambda p, i, tg: jtfm.lm_loss(cfg, p, i, tg, mesh, aux_weight=0.01)))
            with set_mesh(mesh):
                loss, grads = fn(params, inputs, targets)
            runs[arch] = (params, inputs, targets, float(loss),
                          jax.tree.map(np.asarray, grads))
        return runs[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax(arch, lm_grads):
    assert arch in J_ARCHS
    params, inputs, targets, want_loss, want_grads = lm_grads(arch)
    cfg = get_config(arch, smoke=True)
    model = lm_params_from_reference(cfg, params, "cpu", master=True)
    loss, grads = value_and_grad(
        lambda p: ttfm.lm_loss(cfg, p, t(inputs), t(targets), aux_weight=0.01), model)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    want = unstack(want_grads)
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        close_model_grad(g, want[name])


def test_model_grad_check_catches_one_wrong_term(lm_grads):
    """The scaled atol still sees a single term gone wrong: one target of
    the 16 changed moves the embed and lm_head gradients past it."""
    arch = "zamba2-2.7b"
    params, inputs, targets, _, want_grads = lm_grads(arch)
    cfg = get_config(arch, smoke=True)
    model = lm_params_from_reference(cfg, params, "cpu", master=True)
    wrong = targets.copy()
    wrong[0, 0] = (wrong[0, 0] + 1) % cfg.vocab
    _, grads = value_and_grad(
        lambda p: ttfm.lm_loss(cfg, p, t(inputs), t(wrong), aux_weight=0.01), model)
    want = unstack(want_grads)
    for name in ("embed", "lm_head"):
        with pytest.raises(AssertionError):
            close_model_grad(grads[name], want[name])


def test_lm_loss_masks_the_padded_vocab():
    """A padded vocab's logits are -1e30 and take no probability: the loss
    equals the cross entropy over the live vocab, and their gradient is 0."""
    cfg = dataclasses.replace(get_config("starcoder2-7b", smoke=True), vocab=250)
    assert cfg.padded_vocab == 256
    model = ttfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu", master=True)
    rng = np.random.default_rng(0)
    inputs = t(rng.integers(0, 250, (B, S)).astype(np.int32))
    targets = t(rng.integers(0, 250, (B, S)).astype(np.int32))
    logits, aux = ttfm.forward(cfg, model, inputs)
    live = torch.nn.functional.cross_entropy(logits[..., :250].reshape(-1, 250),
                                             targets.long().reshape(-1))
    loss, grads = value_and_grad(
        lambda p: ttfm.lm_loss(cfg, p, inputs, targets, aux_weight=0.0), model)
    np.testing.assert_allclose(float(loss), float(live), rtol=1e-6)
    assert float(grads["lm_head"][:, 250:].abs().max()) == 0.0


def test_master_model_casts_at_use():
    """A master model (f32) computes as the serving model (ndim > 1 in the
    compute dtype) does: the cast happens at use. bf16 granite SMOKE."""
    cfg = dataclasses.replace(get_config("granite-20b", smoke=True), dtype="bfloat16")
    params = jax.tree.map(np.asarray, jtfm.init_params(j_get_config("granite-20b", smoke=True),
                                                       jax.random.PRNGKey(3)))
    master = lm_params_from_reference(cfg, params, "cpu", master=True)
    serving = lm_params_from_reference(cfg, params, "cpu")
    assert master.layers[0].attn.wq.dtype == torch.float32
    assert serving.layers[0].attn.wq.dtype == torch.bfloat16
    inputs = t(np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(np.int32))
    with torch.no_grad():
        got, want = ttfm.forward(cfg, master, inputs), ttfm.forward(cfg, serving, inputs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_remat_recomputes_and_gives_the_same_grads(monkeypatch):
    """With remat each layer runs twice per step (forward, recompute in the
    backward), and the gradients equal those without remat."""
    cfg = get_config("olmoe-1b-7b", smoke=True)
    assert cfg.remat
    model = ttfm.init_params(cfg, torch.Generator().manual_seed(1), "cpu", master=True)
    rng = np.random.default_rng(1)
    inputs = t(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    targets = t(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    calls = []
    inner = tlocal.spmm
    monkeypatch.setattr(tlocal, "spmm", lambda a, b, *args, **kw: (
        calls.append(a.shape), inner(a, b, *args, **kw))[1])

    def grads(c):
        calls.clear()
        _, g = value_and_grad(lambda p: ttfm.lm_loss(c, p, inputs, targets), model)
        return g, len(calls)

    with_remat, n_remat = grads(cfg)
    without, n_plain = grads(dataclasses.replace(cfg, remat=False))
    assert (n_remat, n_plain) == (4 * cfg.n_layers, 2 * cfg.n_layers)
    for name, g in with_remat.items():
        assert torch.equal(g, without[name]), name


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": normal(rng, 4, 5).astype(dtype), "b": normal(rng, 3).astype(dtype),
            "c": {"d": normal(rng, 2, 3).astype(dtype)}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.parametrize("master_in_opt", [False, True], ids=["params", "master_in_opt"])
def test_apply_updates_matches_jax(master_in_opt):
    """Three steps at warmup 5 (count < warmup: lr ramps), a clip that
    binds (grad_clip 0.5), weight decay on every leaf."""
    cfg_j = jadamw.AdamWConfig(lr=1e-2, warmup_steps=5, grad_clip=0.5,
                               master_in_opt=master_in_opt)
    cfg_t = tadamw.AdamWConfig(**{k: v for k, v in dataclasses.asdict(cfg_j).items()
                                  if k != "zero1"})
    dtype = jnp.bfloat16 if master_in_opt else np.float32
    params_j = jax.tree.map(lambda a: jnp.asarray(a, dtype), _tree(0))
    state_j = jadamw.init_opt_state(params_j, master_in_opt)
    params_t = {k: t(np.asarray(v, np.float32)).to(torch.bfloat16 if master_in_opt
                                                   else torch.float32)
                for k, v in _flat(params_j).items()}
    state_t = tadamw.init_opt_state(params_t, master_in_opt)
    assert state_t["count"].dtype == torch.int32
    for step in range(3):
        grads = _tree(10 + step)
        params_j, state_j, mj = jadamw.apply_updates(params_j, grads, state_j, cfg_j)
        params_t, state_t, mt = tadamw.apply_updates(
            params_t, {k: t(v) for k, v in _flat(grads).items()}, state_t, cfg_t)
        np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-6)
        assert float(mt["lr"]) == float(mj["lr"])  # f32 warm-up, count 1..3
    assert int(state_t["count"]) == int(state_j["count"]) == 3
    for key in ("mu", "nu") + (("master",) if master_in_opt else ()):
        for k, v in _flat(state_j[key]).items():
            close(state_t[key][k], v, dict(rtol=1e-6, atol=0))
    for k, v in _flat(params_j).items():
        assert params_t[k].dtype == (torch.bfloat16 if master_in_opt else torch.float32)
        close(params_t[k], np.asarray(v, np.float32), dict(rtol=1e-6, atol=0))


def test_clip_by_global_norm_matches_jax():
    grads = _tree(3)
    got, gn = tadamw.clip_by_global_norm({k: t(v) for k, v in _flat(grads).items()}, 1.0)
    want, wn = jadamw.clip_by_global_norm(grads, 1.0)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    for k, v in _flat(want).items():
        close(got[k], v, dict(rtol=1e-6, atol=0))


# ---------------------------------------------------------------------------
# top-k compression
# ---------------------------------------------------------------------------
def _tied(seed, shape, zeros=0.5):
    """Gradients with many exact zeros and repeated magnitudes (ties)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(-3, 4, shape).astype(np.float32) * 0.25
    g[rng.random(shape) < zeros] = 0.0
    return g


def test_compress_grad_ties_and_zeros():
    cfg_j = jcompress.CompressConfig(density=0.3, min_size=1)
    cfg_t = tcompress.CompressConfig(density=0.3, min_size=1)
    g, err = _tied(0, (7, 9)), _tied(1, (7, 9), zeros=0.8)
    jv, ji, jr = jcompress.compress_grad(jnp.asarray(g), jnp.asarray(err), cfg_j)
    tv, ti, tr = tcompress.compress_grad(t(g), t(err), cfg_t)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tcompress.decompress(tv, ti, (7, 9)).numpy(),
                                  np.asarray(jcompress.decompress(jv, ji, (7, 9))))


def _stacked_tree(seed, L=4):
    """A JAX-layout tree: ``layers`` leaves stacked on a leading axis of L."""
    return {
        "embed": _tied(seed, (12, 8)),
        "final_norm": _tied(seed + 1, (8,)),
        "layers": {"ln1": _tied(seed + 2, (L, 16)),
                   "attn": {"wq": _tied(seed + 3, (L, 8, 2, 4)), "wo": _tied(seed + 4, (L, 2, 4))}},
        "lm_head": _tied(seed + 5, (8, 12)),
    }


def test_compress_tree_on_stacked_leaves_around_min_size():
    """min_size 40: each layer's ln1 (16) would go dense, the stacked (4, 16)
    = 64 is compressed, and so is the stacked (4, 2, 4) = 32 -> dense.
    Two rounds, so the error state feeds back."""
    cfg_j = jcompress.CompressConfig(density=0.25, min_size=40)
    cfg_t = tcompress.CompressConfig(density=0.25, min_size=40)
    err_j = jcompress.init_error_state(_stacked_tree(0))
    err_t = tcompress.init_error_state({k: t(v) for k, v in unstack(_stacked_tree(0)).items()})
    for seed in (0, 10):
        grads = _stacked_tree(seed)
        (tdef, jreps), err_j = jcompress.compress_tree(grads, err_j, cfg_j)
        (groups, treps), err_t = tcompress.compress_tree(
            {k: t(v) for k, v in unstack(grads).items()}, err_t, cfg_t)
        assert [p for p, _ in groups] == ["embed", "final_norm", "layers.attn.wo",
                                          "layers.attn.wq", "layers.ln1", "lm_head"]
        assert [r[0] for r in treps] == [r[0] for r in jreps] == \
            ["topk", "dense", "dense", "topk", "topk", "topk"]
        for (kind, tp), (_, jp) in zip(treps, jreps):
            if kind == "dense":
                np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
            else:
                assert tp[2] == tuple(jp[2])
                np.testing.assert_array_equal(tp[1].numpy(), np.asarray(jp[1]))
                np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp[0]))
        want_err = unstack(jax.tree.map(np.asarray, err_j))
        for k, v in err_t.items():
            np.testing.assert_array_equal(v.numpy(), want_err[k])
        dec_j = unstack(jax.tree.map(np.asarray, jcompress.decompress_tree((tdef, jreps))))
        for k, v in tcompress.decompress_tree((groups, treps)).items():
            np.testing.assert_array_equal(v.numpy(), dec_j[k])
    tree_t = {k: t(v) for k, v in unstack(_stacked_tree(0)).items()}
    assert tcompress.compression_ratio(tree_t, cfg_t) == \
        jcompress.compression_ratio(_stacked_tree(0), cfg_j)


def test_compress_tree_picks_the_reference_indices_on_lm_grads(lm_grads):
    """The OLMoE SMOKE gradient (exact zeros and all): the same entries."""
    _, _, _, _, grads = lm_grads("olmoe-1b-7b")
    cfg_j = jcompress.CompressConfig(density=0.05, min_size=256)
    cfg_t = tcompress.CompressConfig(density=0.05, min_size=256)
    (_, jreps), _ = jcompress.compress_tree(grads, jcompress.init_error_state(grads), cfg_j)
    flat = {k: t(v) for k, v in unstack(grads).items()}
    (groups, treps), _ = tcompress.compress_tree(flat, tcompress.init_error_state(flat), cfg_t)
    assert len(groups) == len(jax.tree.leaves(grads))
    assert any(kind == "topk" and p.startswith("layers.") for (p, _), (kind, _) in
               zip(groups, treps))
    for (kind, tp), (jkind, jp) in zip(treps, jreps):
        assert kind == jkind
        if kind == "topk":
            np.testing.assert_array_equal(tp[1].numpy(), np.asarray(jp[1]))
            np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp[0]))


# ---------------------------------------------------------------------------
# the data pipeline's contract
# ---------------------------------------------------------------------------
def test_pipeline_same_step_same_batch():
    cfg = DataConfig(seq_len=32, global_batch=4, vocab=100, seed=3)
    a, b = synthetic_batch(cfg, 5, "cpu"), synthetic_batch(cfg, 5, "cpu")
    assert torch.equal(a["inputs"], b["inputs"]) and torch.equal(a["targets"], b["targets"])
    assert not torch.equal(synthetic_batch(cfg, 6, "cpu")["inputs"], a["inputs"])
    other_seed = dataclasses.replace(cfg, seed=4)
    assert not torch.equal(synthetic_batch(other_seed, 5, "cpu")["inputs"], a["inputs"])
    assert a["inputs"].shape == a["targets"].shape == (4, 32)
    assert a["inputs"].dtype == torch.int32
    assert torch.equal(a["inputs"][:, 1:], a["targets"][:, :-1])  # shifted by one
    assert int(a["inputs"].min()) >= 0 and int(a["inputs"].max()) < 100


def test_pipeline_structure_is_ramps_and_noise():
    cfg = DataConfig(seq_len=256, global_batch=16, vocab=1000, seed=0)
    x = synthetic_batch(cfg, 0, "cpu")
    seq = torch.cat([x["inputs"], x["targets"][:, -1:]], 1).long()
    ramp = (seq[:, 1:] - seq[:, :-1]) % cfg.vocab == 1
    share = float(ramp.float().mean())
    assert 0.75 < share < 0.9, share  # ~0.9 x 0.9 of the neighbours follow the ramp


def test_pipeline_embeds_mode():
    cfg = DataConfig(seq_len=8, global_batch=2, vocab=50, input_mode="embeds", d_model=16)
    x = synthetic_batch(cfg, 1, "cpu")
    assert x["inputs"].shape == (2, 8, 16) and x["inputs"].dtype == torch.float32
    assert x["targets"].shape == (2, 8) and int(x["targets"].max()) < 50


def test_prefetcher_resumes_the_same_stream():
    """A restart at step 3 yields what the uninterrupted stream did there."""
    cfg = DataConfig(seq_len=16, global_batch=2, vocab=64, seed=9)
    first = [next(Prefetcher(cfg, 0, "cpu")) for _ in range(1)]
    stream = Prefetcher(cfg, 0, "cpu")
    batches = [next(stream) for _ in range(5)]
    assert torch.equal(first[0]["inputs"], batches[0]["inputs"])
    resumed = Prefetcher(cfg, 3, "cpu")
    for want in batches[3:]:
        got = next(resumed)
        assert torch.equal(got["inputs"], want["inputs"])
    assert resumed.step == 5
    for s, want in enumerate(batches):
        assert torch.equal(synthetic_batch(cfg, s, "cpu")["targets"], want["targets"])
