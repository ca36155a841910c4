"""The port's training loss and gradients on gloo process meshes against
the JAX package.

The port runs one process per mesh point (gloo, on the CPU), each holding
its f32 master slices of the JAX package's seeded weights
(``lm_params_from_reference(..., master=True, mesh=)``); the JAX package
runs ``lm_loss`` and ``forward`` (jitted, sharded) on as many host
devices. Meshes 1x2, 2x1 and 2x2 ("data" x "model"), a global batch of
B = 4 from one numpy seed. Checks:

  * the loss and the aux loss against the JAX mesh's, rtol 1e-5, for
    starcoder2, gemma2 (tied, vocab-split embedding), granite (one kv
    head), olmoe at S = 8 ("a2a": the sequence split over "model") and S
    = 7 ("dense_ep") and deepseek-moe at S = 8 (its shared experts sum
    other tokens' partials in "a2a", as the JAX package's do);
  * the gradient, assembled from every rank's slice (concatenated over
    "model", summed over "data"), against the JAX package's one-device
    gradient (a 1 x 1 mesh): the JAX mesh gradient is 1/tp of the
    gradient of its own loss (ROADMAP §3.1), so it is no target. Dense
    archs on every mesh; olmoe with capacity_factor raised in both
    packages so that no assignment drops and aux_weight 0, where routing
    each shard alone is the one-device computation. A replicated
    parameter's gradient is the same on every model rank, bit for bit;
  * everywhere else (default capacity, the aux term, deepseek's shared
    experts in "a2a") a directional-derivative check of the port's own
    mesh loss in f64 (``tools/torch_grad_f64.py``'s switch): the central
    difference along one seeded direction, ε = 1e-6, against ⟨∇L, v⟩
    within rtol 1e-5; a direction whose ±ε runs route differently on any
    rank is redrawn;
  * the JAX package's faults that shape these targets: on 1x2 its
    starcoder2, mamba2 and zamba2 losses equal the one-device losses while
    every gradient leaf is 1/2 of the one-device one; its "dp" strategy
    cannot train olmoe, and the port's raises a ValueError.

Tolerances: losses rtol 1e-5 (f32 sums in other orders); gradients as
``tests/test_torch_train.py``'s ``close_model_grad`` (rtol 1e-4, atol
1e-5 of the tensor's largest entry).

The JAX side runs once for the module, one subprocess a mesh shape (1x1
included), all started together, each with 8 host devices (XLA's LLVM backend at -O0):

    python tests/test_torch_mesh_train.py --reference INPUTS.pkl OUT.pkl 2x2

which imports JAX only in that branch. The port's ranks are this file's
module-level functions, and its top imports no JAX.
"""
import os
import pickle
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((1, 2), (2, 1), (2, 2))
SEED = 7
B = 4
AUX = 0.01
HIGH_CAPACITY = 100.0  # capacity_factor at which no assignment drops
CASES = (("starcoder2-7b", 8), ("gemma2-9b", 8), ("granite-20b", 8),
         ("olmoe-1b-7b", 8), ("olmoe-1b-7b", 7), ("deepseek-moe-16b", 8))
DENSE = ("starcoder2-7b", "gemma2-9b", "granite-20b")
F64_CASES = (("olmoe-1b-7b", 8), ("olmoe-1b-7b", 7), ("deepseek-moe-16b", 8))
# the cases each mesh runs (the test's time budget): every case with a
# model axis; on 2x1 (data only) one dense arch and the MoE "a2a" ones; on
# 1x1 (the reference only) the one-device gradients
CASES_ON = {(2, 1): (("starcoder2-7b", 8), ("olmoe-1b-7b", 8), ("deepseek-moe-16b", 8)),
            (1, 1): (("starcoder2-7b", 8), ("gemma2-9b", 8), ("granite-20b", 8),
                     ("olmoe-1b-7b", 8), ("olmoe-1b-7b", 7))}
F64_SHAPES = ((1, 2), (2, 2))
ARCHS = sorted({a for a, _ in CASES})
# fault 1 on the ssm and hybrid families: the JAX mesh gradient against its
# one-device gradient alone (the port's side is tests/test_torch_mesh_ssm.py)
FAULT1_ARCHS = ("starcoder2-7b", "mamba2-370m", "zamba2-2.7b")
EPS = 1e-6
DIRECTIONS = 3  # seeded directions tried before a check gives up on routing flips
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_MAX_ATOL = 1e-4, 1e-5
SPAWN_TIMEOUT_S = 300  # a bound for a hung rank, not a run time
REFERENCE_TIMEOUT_S = 600  # likewise, for the reference's subprocesses together

pytestmark = pytest.mark.slow


def _tag(shape):
    return "x".join(map(str, shape))


def _cid(case):
    return f"{case[0]}-s{case[1]}"


def _inputs():
    from repro_torch.configs import get_config

    rng = np.random.default_rng(SEED)
    out = {}
    for case in CASES:
        vocab = get_config(case[0], smoke=True).vocab
        out[_cid(case)] = (rng.integers(0, vocab, (B, case[1])).astype(np.int32),
                           rng.integers(0, vocab, (B, case[1])).astype(np.int32))
    for arch in FAULT1_ARCHS[1:]:
        vocab = get_config(arch, smoke=True).vocab
        out[_cid((arch, 8))] = (rng.integers(0, vocab, (B, 8)).astype(np.int32),
                                rng.integers(0, vocab, (B, 8)).astype(np.int32))
    return out


def _high_capacity(cfg):
    import dataclasses

    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            capacity_factor=HIGH_CAPACITY))


def _direction(arch, seed):
    """{parameter name: f64 array} of a seeded direction over the whole model."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm

    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(tuple(p.shape)) for n, p in
            tfm.init_params(get_config(arch, smoke=True), None, "meta").named_parameters()}


def _weights(arch):
    """The JAX package's parameter tree for ``arch`` (its names and shapes,
    from ``jax.eval_shape`` of its init) filled from one numpy seed: every
    matrix N(0, 0.05²), every vector (norm scales) N(0, 0.1²)."""
    import jax

    from repro.configs import get_config
    from repro.models import transformer as jtfm

    shapes = jax.eval_shape(lambda: jtfm.init_params(get_config(arch, smoke=True),
                                                     jax.random.PRNGKey(0)))
    rng = np.random.default_rng(SEED)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape)
                                   * (0.05 if len(s.shape) > 1 else 0.1)).astype(np.float32),
                        shapes)


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------
def _grads(cfg, model, x, y, mesh, aux_weight):
    from repro_torch.models import transformer as tfm
    from repro_torch.train import value_and_grad

    loss, g = value_and_grad(lambda p: tfm.lm_loss(cfg, p, x, y, mesh, aux_weight=aux_weight),
                             model)
    return float(loss), {n: t.detach().numpy() for n, t in g.items()}


def _f64_check(mesh, cfg, params, x, y):
    """L(θ ± εv) along seeded directions v, each run's routing recorded: the
    first direction whose two runs route alike on every rank. Returns
    (seed, L+, L-, this rank's f64 gradient slices)."""
    import torch

    from repro_torch.core.convert import lm_params_from_reference
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import leaf_spec, shard_tensor

    specs = tfm.param_specs(cfg, mesh.shape["model"])
    model = lm_params_from_reference(cfg, params, "cpu", master=True, mesh=mesh)
    loss, grads = _grads(cfg, model, x, y, mesh, AUX)
    routes, inner = [], moe_mod._dispatch_indices

    def recorded(top_e, cfg_, cap):
        eid, slot, keep = inner(top_e, cfg_, cap)
        routes.append((eid.numpy().copy(), keep.numpy().copy()))
        return eid, slot, keep

    moe_mod._dispatch_indices = recorded
    try:
        for seed in range(DIRECTIONS):
            v = _direction(cfg.arch_id.removesuffix("-smoke"), SEED + 100 + seed)
            at = []
            for sign in (1.0, -1.0):
                routes.clear()
                moved = {n: p.detach() + sign * EPS * shard_tensor(
                    torch.as_tensor(v[n]), leaf_spec(specs, n), mesh)
                    for n, p in model.named_parameters()}
                with torch.no_grad():
                    at.append((float(tfm.lm_loss(cfg, _tree(moved), x, y, mesh,
                                                 aux_weight=AUX)), list(routes)))
            flip = any(not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))
                       for a, b in zip(at[0][1], at[1][1]))
            if not int(mesh.pmax_all(torch.tensor(int(flip)))):
                return seed, at[0][0], at[1][0], grads
    finally:
        moe_mod._dispatch_indices = inner
    raise AssertionError(f"{cfg.arch_id}: routing flips under ±{EPS} in {DIRECTIONS} directions")


def _tree(flat):
    from repro_torch.models.common import ParamTree, unflatten

    return ParamTree(unflatten(flat))


def _port_rank(mesh, inputs_path):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.convert import lm_params_from_reference
    from repro_torch.models import transformer as tfm

    with open(inputs_path, "rb") as f:  # a file: a large argument slows the spawn
        inp, params = pickle.load(f)
    shape = tuple(mesh.sizes)
    out = {"coords": mesh.coords, "cases": {}, "high_capacity": {}, "f64": {}}
    for case in CASES_ON.get(shape, CASES):
        arch = case[0]
        cfg = get_config(arch, smoke=True)
        x, y = (torch.as_tensor(a) for a in inp[_cid(case)])
        model = lm_params_from_reference(cfg, params[arch], "cpu", master=True, mesh=mesh)
        loss, grads = _grads(cfg, model, x, y, mesh, AUX)
        with torch.no_grad():
            logits, aux = tfm.forward(cfg, model, x, mesh)
        out["cases"][_cid(case)] = {"loss": loss, "aux": float(aux), "grads": grads,
                                    "logits_shape": tuple(logits.shape)}
        if cfg.moe and arch == "olmoe-1b-7b":
            out["high_capacity"][_cid(case)] = _grads(_high_capacity(cfg), model, x, y, mesh, 0.0)
    f32, to_float = torch.float32, torch.Tensor.float
    torch.float32 = torch.float64  # every "f32" of the models means f64 for this run
    torch.Tensor.float = lambda self, *a, **k: self.to(torch.float64)
    try:
        for case in F64_CASES if shape in F64_SHAPES else ():
            cfg = get_config(case[0], smoke=True)
            x, y = (torch.as_tensor(a) for a in inp[_cid(case)])
            out["f64"][_cid(case)] = _f64_check(mesh, cfg, params[case[0]], x, y)
    finally:
        torch.float32, torch.Tensor.float = f32, to_float
    out["loaded"] = sorted(m for m in ("jax", "jaxlib", "repro") if m in sys.modules)
    return out


# ---------------------------------------------------------------------------
# the JAX side (subprocess only)
# ---------------------------------------------------------------------------
def _reference(inputs_path, out_path, tag):
    import dataclasses

    import jax

    from repro.compat import set_mesh
    from repro.configs import get_config
    from repro.launch.mesh import make_debug_mesh
    from repro.models import transformer as tfm
    from repro.optim import adamw
    from repro.train.step import TrainConfig, build_train_step

    with open(inputs_path, "rb") as f:
        inp, params = pickle.load(f)  # the weights, made once by the test process
    shape = tuple(int(x) for x in tag.split("x"))
    mesh = make_debug_mesh(*shape)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    res = {"loss": {}, "aux": {}, "grad": {}, "high_capacity": {}}
    with set_mesh(mesh):
        for case in CASES_ON.get(shape, CASES):
            arch, cid = case[0], _cid(case)
            cfg = get_config(arch, smoke=True)
            x, y = inp[cid]

            def loss_and_aux(p, cfg=cfg, aux=AUX):  # a dense model's aux is 0
                return (tfm.lm_loss(cfg, p, x, y, mesh, aux_weight=aux),
                        tfm.forward(cfg, p, x, mesh)[1] if cfg.moe else 0.0)

            # gradients with remat off: the same arithmetic, compiled in a
            # fifth of the time (the port keeps remat on)
            plain = dataclasses.replace(cfg, remat=False)
            if (tag == "1x1" and arch in DENSE) or (tag == "1x2" and arch == "starcoder2-7b"):
                (loss, aux), g = jax.jit(jax.value_and_grad(
                    lambda p, c=plain: loss_and_aux(p, c), has_aux=True))(params[arch])
                res["grad"][cid] = np_tree(g)
            elif tag == "1x1":  # olmoe: the gradient without drops alone
                res["high_capacity"][cid] = np_tree(jax.jit(jax.grad(
                    lambda p, c=_high_capacity(plain): loss_and_aux(p, c, 0.0)[0]))(params[arch]))
                continue
            else:
                loss, aux = jax.jit(loss_and_aux)(params[arch])
            res["loss"][cid], res["aux"][cid] = float(loss), float(aux)
        if tag in ("1x1", "1x2"):  # fault 1's ssm and hybrid cases
            for arch in FAULT1_ARCHS[1:]:
                cid = _cid((arch, 8))
                plain = dataclasses.replace(get_config(arch, smoke=True), remat=False)
                x, y = inp[cid]
                loss, g = jax.jit(jax.value_and_grad(
                    lambda p, c=plain: tfm.lm_loss(c, p, x, y, mesh)))(params[arch])
                res["loss"][cid], res["grad"][cid] = float(loss), np_tree(g)
        if tag == "2x2":  # "dp" on an MoE model
            cfg = get_config("olmoe-1b-7b", smoke=True)
            x, y = inp[_cid(("olmoe-1b-7b", 8))]
            try:
                step, _, _ = build_train_step(cfg, mesh, TrainConfig(strategy="dp"),
                                              global_batch=B)
                step(params["olmoe-1b-7b"], adamw.init_opt_state(params["olmoe-1b-7b"]),
                     {"inputs": x, "targets": y})
                res["dp_moe"] = None
            except Exception as e:  # noqa: BLE001 - the fault's own type is the finding
                res["dp_moe"] = f"{type(e).__name__}: {e}"
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results by shape tag, {shape: per-rank port results}, the
    reference's parameters): the reference's subprocesses and the port's
    ranks run side by side."""
    from repro_torch.launch import spawn

    work = tmp_path_factory.mktemp("mesh_train")
    params = {a: _weights(a) for a in ARCHS + list(FAULT1_ARCHS[1:])}
    inp = _inputs()
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump((inp, params), f)
    # LLVM at -O0 halves the reference's compile time; it keeps IEEE
    # arithmetic (no fast-math), so the values are the same computation's
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_backend_optimization_level=0")
    tags = ["1x1"] + [_tag(s) for s in SHAPES]
    refs = {}
    deadline = time.monotonic() + REFERENCE_TIMEOUT_S
    try:
        for tag in tags:
            with open(work / f"reference_{tag}.log", "w") as log:
                refs[tag] = subprocess.Popen(
                    [sys.executable, __file__, "--reference", str(work / "inputs.pkl"),
                     str(work / f"reference_{tag}.pkl"), tag],
                    env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        def run(shape):  # each mesh its own rendezvous directory
            (work / _tag(shape)).mkdir()
            return spawn.run_mesh(_port_rank, shape, backend="gloo", device="cpu",
                                  args=(str(work / "inputs.pkl"),), timeout_s=SPAWN_TIMEOUT_S,
                                  workdir=work / _tag(shape))

        with ThreadPoolExecutor(len(SHAPES)) as pool:  # the meshes side by side
            port = dict(zip(SHAPES, pool.map(run, SHAPES)))
        for ref in refs.values():
            ref.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for ref in refs.values():
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    ref = {}
    for tag in tags:
        log = (work / f"reference_{tag}.log").read_text()
        assert refs[tag].returncode == 0, f"{tag}: {log[-4000:]}"
        with open(work / f"reference_{tag}.pkl", "rb") as f:
            ref[tag] = pickle.load(f)
    return ref, port, params


def _unstack(tree, path=()):
    """{port parameter name: array} of a JAX tree (layers unstacked)."""
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out.update(_unstack(node, path + (name,)))
        elif path and path[0] == "layers":
            for i in range(node.shape[0]):
                out[".".join(("layers", str(i)) + path[1:] + (name,))] = node[i]
        else:
            out[".".join(path + (name,))] = node
    return out


def _assemble(ranks, shape, arch, pick):
    """{name: whole gradient}: every rank's slice (``pick(rank)[name]``)
    concatenated over "model" under the parameter's spec and summed over
    "data"; a replicated leaf must be the same on every model rank."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as ttfm
    from repro_torch.models.common import leaf_spec

    specs = ttfm.param_specs(get_config(arch, smoke=True), shape[1])
    by = {(r["coords"]["data"], r["coords"]["model"]): pick(r) for r in ranks}
    out = {}
    for name in by[(0, 0)]:
        spec = tuple(leaf_spec(specs, name))
        dims = [i for i, e in enumerate(spec) if e == "model"]
        total = 0
        for d in range(shape[0]):
            blocks = [by[(d, m)][name] for m in range(shape[1])]
            if dims:
                whole = np.concatenate(blocks, axis=dims[0])
            else:
                for m, blk in enumerate(blocks[1:], 1):
                    np.testing.assert_array_equal(blk, blocks[0], err_msg=f"{name} rank ({d}, {m})")
                whole = blocks[0]
            total = total + whole
        out[name] = total
    return out


def _close_grad(got, want, name):
    want = np.asarray(want, dtype=np.float32)
    atol = max(1e-6, GRAD_MAX_ATOL * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol, err_msg=name)


def test_ranks_load_no_jax(runs):
    _, port, _ = runs
    for shape, ranks in port.items():
        assert all(r["loaded"] == [] for r in ranks), [r["loaded"] for r in ranks]
        assert [r["coords"] for r in ranks] == [
            {"data": d, "model": m} for d in range(shape[0]) for m in range(shape[1])]


@pytest.mark.parametrize("shape,case", [(s, c) for s in SHAPES for c in CASES_ON.get(s, CASES)],
                         ids=lambda x: _tag(x) if isinstance(x[0], int) else _cid(x))
def test_loss_and_aux_match_the_jax_mesh(runs, shape, case):
    ref, port, _ = runs
    cid = _cid(case)
    for r in port[shape]:
        got = r["cases"][cid]
        np.testing.assert_allclose(got["loss"], ref[_tag(shape)]["loss"][cid], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["aux"], ref[_tag(shape)]["aux"][cid], rtol=LOSS_RTOL,
                                   atol=1e-7)
        assert got["logits_shape"][:2] == (B, case[1])
        assert got["loss"] == port[shape][0]["cases"][cid]["loss"]  # every rank alike


@pytest.mark.parametrize("shape,arch", [(s, a) for s in SHAPES for a in DENSE
                                        if (a, 8) in CASES_ON.get(s, CASES)],
                         ids=lambda x: _tag(x) if isinstance(x, tuple) else x)
def test_dense_grads_match_jax_one_device(runs, shape, arch):
    ref, port, _ = runs
    cid = _cid((arch, 8))
    got = _assemble(port[shape], shape, arch, lambda r: r["cases"][cid]["grads"])
    want = _unstack(ref["1x1"]["grad"][cid])
    assert sorted(got) == sorted(want)
    for name in want:
        _close_grad(got[name], want[name], name)


@pytest.mark.parametrize("shape,seq", [(s, q) for s in SHAPES for q in (8, 7)
                                       if ("olmoe-1b-7b", q) in CASES_ON.get(s, CASES)],
                         ids=lambda x: _tag(x) if isinstance(x, tuple) else f"s{x}")
def test_moe_grads_without_drops_match_jax_one_device(runs, shape, seq):
    """No assignment drops and no aux term: each shard routed alone is the
    one-device computation, so the gradient is the one-device gradient."""
    ref, port, _ = runs
    cid = _cid(("olmoe-1b-7b", seq))
    for r in port[shape]:
        np.testing.assert_allclose(r["high_capacity"][cid][0],
                                   port[shape][0]["high_capacity"][cid][0], rtol=0)
    got = _assemble(port[shape], shape, "olmoe-1b-7b", lambda r: r["high_capacity"][cid][1])
    want = _unstack(ref["1x1"]["high_capacity"][cid])
    for name in want:
        _close_grad(got[name], want[name], name)


@pytest.mark.parametrize("case", F64_CASES, ids=_cid)
@pytest.mark.parametrize("shape", F64_SHAPES, ids=_tag)
def test_f64_directional_derivative_of_the_mesh_loss(runs, shape, case):
    """Default capacity, the aux term, deepseek's shared experts in "a2a":
    the port's gradient is the derivative of its own mesh loss."""
    _, port, _ = runs
    cid = _cid(case)
    seeds = {r["f64"][cid][0] for r in port[shape]}
    assert len(seeds) == 1
    seed, up, down, _ = port[shape][0]["f64"][cid]
    assert all(r["f64"][cid][1:3] == (up, down) for r in port[shape])
    g = _assemble(port[shape], shape, case[0], lambda r: r["f64"][cid][3])
    assert all(t.dtype == np.float64 for t in g.values())
    v = _direction(case[0], SEED + 100 + seed)
    dot = sum(float(np.vdot(g[n], v[n])) for n in v)
    np.testing.assert_allclose((up - down) / (2 * EPS), dot, rtol=1e-5)


def test_jax_mesh_gradient_is_one_over_tp_of_its_loss(runs):
    """Fault 1 of the JAX package (ROADMAP §3.1): on 1x2 its loss is the
    one-device loss, and every gradient leaf is half the one-device one,
    on starcoder2 and on the ssm and hybrid families (mamba2's ``conv_w``,
    ``w_bc``, ``A_log``, zamba2's shared block, the embeddings)."""
    ref, _, _ = runs
    for arch in FAULT1_ARCHS:
        cid = _cid((arch, 8))
        np.testing.assert_allclose(ref["1x2"]["loss"][cid], ref["1x1"]["loss"][cid], rtol=1e-6)
        mesh_g, one_g = _unstack(ref["1x2"]["grad"][cid]), _unstack(ref["1x1"]["grad"][cid])
        assert (arch == "zamba2-2.7b") == any(n.startswith("shared_block.") for n in one_g)
        for name in one_g:
            _close_grad(2.0 * mesh_g[name], one_g[name], f"{arch} {name}")
            assert np.abs(one_g[name]).max() > 0, (arch, name)


def test_dp_strategy_cannot_train_moe(runs):
    """Fault 3: the JAX package's "dp" step fails on an MoE model; the
    port's refuses it with a ValueError."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train import TrainConfig, build_train_step

    ref, _, _ = runs
    assert ref["2x2"]["dp_moe"] is not None and ref["2x2"]["dp_moe"].startswith("AttributeError")
    with pytest.raises(ValueError, match="dp"):
        build_train_step(get_config("olmoe-1b-7b", smoke=True), TrainConfig(strategy="dp"),
                         "cpu", mesh=make_debug_mesh(1, 1, device="cpu"))


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference(*sys.argv[2:5])
