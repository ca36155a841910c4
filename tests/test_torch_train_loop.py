"""The port's train step, restartable loop, hierarchical data parallelism
and launcher against the JAX package's, on the CPU.

Both packages start from one parameter set (the JAX package's seeded
init, carried over by ``lm_params_from_reference(..., master=True)``) and
take the same numpy batches (the JAX package's ``synthetic_batch``). The
JAX train step runs as its own tests run it: ``build_train_step`` under a
1x1 ("data", "model") mesh, whose vocab-parallel loss equals the port's
single-device loss there.

Tolerances: losses within rtol 1e-5 a step and the gradient norm within
rtol 1e-5 (f32 sums in other orders). Parameters after 5 steps within
rtol 1e-4 / atol 1e-6 on at least 99.9 % of each leaf's entries, and
every entry within atol 1e-4 (lr / 30): AdamW's update m/√v of an entry
whose gradient is near 0 turns a summation-order difference in that
gradient into an update as large as the gradient's sign allows (seen: one
entry in 8192 off by 3.8e-5 after 5 steps at lr 3e-3). ``wire_bytes``
exact. The port against itself
(a restarted or rolled-back loop against the uninterrupted one, the
replicas of the cross-cluster step) bit for bit: on the CPU every step
repeats its bits.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import AxisType, make_mesh, set_mesh
from repro.configs import get_config as j_get_config
from repro.data import DataConfig as JDataConfig
from repro.data import synthetic_batch as j_synthetic_batch
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.runtime import FailureInjector as JFailureInjector
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.runtime import run_training as j_run_training
from repro.runtime.hierarchical import CrossClusterDP as JCrossClusterDP
from repro.train import TrainConfig as JTrainConfig
from repro.train import build_train_step as j_build_train_step
from repro_torch.configs import get_config
from repro_torch.core.convert import lm_params_from_reference, opt_state_from_reference
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress
from repro_torch.runtime import CrossClusterDP, FailureInjector, RuntimeConfig, run_training
from repro_torch.runtime import driver
from repro_torch.train import TrainConfig, build_train_step

LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_SHARE = 0.999  # of a leaf's entries held to PARAM_TOL
ADAM_ATOL = 1e-4  # every entry
STEPS = 5
TRAIN_ARCHS = ("olmoe-1b-7b", "deepseek-moe-16b", "starcoder2-7b")
OPT = dict(lr=3e-3, warmup_steps=2)


@pytest.fixture(scope="module")
def mesh():
    dev = np.array(jax.devices()[:1]).reshape(1, 1)
    return make_mesh(dev, ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


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


def assert_params(model, want_tree):
    """PARAM_TOL on PARAM_SHARE of each leaf's entries, ADAM_ATOL on all."""
    want = unstack(np_tree(want_tree))
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        x, w = p.detach().numpy(), want[name]
        np.testing.assert_allclose(x, w, rtol=0, atol=ADAM_ATOL, err_msg=name)
        near = np.abs(x - w) <= PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(w)
        assert near.mean() >= PARAM_SHARE, (name, int((~near).sum()), near.size)


def jax_batches(cfg, n, seq=8, batch=4, first=0):
    dcfg = JDataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab)
    return [np_tree(j_synthetic_batch(dcfg, s)) for s in range(first, first + n)]


def port_model(arch, params):
    return lm_params_from_reference(get_config(arch, smoke=True), params, "cpu", master=True)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_steps(mesh):
    """The JAX package's STEPS (+1) train steps per (arch, microbatches):
    the initial parameters, the batches, each step's loss and gradient
    norm, and the parameters and optimizer state after STEPS."""
    runs = {}

    def get(arch, mb):
        if (arch, mb) not in runs:
            cfg = j_get_config(arch, smoke=True)
            step_fn, _, _ = j_build_train_step(cfg, mesh, JTrainConfig(
                optimizer=jadamw.AdamWConfig(**OPT), microbatches=mb))
            params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
            init = np_tree(params)
            opt = jadamw.init_opt_state(params)
            batches = jax_batches(cfg, STEPS + 1)
            losses, norms = [], []
            with set_mesh(mesh):
                for s in range(STEPS):
                    params, opt, m = step_fn(params, opt, batches[s])
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
                    if s == STEPS - 1:
                        after = (np_tree(params), np_tree(opt))
                params, _, m = step_fn(params, opt, batches[STEPS])
            runs[arch, mb] = {"init": init, "batches": batches, "losses": losses,
                              "norms": norms, "after": after, "next_loss": float(m["loss"]),
                              "next_params": np_tree(params)}
        return runs[arch, mb]

    return get


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_matches_jax(arch, mb, jax_steps):
    ref = jax_steps(arch, mb)
    cfg = get_config(arch, smoke=True)
    model = port_model(arch, ref["init"])
    opt = tadamw.init_opt_state(model)
    step = build_train_step(cfg, TrainConfig(optimizer=tadamw.AdamWConfig(**OPT),
                                             microbatches=mb), device="cpu")
    for s in range(STEPS):
        model, opt, m = step(model, opt, ref["batches"][s])
        np.testing.assert_allclose(float(m["loss"]), ref["losses"][s], rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), ref["norms"][s], rtol=LOSS_RTOL)
    assert int(opt["count"]) == STEPS
    assert_params(model, ref["after"][0])


def test_microbatches_split_the_batch():
    """Two microbatches of 2 give the mean of the two half-batch losses."""
    cfg = get_config("starcoder2-7b", smoke=True)
    batch = jax_batches(j_get_config("starcoder2-7b", smoke=True), 1)[0]
    model = ttfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu", master=True)
    halves = [float(ttfm.lm_loss(cfg, model, torch.tensor(batch["inputs"][i:i + 2]),
                                 torch.tensor(batch["targets"][i:i + 2]))) for i in (0, 2)]
    step = build_train_step(cfg, TrainConfig(microbatches=2), device="cpu")
    _, _, m = step(model, tadamw.init_opt_state(model), batch)
    np.testing.assert_allclose(float(m["loss"]), sum(h / 2 for h in halves), rtol=1e-6)


def test_strategies_are_one_computation_and_unknown_refused():
    with pytest.raises(ValueError, match="strategy"):
        build_train_step(get_config("olmoe-1b-7b", smoke=True), TrainConfig(strategy="fsdp"),
                         device="cpu")
    assert TrainConfig().strategy == JTrainConfig().strategy == "tp"


def test_opt_state_from_reference_trains_on(jax_steps):
    """Both packages go on from the JAX package's state after STEPS steps
    (parameters and AdamW state carried over): the next step agrees."""
    arch = "olmoe-1b-7b"
    ref = jax_steps(arch, 1)
    cfg = get_config(arch, smoke=True)
    params, opt_j = ref["after"]
    model = port_model(arch, params)
    opt = opt_state_from_reference(cfg, opt_j, "cpu")
    assert int(opt["count"]) == STEPS and opt["count"].dtype == torch.int32
    assert sorted(opt["mu"]) == sorted(dict(model.named_parameters()))
    step = build_train_step(cfg, TrainConfig(optimizer=tadamw.AdamWConfig(**OPT)), device="cpu")
    model, opt, m = step(model, opt, ref["batches"][STEPS])
    np.testing.assert_allclose(float(m["loss"]), ref["next_loss"], rtol=LOSS_RTOL)
    assert_params(model, ref["next_params"])


# ---------------------------------------------------------------------------
# the restartable loop
# ---------------------------------------------------------------------------
LOOP_STEPS = 12


def _loop_pieces(arch):
    cfg_j = j_get_config(arch, smoke=True)
    params = np_tree(jtfm.init_params(cfg_j, jax.random.PRNGKey(0)))
    batches = jax_batches(cfg_j, 2 * LOOP_STEPS, seq=8, batch=2)

    def batch_fn(s, poison=()):
        return {**batches[s], "poison": s in poison}

    return cfg_j, params, batches, batch_fn


def _poisoning(step):
    """A step that returns a NaN loss on a poisoned batch (after updating:
    the rollback must discard that state)."""
    def wrapped(state, batch):
        batch = dict(batch)
        poisoned = batch.pop("poison")
        state, m = step(state, batch)
        return state, ({**m, "loss": math.nan} if poisoned else m)

    return wrapped


def _port_loop(arch, params, batch_fn, ckpt, injector=None, poison=()):
    cfg = get_config(arch, smoke=True)
    step_fn = build_train_step(cfg, TrainConfig(optimizer=tadamw.AdamWConfig(**OPT)), "cpu")

    def make_state():
        model = port_model(arch, params)
        return {"params": model, "opt": tadamw.init_opt_state(model)}

    def step(state, batch):
        p, o, m = step_fn(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    rc = RuntimeConfig(ckpt_dir=str(ckpt), ckpt_every=4, max_rollbacks=2)
    return run_training(steps=LOOP_STEPS, make_state=make_state, step_fn=_poisoning(step),
                        batch_fn=lambda s: batch_fn(s, poison), rc=rc, injector=injector)


@pytest.fixture(scope="module")
def jax_loops(mesh, tmp_path_factory):
    """The JAX package's run_training on olmoe SMOKE: a restart (failure
    injected at step 6) and a rollback (batch 5 poisoned)."""
    arch = "olmoe-1b-7b"
    cfg_j, params, _, batch_fn = _loop_pieces(arch)
    step_fn, _, _ = j_build_train_step(cfg_j, mesh, JTrainConfig(
        optimizer=jadamw.AdamWConfig(**OPT)))

    def make_state():
        p = jax.tree.map(jax.numpy.asarray, params)
        return {"params": p, "opt": jadamw.init_opt_state(p)}

    def step(state, batch):
        with set_mesh(mesh):
            p, o, m = step_fn(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    out = {}
    for case, injector, poison in (("restart", JFailureInjector(fail_steps=(6,)), ()),
                                   ("rollback", None, (5,))):
        rc = JRuntimeConfig(ckpt_dir=str(tmp_path_factory.mktemp(case)), ckpt_every=4,
                            max_rollbacks=2)
        out[case] = j_run_training(steps=LOOP_STEPS, make_state=make_state,
                                   step_fn=_poisoning(step),
                                   batch_fn=lambda s, p=poison: batch_fn(s, p), rc=rc,
                                   injector=injector)
    return out


@pytest.mark.parametrize("case", ["restart", "rollback"])
def test_run_training_matches_jax_and_itself(case, jax_loops, tmp_path):
    """A restart after an injected failure, and a rollback over a batch
    whose loss is NaN (replaced by batch step + steps), against the JAX
    package's loop; then against the port's uninterrupted loop, whose
    losses it repeats bit for bit up to the event, and on its own
    trajectory after it."""
    arch = "olmoe-1b-7b"
    _, params, _, batch_fn = _loop_pieces(arch)
    injector = FailureInjector(fail_steps=(6,)) if case == "restart" else None
    poison = (5,) if case == "rollback" else ()
    res = _port_loop(arch, params, batch_fn, tmp_path / "run", injector, poison)
    want = jax_loops[case]
    assert (res.final_step, res.restarts, res.rollbacks) == \
        (want.final_step, want.restarts, want.rollbacks) == \
        (LOOP_STEPS, int(case == "restart"), int(case == "rollback"))
    assert len(res.losses) == len(want.losses) == LOOP_STEPS
    np.testing.assert_allclose(res.losses, want.losses, rtol=LOSS_RTOL)
    plain = _port_loop(arch, params, batch_fn, tmp_path / "plain")
    if case == "restart":  # restored at step 4: the same trajectory throughout
        assert res.losses == plain.losses
    else:  # steps 0-4 as before; from 5 on the replacement batch 17 changes the run
        assert res.losses[:5] == plain.losses[:5] and res.losses[5] != plain.losses[5]


class FakeClock:
    """The driver module's ``time`` under a clock the test moves:
    ``perf_counter`` reads it, ``sleep`` (the injector's straggle) advances
    it, and ``tick`` advances it by one step's time. A step's measured time
    is then set by construction, whatever the machine's load."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        return self.now

    def sleep(self, s: float) -> None:
        self.now += s

    def tick(self, s: float) -> None:
        self.now += s


STEP_S = 0.125  # every step's time on the fake clock (a power of two: exact sums)
STRAGGLE_S = 0.5  # step 6's extra time: 5x a step, against a factor of 2.5


def _straggler_run(tmp_path, monkeypatch, straggle_steps):
    _, params, _, batch_fn = _loop_pieces("olmoe-1b-7b")
    cfg = get_config("olmoe-1b-7b", smoke=True)
    step_fn = build_train_step(cfg, TrainConfig(), "cpu")
    clock = FakeClock()
    monkeypatch.setattr(driver, "time", clock)

    def make_state():
        model = port_model("olmoe-1b-7b", params)
        return {"params": model, "opt": tadamw.init_opt_state(model)}

    def step(state, batch):
        p, o, m = step_fn(state["params"], state["opt"], batch)
        clock.tick(STEP_S)
        return {"params": p, "opt": o}, m

    rc = RuntimeConfig(ckpt_dir=str(tmp_path), ckpt_every=100, straggler_factor=2.5)
    return run_training(steps=8, make_state=make_state, step_fn=_poisoning(step),
                        batch_fn=batch_fn, rc=rc,
                        injector=FailureInjector(straggle_steps=straggle_steps,
                                                 straggle_s=STRAGGLE_S))


def test_run_training_flags_a_straggler(tmp_path, monkeypatch):
    """Step 6 takes STEP_S + STRAGGLE_S on the fake clock, 5x the EWMA of
    the steps before it: flagged once, and the steps after it are not."""
    res = _straggler_run(tmp_path, monkeypatch, (6,))
    assert res.straggler_events == 1
    assert res.final_step == 8 and res.restarts == res.rollbacks == 0


def test_run_training_flags_no_step_at_a_steady_pace(tmp_path, monkeypatch):
    res = _straggler_run(tmp_path, monkeypatch, ())
    assert res.straggler_events == 0
    assert res.final_step == 8 and res.restarts == res.rollbacks == 0


BF16_LOSS_RTOL = 5e-3  # bf16 compute, XLA against PyTorch: seen 1.3e-3 over 12 steps


def test_run_training_resumes_a_bf16_master_in_opt_state(mesh, tmp_path):
    """A model holding its ndim > 1 weights in bf16 (the serving dtype),
    trained with the f32 master in AdamW's state (``master_in_opt``): the
    store writes the bf16 leaves as f32 and casts them back on restore, so
    the loop restarts after an injected failure with the dtypes it had and
    repeats the uninterrupted loop's losses bit for bit. Both are held
    against the JAX package's loop from the same numbers (uninterrupted:
    the reference's own store cannot restore a bf16 leaf), within
    BF16_LOSS_RTOL a step."""
    arch = "olmoe-1b-7b"
    cfg_j = dataclasses.replace(j_get_config(arch, smoke=True), dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    _, params, _, batch_fn = _loop_pieces(arch)
    params = jax.tree.map(lambda p: p.astype(jnp.bfloat16) if p.ndim > 1 else p, params)
    opt_kw = dict(**OPT, master_in_opt=True)
    j_step, _, _ = j_build_train_step(cfg_j, mesh, JTrainConfig(
        optimizer=jadamw.AdamWConfig(**opt_kw)))

    def j_state():
        p = jax.tree.map(jnp.asarray, params)
        opt = jadamw.init_opt_state(p, master_in_opt=True)
        # the master of an f32 leaf is that leaf's buffer, which the step
        # would donate twice: give it its own
        opt["master"] = jax.tree.map(lambda x: jnp.array(x, copy=True), opt["master"])
        return {"params": p, "opt": opt}

    def j_step_fn(state, batch):
        with set_mesh(mesh):
            p, o, m = j_step(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    want = j_run_training(steps=LOOP_STEPS, make_state=j_state, step_fn=_poisoning(j_step_fn),
                          batch_fn=batch_fn, rc=JRuntimeConfig(ckpt_dir=str(tmp_path / "jax"),
                                                               ckpt_every=100))
    step_fn = build_train_step(cfg, TrainConfig(optimizer=tadamw.AdamWConfig(**opt_kw)), "cpu")

    def make_state():
        model = lm_params_from_reference(cfg, params, "cpu")
        return {"params": model, "opt": tadamw.init_opt_state(model, master_in_opt=True)}

    def step(state, batch):
        p, o, m = step_fn(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    runs, states = {}, {}

    def kept(state, batch):
        state, m = step(state, batch)
        states[label] = state
        return state, m

    for label, injector in (("plain", None), ("restart", FailureInjector(fail_steps=(6,)))):
        runs[label] = run_training(
            steps=LOOP_STEPS, make_state=make_state, step_fn=_poisoning(kept), batch_fn=batch_fn,
            rc=RuntimeConfig(ckpt_dir=str(tmp_path / label), ckpt_every=4), injector=injector)
    res, plain = runs["restart"], runs["plain"]
    assert (res.final_step, res.restarts, res.rollbacks) == (LOOP_STEPS, 1, 0)
    assert res.losses == plain.losses
    model = states["restart"]["params"]
    assert model.layers[0].attn.wq.dtype == torch.bfloat16
    assert model.layers[0].ln1.dtype == torch.float32
    assert states["restart"]["opt"]["master"]["layers.0.attn.wq"].dtype == torch.float32
    assert len(want.losses) == LOOP_STEPS
    np.testing.assert_allclose(res.losses, want.losses, rtol=BF16_LOSS_RTOL)


# ---------------------------------------------------------------------------
# hierarchical data parallelism
# ---------------------------------------------------------------------------
def _dp_batches(cfg_j, step):
    dcfg = JDataConfig(seq_len=16, global_batch=2, vocab=cfg_j.vocab)
    return [np_tree(j_synthetic_batch(dcfg, 2 * step + c)) for c in range(2)]


@pytest.mark.parametrize("density", [0.05, 1.0])
def test_cross_cluster_dp_matches_jax(density):
    """test_hierarchical.py's setup (starcoder2 SMOKE, 2 clusters, min_size
    256) for 4 steps: the same losses, wire bytes and gradient norms, the
    same parameters, and the two replicas bit-identical."""
    arch = "starcoder2-7b"
    cfg_j = j_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    opt_kw, comp_kw = dict(lr=2e-3, warmup_steps=5), dict(density=density, min_size=256)
    jdp = JCrossClusterDP(
        lambda p, b: jtfm.lm_loss(cfg_j, p, b["inputs"], b["targets"], None),
        jadamw.AdamWConfig(**opt_kw), jcompress.CompressConfig(**comp_kw), num_clusters=2)
    tdp = CrossClusterDP(
        lambda p, b: ttfm.lm_loss(cfg, p, torch.tensor(b["inputs"]), torch.tensor(b["targets"])),
        tadamw.AdamWConfig(**opt_kw), tcompress.CompressConfig(**comp_kw), num_clusters=2)
    params = jtfm.init_params(cfg_j, jax.random.PRNGKey(0))
    jstates = jdp.init(params)
    tstates = tdp.init(port_model(arch, np_tree(params)))
    for s in range(4):
        jstates, jm = jdp.step(jstates, _dp_batches(cfg_j, s))
        tstates, tm = tdp.step(tstates, _dp_batches(cfg_j, s))
        assert tm["wire_bytes"] == jm["wire_bytes"]
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=LOSS_RTOL)
    assert_params(tstates[0].params, jstates[0].params)
    for a, b in zip(tstates[0].params.parameters(), tstates[1].params.parameters()):
        assert torch.equal(a, b)
    resid = sum(float(e.abs().sum()) for e in tstates[0].err.values())
    assert (resid > 0) == (density < 1.0)  # error feedback holds what was not sent


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launcher_smoke_runs_and_resumes(tmp_path, capsys):
    argv = ["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu", "--steps", "4",
            "--seq", "16", "--batch", "4", "--ckpt", str(tmp_path), "--ckpt-every", "2"]
    assert launch_train.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "arch=olmoe-1b-7b-smoke device=cpu"
    assert out[-1].startswith("done: step=4 loss[last5]=") and \
        out[-1].endswith("rollbacks=0 restarts=0 stragglers=0")
    assert math.isfinite(float(out[-1].split("loss[last5]=")[1].split()[0]))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002", "step_00000004"]
    # a second launch with --steps 6 resumes from step 4
    assert launch_train.main(argv[:6] + ["6"] + argv[7:]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("done: step=6")
