"""The port's durability layer (``runtime/resilient.py``, the resilient MCL
and APSP loops) against its own uninterrupted runs and the JAX package's.

  * the generic ``run_iterated`` loop, the straggler EWMA, and a SIGTERM in
    this process and from outside a child process, as the JAX package's
    ``tests/test_resilient.py`` holds its own;
  * MCL kill-and-resume on a 1×1×1 grid (n = 64, 4 forced batches):
    preempted at an iteration start, mid-iteration, after a corrupt
    checkpoint and in an overflow storm — the trajectory ((nnz, chaos) per
    iteration) and the final matrix bit for bit against the port's
    uninterrupted run (values within rtol 1e-5 in the storm, whose retried
    batches plan other capacities); nnz and the partition against the JAX
    package's run, chaos within rtol 1e-4 (as in test_torch_mcl.py);
  * APSP at n = 40: ESC and hash against the JAX package's ``apsp_iterate``
    (triplets identical: min-plus has no rounding order) and against dense
    Floyd–Warshall (rtol 1e-5), and resumed bit for bit;
  * across packages: the JAX package's resilient loop writes step 2
    (``max_iters=2``) and the port resumes from its directory and finishes
    on the JAX package's uninterrupted trajectory (APSP exactly; MCL as
    test_torch_mcl.py's ``test_mcl_continues_from_a_jax_iterate``);
  * on a 2×2×1 grid of gloo ranks (slow): MCL preempted mid-iteration
    resumes bit for bit against the same grid's uninterrupted run, and a
    SIGTERM sent to rank 1 alone sends every rank back to the same step.

The JAX package's runs are made once for the module (``jax_runs``).
"""
import os
import pathlib
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from repro.core.grid import make_grid as j_make_grid
from repro.core.sparse import from_numpy_coo as j_coo
from repro.runtime import resilient as jres
from repro.sparse_apps import graph_algorithms as jga
from repro.sparse_apps import mcl as jmcl
from repro_torch.core import convert
from repro_torch.core.batched import RunReport
from repro_torch.core.grid import make_grid
from repro_torch.core.sparse import from_numpy_coo
from repro_torch.runtime.driver import StragglerEwma
from repro_torch.runtime.resilient import (
    PreemptionError,
    ResilientConfig,
    SpgemmFailureInjector,
    clear_preemption,
    install_preemption_handler,
    preemption_requested,
    restore_arrays_latest,
    run_iterated,
)
from repro_torch.sparse_apps import graph_algorithms as ga
from repro_torch.sparse_apps import mcl

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_MCL = 64
N_APSP = 40
MCL_CFG = dict(max_iters=5, per_process_memory=1 << 24, max_per_col=16, force_num_batches=4)
APSP_CFG = dict(per_process_memory=1 << 24)
SPAWN_TIMEOUT_S = 240  # a bound for a hung rank, not a run time (~20 s)


def _stochastic(n, density, seed):
    """Column-stochastic random symmetric pattern with a diagonal, as numpy
    (rows, cols, vals)."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, n)) < density).astype(np.float32)
    dense = dense + dense.T + np.eye(n, dtype=np.float32)
    dense = dense / dense.sum(axis=0, keepdims=True)
    r, c = np.nonzero(dense)
    return r.astype(np.int32), c.astype(np.int32), dense[r, c].astype(np.float32)


def _weighted_digraph(n, density, seed):
    """Weights uniform in [1, 10), no self-loops (the JAX package's test
    generator), as numpy (rows, cols, vals)."""
    rng = np.random.default_rng(seed)
    w = rng.random((n, n)).astype(np.float32) * 9 + 1
    mask = rng.random((n, n)) < density
    np.fill_diagonal(mask, False)
    r, c = np.nonzero(mask)
    return r.astype(np.int32), c.astype(np.int32), w[r, c]


MCL_INPUT = _stochastic(N_MCL, 0.1, seed=0)
APSP_INPUT = _weighted_digraph(N_APSP, 0.08, seed=1)


def _port(coo, n):
    return from_numpy_coo(*coo, (n, n), device="cpu")


def _jax(coo, n):
    return j_coo(*coo, (n, n))


def _traj(history):
    return [(h["nnz"], h["chaos"]) for h in history]


def _bits(m):
    """Live triplets of a port matrix, values as their bits."""
    r, c, v = convert.triplets(m)
    return r.tolist(), c.tolist(), v.view(np.int32).tolist()


def _jtriplets(m):
    k = int(m.nnz)
    return (np.asarray(m.rows)[:k].tolist(), np.asarray(m.cols)[:k].tolist(),
            np.asarray(m.vals)[:k].tolist())


def _partition(rows, cols, n):
    labels = mcl.clusters_from_matrix(rows, cols, n)
    return [tuple(labels == labels[i]) for i in range(n)]


@pytest.fixture(scope="module")
def grid():
    return make_grid(1, 1, 1, device="cpu")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's runs, once: uninterrupted MCL and APSP, and each
    loop's resilient run stopped after iteration 2 (its step-2 checkpoint
    is left in a directory for the port to resume)."""
    g = j_make_grid(1, 1, 1)
    a, d = _jax(MCL_INPUT, N_MCL), _jax(APSP_INPUT, N_APSP)
    fin, hist = jmcl.mcl_iterate(a, g, jmcl.MCLConfig(**MCL_CFG))
    dist, dhist = jga.apsp_iterate(d, g, jga.APSPConfig(**APSP_CFG))
    dirs = {}
    for name, run in (
        ("mcl", lambda rc: jmcl.mcl_iterate_resilient(
            a, g, jmcl.MCLConfig(**dict(MCL_CFG, max_iters=2)), rc)),
        ("apsp", lambda rc: jga.apsp_iterate_resilient(
            d, g, jga.APSPConfig(**APSP_CFG, max_iters=2), rc)),
    ):
        dirs[name] = str(tmp_path_factory.mktemp(f"jax_{name}"))
        run(jres.ResilientConfig(ckpt_dir=dirs[name], ckpt_every=1))
    nnz = int(fin.nnz)
    rows, cols = np.asarray(fin.rows)[:nnz], np.asarray(fin.cols)[:nnz]
    return {"mcl": (hist, _partition(rows, cols, N_MCL)),
            "apsp": (_jtriplets(dist), [h["nnz"] for h in dhist]), "dirs": dirs}


@pytest.fixture(scope="module")
def mcl_plain(grid):
    """The port's uninterrupted MCL run."""
    return mcl.mcl_iterate(_port(MCL_INPUT, N_MCL), grid, mcl.MCLConfig(**MCL_CFG))


# ---------------------------------------------------------------------------
# the generic loop
# ---------------------------------------------------------------------------
def _harness(tmp_path, injector=None, **rc_kw):
    """x_{k+1} = 2 x_k + k from x_0 = 1, one RunReport(retries=1) a step."""
    def step(state, it, inj):
        state = {"x": state["x"] * 2 + it}
        return state, RunReport(retries=1), bool(state["x"][0] > 1000)

    return run_iterated(
        rc=ResilientConfig(ckpt_dir=str(tmp_path), **rc_kw),
        max_iters=6,
        cold_start=lambda: {"x": np.ones(3, np.float64)},
        step_fn=step,
        encode=lambda s: (dict(s), {"v": 1}),
        decode=lambda arrays, meta: dict(arrays),
        injector=injector,
    )


def test_plain_run_and_report(tmp_path):
    res = _harness(tmp_path)
    assert res.it == 6
    assert res.report.retries == 6  # per-iteration reports merged
    assert res.report.checkpoint_bytes > 0 and res.report.restarts == 0
    np.testing.assert_array_equal(res.state["x"], np.full(3, 121.0))


@pytest.mark.parametrize("async_save", [True, False])
def test_preempt_resumes_from_checkpoint(tmp_path, async_save):
    ref = _harness(tmp_path / "ref")
    inj = SpgemmFailureInjector(preempt_iters=(4,))
    res = _harness(tmp_path / "run", injector=inj, async_save=async_save)
    assert res.report.restarts == 1
    np.testing.assert_array_equal(res.state["x"], ref.state["x"])


def test_restart_budget_bounded(tmp_path):
    class Always(SpgemmFailureInjector):
        def maybe_preempt(self, it, batch=None):
            if batch is None:
                raise PreemptionError("flaky node")

    with pytest.raises(PreemptionError):
        _harness(tmp_path, injector=Always(), max_restarts=2)


def test_resume_false_is_fresh_initial_start(tmp_path):
    _harness(tmp_path)  # leaves checkpoints behind
    assert _harness(tmp_path).report.retries == 0  # warm-started at it=6
    assert _harness(tmp_path, resume=False).report.retries == 6


def test_keystr_keys_normalized(tmp_path):
    _harness(tmp_path)
    arrays, meta, step, refused = restore_arrays_latest(str(tmp_path))
    assert list(arrays) == ["x"] and meta == {"v": 1} and (step, refused) == (6, 0)


def test_every_checkpoint_refused_is_a_counted_cold_start(tmp_path):
    inj = SpgemmFailureInjector(preempt_iters=(2,), corrupt_steps=(1, 2))
    res = _harness(tmp_path, injector=inj)
    assert res.report.restarts == 1 and res.report.refused_restores == 2
    np.testing.assert_array_equal(res.state["x"], np.full(3, 121.0))


# ---------------------------------------------------------------------------
# the straggler watchdog
# ---------------------------------------------------------------------------
def test_ewma_warmup_seeds_with_minimum():
    ew = StragglerEwma(factor=3.0, alpha=0.2, warmup=2)
    assert not ew.observe(5.0)
    assert not ew.observe(4.0)
    assert not ew.observe(0.1)  # arms with min = 0.1
    assert ew.ewma == pytest.approx(0.1)
    assert ew.observe(1.0)  # 1.0 > 3 * 0.1
    assert not ew.observe(0.1)


def test_ewma_no_event_during_warmup():
    ew = StragglerEwma(factor=3.0, alpha=0.2, warmup=5)
    assert not any(ew.observe(dt) for dt in [0.1, 100.0, 0.1, 50.0])


def test_loop_counts_straggler_events(tmp_path):
    inj = SpgemmFailureInjector(straggle_batches=((3, 0),), batch_straggle_s=0.25)

    def step(state, it, inj_):
        inj_.maybe_straggle_batch(it, 0)
        return state, None, False

    res = run_iterated(
        rc=ResilientConfig(ckpt_dir=str(tmp_path), ewma_warmup=1), max_iters=5,
        cold_start=lambda: {"x": np.zeros(1)}, step_fn=step,
        encode=lambda s: (dict(s), {}), decode=lambda arrays, meta: dict(arrays),
        injector=inj,
    )
    assert res.report.straggler_events >= 1


# ---------------------------------------------------------------------------
# SIGTERM → restore
# ---------------------------------------------------------------------------
def test_inprocess_sigterm_resumes_and_matches(tmp_path):
    previous = signal.getsignal(signal.SIGTERM)
    install_preemption_handler()
    clear_preemption()

    def run(path, kill_at):
        def step(state, it, inj):
            if it == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)  # handled, not fatal
            return {"x": state["x"] * 2 + it}, None, it >= 4

        return run_iterated(
            rc=ResilientConfig(ckpt_dir=str(path)), max_iters=6,
            cold_start=lambda: {"x": np.ones(2, np.float64)}, step_fn=step,
            encode=lambda s: (dict(s), {"v": 1}), decode=lambda arrays, meta: dict(arrays),
        )

    try:
        ref = run(tmp_path / "ref", kill_at=None)
        res = run(tmp_path / "run", kill_at=2)
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert ref.report.restarts == 0
    assert res.report.restarts == 1  # the signal became a clean restore
    assert not preemption_requested()  # translated and cleared
    np.testing.assert_array_equal(res.state["x"], ref.state["x"])


def test_subprocess_sigterm_drains_cleanly(tmp_path):
    ckpt = tmp_path / "ckpt"
    script = textwrap.dedent(f"""
        import time
        import numpy as np
        from repro_torch.runtime.resilient import (
            ResilientConfig, install_preemption_handler, run_iterated,
        )
        install_preemption_handler()

        def step(state, it, inj):
            time.sleep(0.3)
            return {{"x": state["x"] * 2 + it}}, None, it >= 5

        res = run_iterated(
            rc=ResilientConfig(ckpt_dir={str(ckpt)!r}, async_save=False),
            max_iters=6,
            cold_start=lambda: {{"x": np.ones(2, np.float64)}},
            step_fn=step,
            encode=lambda s: (dict(s), {{"v": 1}}),
            decode=lambda arrays, meta: dict(arrays),
        )
        print("RESTARTS", res.report.restarts, "X", float(res.state["x"][0]))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", script], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            if ckpt.exists() and any(ckpt.iterdir()):
                break
            assert proc.poll() is None, proc.communicate()
            time.sleep(0.05)
        else:
            pytest.fail("child never wrote a checkpoint")
        proc.send_signal(signal.SIGTERM)  # a real kill from outside
        out, err = proc.communicate(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, (out, err)
    line = [ln for ln in out.splitlines() if ln.startswith("RESTARTS")]
    assert line, (out, err)
    _, restarts, _, x = line[0].split()
    assert int(restarts) >= 1  # the SIGTERM took the restore path
    assert float(x) == 121.0  # on its own trajectory


# ---------------------------------------------------------------------------
# MCL kill-and-resume
# ---------------------------------------------------------------------------
MCL_FAULTS = {
    "iteration_start": dict(preempt_iters=(3,)),
    "mid_iteration": dict(preempt_iters=(2,), preempt_batch=2),
    "corrupt_newest": dict(preempt_iters=(3,), corrupt_steps=(3,)),
}


@pytest.mark.parametrize("fault", list(MCL_FAULTS))
def test_mcl_resume_bitwise(grid, mcl_plain, jax_runs, tmp_path, fault):
    final0, hist0 = mcl_plain
    rc = ResilientConfig(ckpt_dir=str(tmp_path), ckpt_every=1,
                         async_save=fault != "mid_iteration")
    final, hist, rep = mcl.mcl_iterate_resilient(
        _port(MCL_INPUT, N_MCL), grid, mcl.MCLConfig(**MCL_CFG), rc,
        injector=SpgemmFailureInjector(**MCL_FAULTS[fault]))
    assert rep.restarts == 1
    assert rep.refused_restores == (1 if fault == "corrupt_newest" else 0)
    assert rep.checkpoint_bytes > 0
    assert _traj(hist) == _traj(hist0)
    assert _bits(final) == _bits(final0)
    jhist, jpart = jax_runs["mcl"]
    assert [h["nnz"] for h in hist] == [h["nnz"] for h in jhist]
    np.testing.assert_allclose([h["chaos"] for h in hist], [h["chaos"] for h in jhist],
                               rtol=1e-4, atol=1e-5)
    r, c, _ = convert.triplets(final)
    assert _partition(r, c, N_MCL) == jpart


def test_mcl_overflow_storm(grid, mcl_plain, tmp_path):
    """Forced capacity under-prediction at iteration 0 (before the floors
    are pinned) drives the retry ladder; the result keeps the calm run's
    structure, values within rtol 1e-5."""
    final0, hist0 = mcl_plain
    inj = SpgemmFailureInjector(overflow_iters=(0,), overflow_slack=0.05)
    final, hist, rep = mcl.mcl_iterate_resilient(
        _port(MCL_INPUT, N_MCL), grid, mcl.MCLConfig(**MCL_CFG),
        ResilientConfig(ckpt_dir=str(tmp_path), ckpt_every=2), injector=inj)
    assert rep.retries + rep.sel_retries + rep.replans > 0
    assert [h["nnz"] for h in hist] == [h["nnz"] for h in hist0]
    r0, c0, v0 = convert.triplets(final0)
    r1, c1, v1 = convert.triplets(final)
    np.testing.assert_array_equal(r1, r0)
    np.testing.assert_array_equal(c1, c0)
    np.testing.assert_allclose(v1, v0, rtol=1e-5, atol=1e-7)


def test_mcl_checkpoint_layout_and_meta(grid, tmp_path):
    """The checkpoint holds the JAX package's leaves — (pr, pc, l, cap)
    tiles, (pr, pc, l) nnz — and a JSON meta of plain values."""
    cfg = mcl.MCLConfig(**dict(MCL_CFG, max_iters=2))
    mcl.mcl_iterate_resilient(_port(MCL_INPUT, N_MCL), grid, cfg,
                              ResilientConfig(ckpt_dir=str(tmp_path)))
    arrays, meta, step, refused = restore_arrays_latest(str(tmp_path))
    assert (step, refused) == (2, 0)
    assert sorted(arrays) == sorted(f"{p}_{f}" for p in "AB"
                                    for f in ("rows", "cols", "vals", "nnz"))
    assert arrays["A_rows"].shape[:3] == (1, 1, 1) and arrays["A_nnz"].shape == (1, 1, 1)
    assert arrays["A_vals"].dtype == np.float32 and arrays["B_cols"].dtype == np.int32
    assert set(meta) == {"workload", "it", "chaos", "history", "report", "plan_sig"}
    assert meta["workload"] == "mcl" and meta["it"] == 2 and len(meta["history"]) == 2
    assert isinstance(meta["plan_sig"]["binned"], bool)
    assert meta["plan_sig"]["local_path"] in ("esc", "binned", "hash")


def test_mcl_resumes_a_jax_checkpoint(grid, jax_runs):
    """The JAX package wrote step 2; the port finishes the run from it, on
    the JAX package's uninterrupted trajectory."""
    final, hist, rep = mcl.mcl_iterate_resilient(
        _port(MCL_INPUT, N_MCL), grid, mcl.MCLConfig(**MCL_CFG),
        ResilientConfig(ckpt_dir=jax_runs["dirs"]["mcl"]))
    jhist, jpart = jax_runs["mcl"]
    assert rep.restarts == 0 and rep.refused_restores == 0
    assert [h["nnz"] for h in hist] == [h["nnz"] for h in jhist]
    assert [h["iter"] for h in hist] == list(range(len(jhist)))  # JAX's rows carried in the meta
    np.testing.assert_allclose([h["chaos"] for h in hist], [h["chaos"] for h in jhist],
                               rtol=1e-4, atol=1e-5)
    r, c, _ = convert.triplets(final)
    assert _partition(r, c, N_MCL) == jpart


# ---------------------------------------------------------------------------
# APSP
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("local_path", ["esc", "hash"])
def test_apsp_matches_jax_and_floyd_warshall(grid, jax_runs, local_path):
    a = _port(APSP_INPUT, N_APSP)
    dist, hist = ga.apsp_iterate(a, grid, ga.APSPConfig(**APSP_CFG, local_path=local_path))
    want, want_nnz = jax_runs["apsp"]
    r, c, v = convert.triplets(dist)
    assert (r.tolist(), c.tolist(), v.tolist()) == want
    assert [h["nnz"] for h in hist] == want_nnz
    assert {h["local_path"] for h in hist} == {local_path}
    ref = ga.apsp_reference(a)
    got = np.full((N_APSP, N_APSP), np.inf)
    got[r, c] = v
    assert (np.isfinite(got) == np.isfinite(ref)).all()
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5)
    assert len(hist) <= int(np.ceil(np.log2(N_APSP - 1))) + 1


def test_hash_plan_keeps_a_batch_under_2_31_products():
    """A dense min-plus square at n = 2^11 forms 2^33 partial products; the
    hash multiply enumerates a batch's through an i32 prefix, so its plan
    batches until each process forms fewer than 2^31 in a batch (the JAX
    package's plan takes one batch and its prefix wraps)."""
    from repro_torch.core.batched import PlanInputs, plan_from_symbolic
    from repro_torch.core.specs import PlanFloors, PlanSpec
    from repro_torch.core.symbolic import SymbolicCounts

    n = 1 << 11
    col = np.full((1, 1, 1, n), n, np.int64)
    counts = SymbolicCounts(percol=col * n, b_colcounts=col, a_kcounts=col[0],
                            b_kcounts=col[0])
    inputs = PlanInputs(tm_a=n, max_nnz_a=n * n, max_nnz_b=n * n, nnz_a=n * n,
                        nnz_b=n * n, cap_a=n * n, cap_b=n * n, p=1)
    plan = plan_from_symbolic(counts, inputs, 2 << 30, PlanSpec(local_path="hash"),
                              PlanFloors())
    assert plan.local_path == "hash" and plan.num_batches == 8
    assert int(plan.per_batch_flops.max()) == n ** 3 // 8 < 2 ** 31
    forced = plan_from_symbolic(counts, inputs, 2 << 30,
                                PlanSpec(local_path="hash", force_num_batches=2), PlanFloors())
    assert forced.num_batches == 2  # a forced count is the caller's


def test_apsp_resume_bitwise(grid, tmp_path):
    a = _port(APSP_INPUT, N_APSP)
    cfg = ga.APSPConfig(**APSP_CFG, local_path="hash")
    dist0, hist0 = ga.apsp_iterate(a, grid, cfg)
    dist, hist, rep = ga.apsp_iterate_resilient(
        a, grid, cfg, ResilientConfig(ckpt_dir=str(tmp_path)),
        injector=SpgemmFailureInjector(preempt_iters=(2,), corrupt_steps=(2,)))
    assert (rep.restarts, rep.refused_restores) == (1, 1)
    assert [h["nnz"] for h in hist] == [h["nnz"] for h in hist0]
    assert _bits(dist) == _bits(dist0)


def test_apsp_resumes_a_jax_checkpoint(grid, jax_runs):
    dist, hist, rep = ga.apsp_iterate_resilient(
        _port(APSP_INPUT, N_APSP), grid, ga.APSPConfig(**APSP_CFG),
        ResilientConfig(ckpt_dir=jax_runs["dirs"]["apsp"]))
    want, want_nnz = jax_runs["apsp"]
    r, c, v = convert.triplets(dist)
    assert (r.tolist(), c.tolist(), v.tolist()) == want
    assert [h["nnz"] for h in hist] == want_nnz
    assert rep.restarts == 0 and rep.refused_restores == 0


# ---------------------------------------------------------------------------
# a 2x2x1 grid of gloo ranks
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_grid_mcl_resumes_on_every_rank(tmp_path):
    from repro_torch.launch import spawn

    import torch_resilient_ranks

    ranks = spawn.run(
        torch_resilient_ranks.mcl_rank, (2, 2, 1), backend="gloo", device="cpu",
        args=(MCL_INPUT, N_MCL, MCL_CFG, str(tmp_path / "ckpt"), (2, 2), 1, (2, 0)),
        timeout_s=SPAWN_TIMEOUT_S, workdir=tmp_path)
    plain = ranks[0]["plain"]
    for rank, out in enumerate(ranks):
        assert out["plain"] == plain, rank  # every rank gathers the same matrix
        # preempted at batch 2 of iteration 2: back to step 2 everywhere
        # (after the SIGTERM to rank 1 in iteration 2: to step 3)
        for label, step in (("preempted", 2), ("sigterm", 3)):
            got = out[label]
            assert (got["restarts"], got["refused"]) == (1, 0), (rank, label)
            assert got["restored_from"] == [step], (rank, label)
            assert got["traj"] == plain["traj"], (rank, label)
            assert got["triplets"] == plain["triplets"], (rank, label)
    shapes = ranks[0]["leaf_shapes"]
    assert shapes["['A_nnz']"] == (2, 2, 1)
    assert shapes["['A_rows']"][:3] == shapes["['B_vals']"][:3] == (2, 2, 1)
