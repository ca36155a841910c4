"""The port's serving engine (``repro_torch.serve``) and its launcher
against the JAX package's ``repro.serve``, on the CPU.

Every case of ``tests/test_serve_engine.py`` and
``tests/test_tune.py::TestServeFromTuned`` runs the JAX engine and the
port's engine over the same numpy-seeded request stream (the port's
operands are the reference's padded fields, ``convert.from_reference``)
and checks:

  * the ordered results: rid, status, ``plan_cached``, ``was_deferred``,
    splits, ``num_batches``, ``price_bytes``, retries, selection retries
    and refusal reasons;
  * ``stats`` and the plan cache: keys (``matrix_signature``) in order,
    and each entry's floors, local path, price, splits and hits;
  * C's triplets: structure exact, min_plus values exact, plus_times
    within rtol 1e-5 / atol 1e-6 (sums in another order);
  * the static dispatch signature of every request's first batch,
    ``(num_batches, caps, sel_cap, kbin caps, hash caps, mask_cap, A.cap,
    B.cap)``: a plan-cache hit's equals its miss's, and every request's
    equals the JAX engine's. It is the port's counterpart of the
    reference's zero-retrace check (the port has no tracer).

The reference's own oracle checks (dense products, FIFO order, deferral,
refusal) run on the port's results too. Beyond the mirrored cases: the
hash and k-binned local paths, a masked stream, and a starved slack that
takes the retry ladder and folds its growth back into the cache. The
launcher runs at its defaults on the CPU (its summary counts against the
JAX launcher's) and under a SIGTERM delivered mid-run.
"""
import dataclasses
import os
import signal
import sys

import numpy as np
import pytest

from repro.core import gen as jgen
from repro.core import semiring as jsr
from repro.core.grid import make_grid as j_make_grid
from repro.core.sparse import from_numpy_coo as j_from_numpy_coo
from repro import serve as jserve
from repro.tune import autotune as j_autotune
from repro_torch import serve as tserve
from repro_torch.core import convert
from repro_torch.core import semiring as tsr
from repro_torch.core.grid import make_grid as t_make_grid
from repro_torch.runtime import resilient
from repro_torch.tune import autotune as t_autotune

BIG = 1 << 24


@pytest.fixture(scope="module")
def grids():
    return j_make_grid(1, 1, 1), t_make_grid(1, 1, 1, device="cpu")


def _port(x):
    return convert.from_reference(x, device="cpu")


def _pair(n=64, deg=4.0, seed=0):
    return jgen.erdos_renyi(n, deg, seed=seed), jgen.erdos_renyi(n, deg, seed=seed + 1)


def _triplets(c):
    """Live (rows, cols, vals) of either package's SparseCOO, on the host."""
    nnz = int(c.nnz)
    return tuple(np.asarray(getattr(c, f))[:nnz] for f in ("rows", "cols", "vals"))


def _dense(c, fill=0.0):
    r, cc, v = _triplets(c)
    m = np.full(c.shape, fill, np.float64)
    m[r, cc] = v
    return m


def _caps(x):
    return None if x is None else dataclasses.astuple(x)


def _dispatch_sig(act):
    """The static dispatch signature of an in-flight request, in either
    package's ``_Active``."""
    return (act.nb, _caps(act.caps), act.sel_cap, _caps(act.kb), _caps(act.hc),
            act.mask_cap, act.A.cap, act.B.cap)


class Stream:
    """One request stream for both engines: ``phases`` is a list of lists
    of ``(rid, a, b, semiring name, mask)`` over JAX operands (``mask`` a
    (mask, mask_id) pair or None); each phase is submitted and then run to
    completion, so results accumulate across phases as in the reference's
    tests."""

    def __init__(self, cfg_kw, phases):
        self.cfg_kw, self.phases = cfg_kw, phases

    def run(self, pkg, grid, cfg=None):
        eng = pkg.SpgemmEngine(grid, cfg or pkg.ServeConfig(**self.cfg_kw))
        sigs = {}
        real = eng._dispatch

        def spy(act, bi):
            sigs.setdefault(act.req.rid, _dispatch_sig(act))
            return real(act, bi)

        eng._dispatch = spy
        port = pkg is tserve
        conv = _port if port else (lambda x: x)
        semirings = tsr if port else jsr
        for phase in self.phases:
            for rid, a, b, semiring, mask in phase:
                m, mid = mask if mask is not None else (None, None)
                eng.submit(pkg.MultiplyRequest(
                    rid=rid, a=conv(a), b=conv(b), semiring=semirings.get(semiring),
                    mask=None if m is None else conv(m), mask_id=mid))
            eng.run_to_completion()
        return eng, sigs


def _both(grids, stream, jcfg=None, tcfg=None):
    """Run ``stream`` through both engines; check that they agree (see the
    module docstring) and return the port's (engine, signatures)."""
    jeng, jsigs = stream.run(jserve, grids[0], jcfg)
    teng, tsigs = stream.run(tserve, grids[1], tcfg)
    assert teng.stats == jeng.stats
    assert list(teng.plan_cache) == list(jeng.plan_cache)
    for key, te in teng.plan_cache.items():
        je = jeng.plan_cache[key]
        assert te.floors.to_meta() == je.floors.to_meta(), key
        assert (te.local_path, te.price_bytes, te.splits, te.hits) == (
            je.local_path, je.price_bytes, je.splits, je.hits), key
    assert len(teng.done) == len(jeng.done)
    semiring = {rid: s for phase in stream.phases for rid, _, _, s, _ in phase}
    for t, j in zip(teng.done, jeng.done):
        fields = ("rid", "status", "plan_cached", "was_deferred", "splits", "num_batches",
                  "price_bytes", "reason")
        assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]
        assert (t.report.retries, t.report.sel_retries) == (j.report.retries,
                                                            j.report.sel_retries)
        if t.status != "ok":
            assert t.c is None and j.c is None
            continue
        (tr, tc, tv), (jr, jc, jv) = _triplets(t.c), _triplets(j.c)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tc, jc)
        if semiring[t.rid] == "plus_times":
            np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(tv, jv)
        assert t.latency_ms > 0
    assert tsigs == jsigs
    return teng, tsigs


def _req(rid, a, b, semiring="plus_times", mask=None):
    return (rid, a, b, semiring, mask)


# ---------------------------------------------------------------------------
# mirrored: tests/test_serve_engine.py
# ---------------------------------------------------------------------------
def test_matches_dense_plus_times(grids):
    a, b = _pair(seed=10)
    eng, _ = _both(grids, Stream({"per_process_memory": BIG}, [[_req(0, a, b)]]))
    (res,) = eng.done
    assert res.status == "ok"
    np.testing.assert_allclose(_dense(res.c), _dense(a) @ _dense(b), rtol=1e-5, atol=1e-6)


def test_matches_dense_min_plus(grids):
    a, b = _pair(seed=20)
    eng, _ = _both(grids, Stream({"per_process_memory": BIG},
                                 [[_req(0, a, b, "min_plus")]]))
    (res,) = eng.done
    da, db = _dense(a, np.inf), _dense(b, np.inf)
    want = np.min(da[:, :, None] + db[None, :, :], axis=1)
    got = _dense(res.c, np.inf)
    np.testing.assert_allclose(np.where(np.isfinite(want), want, 0),
                               np.where(np.isfinite(got), got, 0), rtol=1e-5)
    assert (np.isfinite(want) == np.isfinite(got)).all()


def test_repeat_request_same_dispatch_signature(grids):
    """The reference's zero-retrace case: the repeat hits the cache and
    dispatches at the miss's static signature."""
    a, b = _pair(seed=30)
    eng, sigs = _both(grids, Stream({"per_process_memory": BIG},
                                    [[_req(0, a, b)], [_req(1, a, b)]]))
    repeat = [r for r in eng.done if r.rid == 1][0]
    assert repeat.plan_cached and not eng.done[0].plan_cached
    assert sigs[1] == sigs[0]
    assert eng.stats["hits"] == 1 and eng.cache_hit_rate() == 0.5


def test_signature_stability(grids):
    jg, tg = grids
    a, b = _pair(seed=40)
    c, d = _pair(n=32, seed=41)
    keys = {}
    for pkg, grid, conv in ((jserve, jg, lambda x: x), (tserve, tg, _port)):
        cfg = pkg.ServeConfig()
        keys[pkg] = [pkg.matrix_signature(pkg.MultiplyRequest(rid=i, a=conv(x), b=conv(y)),
                                          grid, cfg)
                     for i, (x, y) in enumerate(((a, b), (a, b), (c, d)))]
    assert keys[tserve] == keys[jserve]
    k1, k2, k3 = keys[tserve]
    assert k1 == k2 and k1 != k3


def test_concurrent_same_signature_hits(grids):
    a, b = _pair(seed=50)
    eng, sigs = _both(grids, Stream({"per_process_memory": BIG},
                                    [[_req(0, a, b), _req(1, a, b)]]))
    assert [r.status for r in eng.done] == ["ok", "ok"]
    assert eng.stats["hits"] == 1 and eng.stats["misses"] == 1
    assert sigs[1] == sigs[0]


def test_refusal_at_budget(grids):
    a, b = _pair(seed=60)
    eng, sigs = _both(grids, Stream({"per_process_memory": 1024}, [[_req(0, a, b)]]))
    (res,) = eng.done
    assert res.status == "refused" and res.c is None and res.reason != ""
    assert eng.stats["refused"] == 1 and eng.stats["served"] == 0
    assert sigs == {}  # refused with no dispatch


def test_deferred_fifo_ordering(grids):
    a, b = _pair(seed=70)
    probe, _ = _both(grids, Stream({"per_process_memory": BIG}, [[_req(0, a, b)]]))
    budget = int(probe.done[0].price_bytes * 1.5)
    eng, _ = _both(grids, Stream({"per_process_memory": budget},
                                 [[_req(rid, a, b) for rid in range(3)]]))
    results = eng.done
    assert [r.rid for r in results] == [0, 1, 2]
    assert all(r.status == "ok" for r in results)
    assert eng.stats["deferred"] >= 1 and results[1].was_deferred


def test_budget_forces_batching(grids):
    a, b = _pair(n=96, deg=8.0, seed=80)
    roomy, _ = _both(grids, Stream({"per_process_memory": BIG}, [[_req(0, a, b)]]))
    r0 = roomy.done[0]
    tight, _ = _both(grids, Stream({"per_process_memory": int(r0.price_bytes * 0.7)},
                                   [[_req(0, a, b)]]))
    r1 = tight.done[0]
    assert r1.status == "ok"
    assert r1.num_batches > r0.num_batches or r1.splits > 0
    np.testing.assert_allclose(_dense(r1.c), _dense(r0.c), rtol=1e-5, atol=1e-6)


def test_run_report_and_result_fields(grids):
    a, b = _pair(seed=90)
    eng, _ = _both(grids, Stream({"per_process_memory": BIG}, [[_req(7, a, b)]]))
    (res,) = eng.done
    assert res.rid == 7 and res.status == "ok"
    assert res.price_bytes > 0 and res.num_batches >= 1 and res.latency_ms > 0
    assert res.report.retries == 0 and res.report.sel_retries == 0
    assert res.report.to_dict()["retries"] == 0
    assert eng.stats["served"] == 1
    assert eng.stats["hits"] + eng.stats["misses"] == 1


def _mixed_phase():
    rng = np.random.default_rng(0)
    a0, b0 = _pair(seed=100)
    phase = []
    for rid in range(6):
        if rid % 2 == 0:
            phase.append(_req(rid, a0, b0))
        else:
            n = int(rng.integers(32, 48)) * 2
            phase.append(_req(rid, *_pair(n=n, deg=4.0, seed=200 + rid)))
    return phase


def test_mixed_traffic_stats(grids):
    eng, sigs = _both(grids, Stream({"per_process_memory": BIG}, [_mixed_phase()]))
    assert len(eng.done) == 6 and eng.stats["served"] == 6
    assert eng.stats["hits"] >= 2
    assert 0.0 < eng.cache_hit_rate() < 1.0
    assert sigs[2] == sigs[4] == sigs[0]


# ---------------------------------------------------------------------------
# mirrored: tests/test_tune.py::TestServeFromTuned
# ---------------------------------------------------------------------------
def test_tuned_drives_admission_with_cache_hits(grids):
    a, b = jgen.erdos_renyi(64, 4.0, seed=30), jgen.erdos_renyi(64, 4.0, seed=31)
    jt = j_autotune(a, b, BIG, num_devices=1)
    tt = t_autotune(_port(a), _port(b), BIG, num_devices=1)
    assert tt.grid_shape == jt.grid_shape == (1, 1, 1)
    jcfg, tcfg = jserve.ServeConfig.from_tuned(jt), tserve.ServeConfig.from_tuned(tt)
    assert tcfg.local_path == tt.spec.local_path == jcfg.local_path
    assert tcfg.seed_floors == tt.floors
    assert tcfg.seed_floors.to_meta() == jcfg.seed_floors.to_meta()
    assert (tcfg.per_process_memory, tcfg.r_bytes, tcfg.slack, tcfg.lookahead,
            tcfg.max_retries) == (jcfg.per_process_memory, jcfg.r_bytes, jcfg.slack,
                                  jcfg.lookahead, jcfg.max_retries)
    eng, sigs = _both(grids, Stream(None, [[_req(0, a, b)], [_req(1, a, b)]]),
                      jcfg=jcfg, tcfg=tcfg)
    repeat = [r for r in eng.done if r.rid == 1][0]
    assert repeat.status == "ok" and repeat.plan_cached
    assert sigs[1] == sigs[0]


# ---------------------------------------------------------------------------
# beyond the reference's cases: local paths, masks, the retry ladder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("local_path", ["esc", "binned", "hash"])
def test_local_paths_match_jax(grids, local_path):
    a0, b0 = _pair(n=128, deg=6.0, seed=300)
    a1, b1 = _pair(n=128, deg=6.0, seed=310)
    eng, sigs = _both(grids, Stream(
        {"per_process_memory": BIG, "local_path": local_path},
        [[_req(0, a0, b0), _req(1, a1, b1), _req(2, a0, b0)], [_req(3, a0, b0)]]))
    assert all(r.status == "ok" for r in eng.done)
    assert sigs[0] == sigs[2] == sigs[3]
    assert {e.local_path for e in eng.plan_cache.values()} == {local_path}
    np.testing.assert_allclose(_dense(eng.done[0].c), _dense(a0) @ _dense(b0),
                               rtol=1e-5, atol=1e-6)


def test_masked_requests_match_jax(grids):
    """Masked requests (the triangle count's L·U ⊙ L) share a key by
    ``mask_id`` and dispatch at one signature."""
    g = jgen.symmetrized(jgen.rmat(7, edge_factor=8, seed=5))
    d = (_dense(g) != 0)
    np.fill_diagonal(d, False)
    lo, up = np.tril(d, -1), np.triu(d, 1)
    coo = lambda x: j_from_numpy_coo(*np.nonzero(x), np.ones(int(x.sum()), np.float32),
                                        x.shape)
    L, U = coo(lo), coo(up)
    mask = (L, "tri7")
    eng, sigs = _both(grids, Stream(
        {"per_process_memory": BIG, "local_path": "hash"},
        [[_req(0, L, U, mask=mask), _req(1, L, U, mask=mask)], [_req(2, L, U)]]))
    assert sigs[0] == sigs[1] and sigs[0][5] > 0  # mask_cap
    want = (lo.astype(np.int64) @ up.astype(np.int64)) * lo
    assert int(round(_dense(eng.done[0].c).sum())) == int(want.sum())
    assert eng.stats["hits"] == 1 and eng.stats["misses"] == 2


def test_retry_growth_folds_into_cache(grids):
    """A starved slack overflows the planned capacities: the retry ladder
    grows them, completion folds the growth into the cache entry, and the
    repeat dispatches at the grown capacities with fewer retries."""
    a, b = _pair(n=96, deg=8.0, seed=400)
    eng, sigs = _both(grids, Stream({"per_process_memory": BIG, "slack": 0.7},
                                    [[_req(0, a, b)], [_req(1, a, b)]]))
    first, repeat = eng.done
    assert first.report.retries > 0
    assert repeat.plan_cached and repeat.report.retries < first.report.retries
    assert sigs[1] != sigs[0]
    np.testing.assert_allclose(_dense(repeat.c), _dense(a) @ _dense(b), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _counts(line):
    """The parts of a summary line that do not depend on timing."""
    head, tail = line.split(" p50 ")
    return head, tail.split("plan-cache hit rate ")[1].split()[0]


def test_launcher_on_cpu_matches_jax_summary(capsys):
    from repro.launch import serve as jlaunch
    from repro_torch.launch import serve as tlaunch

    old = signal.getsignal(signal.SIGTERM)
    try:
        assert tlaunch.main(["--device", "cpu"]) == 0
        port_line = capsys.readouterr().out.strip().splitlines()[-1]
        argv, sys.argv = sys.argv, ["serve"]
        try:
            assert jlaunch.main() == 0
        finally:
            sys.argv = argv
        jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    finally:
        signal.signal(signal.SIGTERM, old)
    assert port_line.startswith("served 16/16 (refused 0, deferred 0)"), port_line
    assert _counts(port_line) == _counts(jax_line), (port_line, jax_line)
    assert port_line.endswith("on 1x1x1 cpu)"), port_line


def test_launcher_drains_on_sigterm(capsys, monkeypatch):
    """A real SIGTERM delivered during the first tick: the launcher stops
    at the next tick boundary, prints the preemption line and exits 0."""
    from repro_torch.launch import serve as tlaunch

    real_step = tserve.SpgemmEngine.step
    ticks = []

    def step(self):
        ticks.append(1)
        if len(ticks) == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return real_step(self)

    monkeypatch.setattr(tserve.SpgemmEngine, "step", step)
    old = signal.getsignal(signal.SIGTERM)
    try:
        assert tlaunch.main(["--device", "cpu"]) == 0
    finally:
        signal.signal(signal.SIGTERM, old)
        resilient.clear_preemption()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("preempted: preemption signal received (SIGTERM)"), line
    served = int(line.split("served ")[1].split(" of ")[0])
    assert line.endswith(" of 16") and served < 16
    assert len(ticks) == 1  # no tick after the signal


@pytest.mark.slow
def test_launcher_on_a_cpu_grid(capsys):
    """``--pr 2``: four gloo ranks serve the same stream; rank 0's summary
    line is printed."""
    from repro_torch.launch import serve as tlaunch

    assert tlaunch.main(["--device", "cpu", "--pr", "2"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("served 16/16 (refused 0, deferred 0)"), line
    assert line.endswith("on 2x2x1 cpu)"), line
