"""The port's cost model and autotuner (``repro_torch.tune``) against the JAX
package's ``repro.tune``, from the same numpy triplets. Host math only.

  * ``comm_volume``, ``padded_comm_volume``, ``predict_cost`` (every path,
    lookahead and schedule) and ``fit_overhead`` equal the reference's, the
    floats to rel 1e-12, on plans both packages make from the same counts.
  * ``candidate_grids`` equals the reference's for 1, 4 and 8 devices.
  * ``autotune`` picks the reference's configuration (``to_meta()``, the
    predicted cost, the spec, floors and exec spec) on a uniform and a
    skewed R-MAT input at several budgets, masked too; an infeasible budget
    raises ``MemoryError`` in both; with no card and no ``num_devices``
    the port raises.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import gen as jgen
from repro.core.batched import PlanInputs as JInputs
from repro.core.batched import plan_from_symbolic as j_from_symbolic
from repro.core.specs import PlanFloors as JFloors
from repro.core.specs import PlanSpec as JPlan
from repro.core.symbolic import host_symbolic_counts as j_host_counts
from repro import tune as jtune
from repro.tune.autotune import _default_grid as j_default_grid
from repro_torch import tune as ttune
from repro_torch.core import convert
from repro_torch.core.batched import PlanInputs as TInputs
from repro_torch.core.batched import plan_from_symbolic as t_from_symbolic
from repro_torch.core.specs import ExecSpec as TExec
from repro_torch.core.specs import PlanFloors as TFloors
from repro_torch.core.specs import PlanSpec as TPlan
from repro_torch.core.symbolic import host_symbolic_counts as t_host_counts
from repro_torch.tune.autotune import _default_grid as t_default_grid

REL = 1e-12


def _port(a):
    return convert.from_reference(a, device="cpu")


def _pair(kind):
    if kind == "rmat":  # skewed: the reference's own tuner-bench pair
        return (jgen.rmat(scale=8, edge_factor=8, seed=3), jgen.rmat(scale=8, edge_factor=8, seed=4))
    return (jgen.erdos_renyi(256, 6.0, seed=30), jgen.erdos_renyi(256, 6.0, seed=31))


def _close(x, y):
    if isinstance(x, float) or isinstance(y, float):
        assert x == pytest.approx(y, rel=REL, abs=0.0), (x, y)
    else:
        assert x == y, (x, y)


def _plans(kind, grid, path, nb=None, ppm=1 << 30):
    a, b = _pair(kind)
    ta, tb = _port(a), _port(b)
    tp = t_from_symbolic(t_host_counts(ta, tb, grid), TInputs.from_host(ta, tb, grid), ppm,
                         TPlan(local_path=path, force_num_batches=nb), TFloors())
    jinputs = JInputs.from_host(a, b, grid)
    jp = j_from_symbolic(j_host_counts(a, b, grid), jinputs, ppm,
                         JPlan(local_path=path, force_num_batches=nb), JFloors())
    return tp, jp, jinputs


@pytest.mark.parametrize("grid", [(1, 1, 1), (2, 2, 2), (4, 2, 1), (1, 1, 4)],
                         ids=lambda g: "x".join(map(str, g)))
@pytest.mark.parametrize("path", ["esc", "binned", "hash"])
def test_cost_terms_match_jax(grid, path):
    tp, jp, inputs = _plans("rmat", grid, path, nb=8)
    tv = ttune.comm_volume(grid, tp.num_batches, inputs.nnz_a, inputs.nnz_b, tp.total_flops)
    jv = jtune.comm_volume(grid, jp.num_batches, inputs.nnz_a, inputs.nnz_b, jp.total_flops)
    assert dataclasses.astuple(tv) == dataclasses.astuple(jv)
    assert tv.per_process_bytes == jv.per_process_bytes
    tpad, jpad = ttune.padded_comm_volume(tp, grid), jtune.padded_comm_volume(jp, grid)
    assert (tpad.all_to_all_bytes, tpad.gather_bytes, tpad.total_bytes) == (
        jpad.all_to_all_bytes, jpad.gather_bytes, jpad.total_bytes)
    assert ttune.cost_model.compute_units(tp, path) == jtune.cost_model.compute_units(jp, path)
    for kw in (dict(), dict(pipelined=False), dict(lookahead=4), dict(path="auto"),
               dict(r_bytes=24), dict(coeffs=ttune.CostCoefficients(overhead=2.5))):
        jkw = dict(kw)
        if "coeffs" in kw:
            jkw["coeffs"] = jtune.CostCoefficients(overhead=2.5)
        tc = ttune.predict_cost(tp, grid, inputs.nnz_a, inputs.nnz_b, **kw)
        jc = jtune.predict_cost(jp, grid, inputs.nnz_a, inputs.nnz_b, **jkw)
        for f, x in dataclasses.asdict(tc).items():
            _close(x, getattr(jc, f))
        assert tc.to_meta() == jc.to_meta()


def test_coefficients_and_fit_overhead_match_jax():
    assert dataclasses.astuple(ttune.CostCoefficients()) == dataclasses.astuple(
        jtune.CostCoefficients())
    assert ttune.ACCEPT_BAND == jtune.ACCEPT_BAND
    rng = np.random.default_rng(0)
    for pairs in ([(1.0, 2.0)], [(0.5, 0.0), (3.0, 1.5)], list(rng.random((9, 2)) * 100), []):
        pairs = [(float(r), float(m)) for r, m in pairs]
        t, j = ttune.fit_overhead(pairs), jtune.fit_overhead(pairs)
        for x, y in zip(dataclasses.astuple(t), dataclasses.astuple(j)):
            _close(x, y)
    base = ttune.CostCoefficients(dispatch_ms=1.0)
    assert ttune.fit_overhead([(2.0, 4.0)], base).dispatch_ms == 1.0


@pytest.mark.parametrize("devices", [1, 4, 8])
def test_candidate_grids_match_jax(devices):
    for shapes in (((256, 256), (256, 256)), ((6, 6), (6, 6)), ((96, 64), (64, 48)),
                   ((1 << 14, 1 << 14), (1 << 14, 1 << 14))):
        for mask in (False, True):
            got = ttune.candidate_grids(*shapes, devices, mask=mask)
            assert got == jtune.candidate_grids(*shapes, devices, mask=mask)
            assert t_default_grid(got) == j_default_grid(got)


def _assert_same_tuned(t, j):
    assert t.to_meta() == j.to_meta()
    for f, x in dataclasses.asdict(t.predicted).items():
        _close(x, getattr(j.predicted, f))
    assert t.grid_shape == j.grid_shape and t.placement == j.placement
    assert (t.spec.local_path, t.spec.r_bytes, t.spec.force_num_batches,
            t.spec.kbin_candidates) == (j.spec.local_path, j.spec.r_bytes,
                                        j.spec.force_num_batches, j.spec.kbin_candidates)
    assert t.floors.to_meta() == j.floors.to_meta()
    assert dataclasses.astuple(t.exec_spec) == dataclasses.astuple(j.exec_spec)


@pytest.mark.parametrize("kind,budget,devices", [
    ("rmat", 80_000, 8), ("rmat", 200_000, 8), ("rmat", 1 << 30, 4),
    ("er", 60_000, 8), ("er", 1 << 24, 1),
])
def test_autotune_picks_the_reference_config(kind, budget, devices):
    a, b = _pair(kind)
    j = jtune.autotune(a, b, budget, num_devices=devices)
    t = ttune.autotune(_port(a), _port(b), budget, num_devices=devices)
    _assert_same_tuned(t, j)
    assert t.predicted.total_ms <= t.baseline_predicted.total_ms
    assert isinstance(t.spec, TPlan) and isinstance(t.floors, TFloors)
    assert isinstance(t.exec_spec, TExec)


def test_masked_autotune_picks_the_reference_config():
    a, b = _pair("rmat")
    mask = jgen.erdos_renyi(256, 4.0, seed=7)
    j = jtune.autotune(a, b, 100_000, num_devices=8, mask=mask)
    t = ttune.autotune(_port(a), _port(b), 100_000, num_devices=8, mask=_port(mask))
    _assert_same_tuned(t, j)


def test_infeasible_budget_raises_in_both():
    a, b = _pair("rmat")
    with pytest.raises(MemoryError):
        jtune.autotune(a, b, 64, num_devices=8)
    with pytest.raises(MemoryError):
        ttune.autotune(_port(a), _port(b), 64, num_devices=8)


def test_device_count_default_is_the_card_count(monkeypatch):
    a, b = _pair("er")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="pass num_devices"):
        ttune.autotune(_port(a), _port(b), 1 << 24)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    _assert_same_tuned(ttune.autotune(_port(a), _port(b), 1 << 24),
                       jtune.autotune(a, b, 1 << 24, num_devices=4))
