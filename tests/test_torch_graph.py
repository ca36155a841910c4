"""The port's §V-B applications (``sparse_apps.graph_algorithms``) against
the JAX package's, on a 1×1×1 grid, from the same numpy inputs: the masked
triangle count (against the dense reference and the host-filter oracle, the
masked plan against the unmasked one under one budget, no host-side
filtering and one scalar a batch of traffic on the device path), and the
overlap pairs with and without a candidate mask.

Counts and pair lists must be equal; plans equal field by field.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import gen as jgen
from repro.core import sparse as jsparse
from repro.core.batched import plan_batches as j_plan
from repro.core.batched import probe_memory_budget as j_probe
from repro.core.distsparse import scatter_to_grid as j_scatter
from repro.core.grid import make_grid as j_make_grid
from repro.core.specs import PlanSpec as JPlan
from repro.sparse_apps import graph_algorithms as jga
from repro_torch.core import convert, gen
from repro_torch.core.batched import plan_batches as t_plan
from repro_torch.core.batched import probe_memory_budget as t_probe
from repro_torch.core.distsparse import scatter_to_grid as t_scatter
from repro_torch.core.grid import make_grid as t_make_grid
from repro_torch.core.sparse import from_numpy_coo
from repro_torch.core.specs import PlanSpec as TPlan
from repro_torch.sparse_apps import graph_algorithms as tga
from repro_torch.sparse_apps import mcl as tmcl


@pytest.fixture(scope="module")
def grids():
    return j_make_grid(1, 1, 1), t_make_grid(1, 1, 1, device="cpu")


def _port(x):
    return convert.from_reference(x, device="cpu")


def _plan_fields(p):
    return (p.num_batches, p.max_unmerged_nnz, p.sel_cap, p.mask_sel_cap, p.local_path,
            dataclasses.astuple(p.caps))


@pytest.mark.parametrize("kind", ["er", "rmat"])
def test_triangle_count_matches_jax_and_reference(grids, kind):
    if kind == "er":
        a = jgen.symmetrized(jgen.erdos_renyi(48, 6.0, seed=9))
    else:
        a = jgen.symmetrized(jgen.rmat(6, edge_factor=8, seed=5))
    ta = _port(a)
    np.testing.assert_array_equal(convert.to_numpy(gen.symmetrized(
        gen.erdos_renyi(48, 6.0, seed=9, device="cpu") if kind == "er"
        else gen.rmat(6, edge_factor=8, seed=5, device="cpu")))["rows"], np.asarray(a.rows))
    want = jga.triangle_count_reference(a)
    assert tga.triangle_count_reference(ta) == want
    assert tga.triangle_count(ta, grids[1]) == jga.triangle_count(a, grids[0]) == want


def test_masked_triangle_plan_and_traffic_match_jax(grids):
    """``case_triangle_masked_rmat`` on one process: under a budget that
    makes the unmasked plan batch, the masked plan has fewer batches and
    smaller D and C capacities, in both packages alike; the device path
    never filters on the host and moves one scalar a batch plus the mask's
    count vector; the host oracle moves every batch."""
    a = jgen.symmetrized(jgen.rmat(6, edge_factor=8, seed=5))
    ta = _port(a)
    want = jga.triangle_count_reference(a)
    plans = {}
    for pkg, ga, scatter, plan, probe, spec, g, x in (
        ("j", jga, j_scatter, j_plan, j_probe, JPlan, grids[0], a),
        ("t", tga, t_scatter, t_plan, t_probe, TPlan, grids[1], ta),
    ):
        L, U = ga._strict_parts(x)
        A, B, M = scatter(L, g, "A"), scatter(U, g, "B"), scatter(L, g, "C")
        ppm = probe(A, B, g)
        plans[pkg] = (ppm, plan(A, B, g, ppm, spec=spec(local_path="esc")),
                      plan(A, B, g, ppm, spec=spec(mask=M, local_path="esc")))
    (jppm, jpu, jpm), (tppm, tpu, tpm) = plans["j"], plans["t"]
    assert tppm == jppm
    assert _plan_fields(tpu) == _plan_fields(jpu) and _plan_fields(tpm) == _plan_fields(jpm)
    assert tpu.num_batches > 1 and tpm.num_batches < tpu.num_batches
    assert tpm.caps.d_cap < tpu.caps.d_cap and tpm.caps.c_cap < tpu.caps.c_cap

    calls = {"mask_filter": 0, "to_global": 0}
    real_filter, real_to_global = tga._host_mask_filter, tga._sparse_batch_to_global

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    tga._host_mask_filter = counting("mask_filter", real_filter)
    tga._sparse_batch_to_global = counting("to_global", real_to_global)
    try:
        tmcl.reset_transfer_bytes()
        got = tga.triangle_count(ta, grids[1], per_process_memory=tppm)
        device_bytes = tmcl.transfer_bytes()
        assert calls == {"mask_filter": 0, "to_global": 0}, calls
        tmcl.reset_transfer_bytes()
        got_host = tga.triangle_count_host(ta, grids[1], per_process_memory=tppm)
        host_bytes = tmcl.transfer_bytes()
        assert calls["mask_filter"] > 0 and calls["to_global"] > 0, calls
    finally:
        tga._host_mask_filter, tga._sparse_batch_to_global = real_filter, real_to_global
    assert got == got_host == want == jga.triangle_count(a, grids[0], per_process_memory=jppm)
    mask_pull = 1 * 1 * 1 * 64 * 4  # the (pr, pc, l, wl) i32 mask counts
    assert device_bytes <= mask_pull + 8 * tpm.num_batches, (device_bytes, mask_pull)
    assert host_bytes > 10 * device_bytes, (host_bytes, device_bytes)


def _candidates(pairs, nseqs, extra, seed):
    """A structural candidate mask: ``pairs`` plus ``extra`` random pairs."""
    rng = np.random.default_rng(seed)
    r = np.concatenate([[p[0] for p in pairs], rng.integers(0, nseqs, extra)]).astype(np.int64)
    c = np.concatenate([[p[1] for p in pairs], rng.integers(0, nseqs, extra)]).astype(np.int64)
    return r, c, np.ones(len(r), np.float32)


@pytest.mark.parametrize("seed", [17, 31])
def test_overlap_pairs_match_jax_with_and_without_candidates(grids, seed):
    """``case_overlap_pairs_exact`` and ``case_overlap_device_filter`` on one
    process: the device filter's pairs equal the dense reference, the host
    oracle and the JAX package's, with no host-side filtering; a candidate
    mask holding the true pairs and 40 random ones gives the same pairs, one
    holding half the true pairs gives that half; an impossible threshold
    shrinks every batch's pull to 8 slots."""
    a = jgen.kmer_like(32, 64, 5, seed=seed)
    ta = _port(a)
    want = jga.overlap_pairs_reference(a, min_shared=2)
    assert want and tga.overlap_pairs_reference(ta, min_shared=2) == want
    calls = {"pair_filter": 0}
    real_filter = tga._host_pair_filter

    def counting(*args, **kwargs):
        calls["pair_filter"] += 1
        return real_filter(*args, **kwargs)

    tga._host_pair_filter = counting
    try:
        got = tga.overlap_pairs(ta, grids[1], min_shared=2)
        assert calls["pair_filter"] == 0
        got_host = tga.overlap_pairs_host(ta, grids[1], min_shared=2)
        assert calls["pair_filter"] > 0
    finally:
        tga._host_pair_filter = real_filter
    assert got == got_host == want == jga.overlap_pairs(a, grids[0], min_shared=2)

    nseqs = a.shape[0]
    for pairs, extra in ((want, 40), (want[: len(want) // 2], 0)):
        r, c, v = _candidates(pairs, nseqs, extra, seed=3)
        jc = jsparse.from_numpy_coo(r, c, v, (nseqs, nseqs))
        tc = from_numpy_coo(r, c, v, (nseqs, nseqs), device="cpu")
        got_c = tga.overlap_pairs(ta, grids[1], min_shared=2, candidates=tc)
        assert got_c == pairs == jga.overlap_pairs(a, grids[0], min_shared=2, candidates=jc)

    seen = []
    real_to_global = tga._sparse_batch_to_global

    def spying(c, col_map, grid):
        seen.append(int(c.rows.shape[-1]))
        return real_to_global(c, col_map, grid)

    tga._sparse_batch_to_global = spying
    try:
        assert tga.overlap_pairs(ta, grids[1], min_shared=10 ** 6) == []
    finally:
        tga._sparse_batch_to_global = real_to_global
    assert seen and set(seen) == {8}, seen


def test_kmer_generator_matches_jax():
    j = jgen.kmer_like(64, 256, 12, seed=3)
    t = gen.kmer_like(64, 256, 12, seed=3, device="cpu")
    for f, x in convert.to_numpy(t).items():
        np.testing.assert_array_equal(x, np.asarray(getattr(j, f)), err_msg=f)
