"""The port's process grid (``core/grid.py``) on 2×2×1 and 1×1×4: four gloo
ranks on the CPU, each ``Grid`` method held against what numpy computes
from the same known per-rank inputs. No JAX here.

Exact throughout: gathers and exchanges move bits, maxima and integer sums
are exact, and a float sum over a grid axis runs in axis order, so it must
equal numpy's left-to-right f32 sum bit for bit, on every rank and run.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core.grid import COL_AX, LAYER_AX, ROW_AX, make_grid, square_grid_for
from repro_torch.launch import spawn

pytestmark = pytest.mark.slow

SHAPES = [(2, 2, 1), (1, 1, 4)]
AXES = (ROW_AX, COL_AX, LAYER_AX)
TIMEOUT_S = 120


def _inputs(rank):
    """Rank ``rank``'s known inputs: f32 and i32 vectors, and f32 and i32
    blocks of 4 rows × 8 columns."""
    rng = np.random.default_rng(100 + rank)
    return {
        "f": rng.standard_normal(8).astype(np.float32),
        "i": rng.integers(-50, 50, 8).astype(np.int32),
        "m": rng.standard_normal((4, 8)).astype(np.float32),
        "mi": rng.integers(-50, 50, (4, 8)).astype(np.int32),
    }


def _collectives(grid):
    """Every ``Grid`` method on this rank's inputs (a spawned rank)."""
    x = {k: torch.from_numpy(v) for k, v in _inputs(grid.rank).items()}
    out = {"coords": grid.coords, "groups": {}}
    for ax in AXES:
        n = grid.axis_size(ax)
        if n > 1:
            out["groups"][ax] = (dist.get_group_rank(grid.groups[ax], grid.rank),
                                 dist.get_process_group_ranks(grid.groups[ax]))
        out[ax] = {
            "all_gather": grid.all_gather(x["f"], ax).numpy(),
            "all_to_all": grid.all_to_all(x["f"].reshape(n, -1), ax).numpy(),
            "psum_f": grid.psum(x["f"], ax).numpy(),
            "psum_f_again": grid.psum(x["f"], ax).numpy(),
            "psum_i": grid.psum(x["i"], ax).numpy(),
            "psum_i_strided": grid.psum(x["mi"].T, ax).numpy(),  # NCCL wants it dense
            "pmax_f": grid.pmax(x["f"], ax).numpy(),
            "pmax_i": grid.pmax(x["i"], ax).numpy(),
            "psum_scatter": grid.psum_scatter(x["m"], ax, dim=1).numpy(),
        }
    out["gather_grid"] = grid.gather_grid(x["i"]).numpy()
    out["psum_all_f"] = grid.psum_all(x["f"]).numpy()
    out["psum_all_i"] = grid.psum_all(x["i"]).numpy()
    out["pmax_all_f"] = grid.pmax_all(x["f"]).numpy()
    try:
        make_grid(2, 2, 2, device="cpu")
    except RuntimeError as e:
        out["mismatch"] = str(e)
    return out


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(map(str, s)))
def ranks(request, tmp_path_factory):
    shape = request.param
    got = spawn.run(_collectives, shape, backend="gloo", device="cpu", timeout_s=TIMEOUT_S,
                    workdir=tmp_path_factory.mktemp("rdv"))
    return shape, got


def _coords(rank, shape):
    pr, pc, l = shape
    return (rank // (pc * l), rank // l % pc, rank % l)


def _members(rank, shape, ax):
    """Ranks on ``rank``'s line along ``ax``, in axis order (layout (i·pc + j)·l + k)."""
    pr, pc, l = shape
    i, j, k = _coords(rank, shape)
    if ax == ROW_AX:
        return [(s * pc + j) * l + k for s in range(pr)]
    if ax == COL_AX:
        return [(i * pc + s) * l + k for s in range(pc)]
    return [(i * pc + j) * l + s for s in range(l)]


def _sum_in_order(blocks):
    out = blocks[0]
    for b in blocks[1:]:
        out = out + b
    return out


def test_coords_rank_layout_and_group_order(ranks):
    shape, got = ranks
    pr, pc, l = shape
    assert [g["coords"] for g in got] == [_coords(r, shape) for r in range(len(got))]
    assert sorted(g["coords"] for g in got) == [
        (i, j, k) for i in range(pr) for j in range(pc) for k in range(l)]
    for r, g in enumerate(got):
        sizes = dict(zip(AXES, shape))
        assert set(g["groups"]) == {ax for ax in AXES if sizes[ax] > 1}
        for ax, (group_rank, members) in g["groups"].items():
            # the group rank is the axis index: a gather stacks in axis order
            assert members == _members(r, shape, ax)
            assert group_rank == _coords(r, shape)[AXES.index(ax)]


@pytest.mark.parametrize("ax", AXES)
def test_axis_collectives_match_numpy(ranks, ax):
    shape, got = ranks
    for r, g in enumerate(got):
        res, members = g[ax], _members(r, shape, ax)
        x = [_inputs(s) for s in members]
        n = len(members)
        f = np.stack([v["f"] for v in x])
        np.testing.assert_array_equal(res["all_gather"], f)
        me = members.index(r)
        np.testing.assert_array_equal(  # block s of the result came from member s
            res["all_to_all"], np.stack([v["f"].reshape(n, -1)[me] for v in x]))
        want = _sum_in_order(list(f))
        assert res["psum_f"].tobytes() == want.tobytes() == res["psum_f_again"].tobytes()
        np.testing.assert_array_equal(res["psum_i"], np.sum([v["i"] for v in x], 0))
        np.testing.assert_array_equal(res["psum_i_strided"], np.sum([v["mi"].T for v in x], 0))
        np.testing.assert_array_equal(res["pmax_f"], f.max(0))
        np.testing.assert_array_equal(res["pmax_i"], np.max([v["i"] for v in x], 0))
        w = 8 // n
        full = _sum_in_order([v["m"] for v in x])
        assert res["psum_scatter"].tobytes() == full[:, me * w:(me + 1) * w].tobytes()


def test_world_collectives_match_numpy(ranks):
    shape, got = ranks
    x = [_inputs(r) for r in range(len(got))]
    want_f = _sum_in_order([v["f"] for v in x])
    for g in got:
        np.testing.assert_array_equal(
            g["gather_grid"], np.stack([v["i"] for v in x]).reshape(*shape, 8))
        assert g["psum_all_f"].tobytes() == want_f.tobytes()
        np.testing.assert_array_equal(g["psum_all_i"], np.sum([v["i"] for v in x], 0))
        np.testing.assert_array_equal(g["pmax_all_f"], np.max([v["f"] for v in x], 0))


def test_make_grid_refuses_a_world_size_mismatch(ranks):
    _, got = ranks
    for g in got:
        assert "needs a process group of 8 ranks, found world size 4" in g["mismatch"]


def test_make_grid_refuses_rectangular_layers_and_a_missing_group():
    with pytest.raises(ValueError, match="square per-layer grids or l == 1, got 2x1x2"):
        make_grid(2, 1, 2, device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group of 4 ranks, and there is none"):
        make_grid(1, 1, 4, device="cpu")
    grid = make_grid(1, 1, 1, device="cpu")
    assert (grid.p, grid.coords, grid.groups) == (1, (0, 0, 0), {})


def test_square_grid_for():
    assert square_grid_for(8, 2) == (2, 2, 2)
    assert square_grid_for(4, 4) == (1, 1, 4)
    assert square_grid_for(16, 1) == (4, 4, 1)
    with pytest.raises(ValueError):
        square_grid_for(8, 1)
