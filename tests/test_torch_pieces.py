"""How many pieces a planned tile runs in (``repro_torch.core.pieces``).

* ``call_parts`` splits the reference estimate into operand bytes, stream
  elements and result entries that recombine to
  ``tiling.estimate_call_bytes`` exactly, over a grid of expressions.
* ``piece_count`` gives 1 without a budget or for a call that fits, and
  otherwise the least count whose streams fit beside the fixed bytes.
* A budgeted ``TiledExpr`` on the CPU runs each tile in its pieces (one
  lane dispatch a tile), equals numpy and the untiled engine, and the
  largest stream capacity its plan records is at most the budget over the
  port's bytes a row; without a budget, or where the schedule already has
  lanes, a tile runs whole.

Pure PyTorch and numpy on the CPU (no JAX), a few seconds.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro_torch.core import pieces, tiling
from repro_torch.core.einsum import parse
from repro_torch.core.schedule import Format, Schedule
from repro_torch.core.torch_backend import TiledExpr, compile_expr

EXPR = "X(i,j) = B(i,k) * C(k,j)"
FMT = Format({"B": "cc", "C": "dd"})
IKJ = Schedule(loop_order=("i", "k", "j"))


@pytest.mark.parametrize("expr,fmts,order,dims,dens", [
    (EXPR, {"B": "cc", "C": "dd"}, "ikj", {"i": 8192, "j": 1024, "k": 8192},
     {"B": 0.002, "C": 1.0}),
    (EXPR, {"B": "cc", "C": "cc"}, "ijk", {"i": 300, "j": 200, "k": 100},
     0.05),
    ("x(i) = b(i) - C(i,j) * d(j)", {"b": "c", "C": "cc", "d": "c"}, "ij",
     {"i": 1000, "j": 700}, None),
    ("X(i,j) = B(i,j) + C(i,j) + D(i,j)",
     {"B": "cc", "C": "dc", "D": "cc"}, "ij", {"i": 64, "j": 4096}, 0.1),
    ("X(i,j) = B(i,k,l) * C(j,k) * D(j,l)",
     {"B": "ccc", "C": "cc", "D": "dd"}, "ijkl",
     {"i": 40, "j": 30, "k": 20, "l": 10}, {"B": 0.1, "C": 0.5, "D": 1.0}),
])
def test_call_parts_recombine_to_the_estimate(expr, fmts, order, dims, dens):
    assign = parse(expr)
    fmt = Format(fmts)
    sch = Schedule(loop_order=tuple(order))
    dd = dens if isinstance(dens, dict) or dens is None else {
        f.tensor: dens for t in assign.terms for f in t.factors}
    operand, stream, result = pieces.call_parts(assign, fmt, sch, dims,
                                                densities=dd)
    assert math.ceil(operand + 16 * stream + 13 * result) == (
        tiling.estimate_call_bytes(assign, fmt, sch, dims, densities=dd))


def test_piece_count():
    per = pieces.STREAM_ROW_BYTES * pieces.BUCKET_HEADROOM      # 67.5
    assert pieces.piece_count(1e9, per, None) == 1
    assert pieces.piece_count(1e6, per, 10 ** 9) == 1           # fits
    need = per * 1e8
    assert pieces.piece_count(1e8, per, int(need)) == 1         # just fits
    assert pieces.piece_count(1e8, per, int(need) - 1) == 2
    # the fixed bytes leave room for the streams: ceil(need / room)
    assert pieces.piece_count(1e8, per, 2 ** 32, fixed_bytes=2 ** 31) == (
        math.ceil(need / 2 ** 31))
    # fixed bytes beyond the budget: the streams get a tenth of it
    assert pieces.piece_count(1e6, per, 10 ** 6, fixed_bytes=10 ** 7) == (
        math.ceil(per * 1e6 / 10 ** 5))


def _operands(seed, ni, nk, nj, density):
    rng = np.random.default_rng(seed)
    B = ((rng.random((ni, nk)) < density)
         * rng.integers(1, 9, (ni, nk))).astype(float)
    return {"B": B, "C": rng.integers(1, 9, (nk, nj)).astype(float)}


def test_pieces_keep_the_largest_capacity_within_the_budget():
    dims = {"i": 128, "j": 96, "k": 128}
    dens = {"B": 0.1, "C": 1.0}
    arrays = _operands(7, 128, 128, 96, 0.1)
    budget = tiling.estimate_call_bytes(EXPR, FMT, IKJ, dims,
                                        densities=dens) // 3
    eng = compile_expr(EXPR, FMT, IKJ, dims, mem_budget=budget,
                       sparsity=dens, device="cpu")
    assert isinstance(eng, TiledExpr) and eng.n_tiles > 1
    assert eng.pieces > 1 and eng.par_n == 1
    assert eng.engine.par_n == eng.pieces
    assert eng.engine.schedule.parallelize == {"i": eng.pieces}
    before = dict(eng.engine.stats)
    got = eng(arrays).to_dense()
    np.testing.assert_array_equal(got, arrays["B"] @ arrays["C"])
    np.testing.assert_array_equal(
        got, compile_expr(EXPR, FMT, IKJ, dims, device="cpu")(arrays)
        .to_dense())
    stats = {k: eng.engine.stats[k] - before[k]
             for k in ("plan_misses", "plan_hits", "lane_dispatches")}
    assert stats == {"plan_misses": 1, "plan_hits": eng.n_tiles - 1,
                     "lane_dispatches": eng.n_tiles}
    caps = next(iter(eng.engine._plans.values())).caps
    stream = max(v for k, v in caps.items() if ".s" in k)
    space = eng.inner_dims["i"] * eng.inner_dims["j"]
    assert stream * pieces.row_bytes(space) <= budget


def test_a_tile_runs_whole_without_a_budget_or_with_lanes():
    dims = {"i": 64, "j": 32, "k": 64}
    arrays = _operands(8, 64, 64, 32, 0.2)
    want = arrays["B"] @ arrays["C"]
    plain = TiledExpr(EXPR, FMT, dataclasses.replace(IKJ, tile={"k": 2}),
                      dims, device="cpu")
    assert plain.pieces == 1 and plain.engine.schedule.parallelize == {}
    np.testing.assert_array_equal(plain(arrays).to_dense(), want)
    laned = dataclasses.replace(IKJ, parallelize={"j": 2}, tile={"k": 2})
    dens = {"B": 0.2, "C": 1.0}
    budget = tiling.estimate_call_bytes(                  # the tile just fits
        EXPR, FMT, IKJ, tiling.tile_extents(dims, {"k": 2}), densities=dens)
    eng = TiledExpr(EXPR, FMT, laned, dims, device="cpu", mem_budget=budget,
                    densities=dens)
    assert eng.pieces == 1 and eng.par_n == 2
    np.testing.assert_array_equal(eng(arrays).to_dense(), want)
