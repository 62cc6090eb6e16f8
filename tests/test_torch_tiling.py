"""Tiled out-of-core execution in the port, against the reference.

* The copy ``repro_torch.core.tiling`` against the reference's
  ``repro.core.tiling`` (pure Python) over a grid of expressions,
  formats, extents, densities and budgets: ``estimate_call_bytes``,
  ``plan_tiles``, ``resolve_plan``, ``legal_tile_vars``, ``check_tile``'s
  errors and ``slice_operands`` are equal. So is the out-of-core SpMM of
  ``chip_smoke.py`` (o): its untiled estimate and its plan ``{i: 2, k: 2}``.
* The port's legs of ``tests/test_tiling.py``: ``TiledExpr`` on the CPU
  equals numpy and the port's untiled ``CompiledExpr`` (parametrized
  tiles, split and lanes, overshooting grids, a scalar, multi-term), every
  tile after the first hits the one plan, one engine per configuration,
  the budget refuses or tiles, densities partition the engine cache,
  ``accumulate_coo`` reduce- and concat-merges, a budgeted search returns
  only fitting schedules, and a program under a budget tiles its unfused
  stages.
* The reference ``TiledExpr`` on three cases returns what the port's
  returns (each reference compile costs seconds, so only three), and on
  a budget whose tiles the port runs in pieces.
* The copy's tiled simulation (``simulator._simulate_tiled``) gives the
  reference's cycles, dense results and tile counts, with 1 and 2
  workers.

Integer-valued data, so every comparison is exact.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import jax_backend as rjb  # noqa: E402
from repro.core import simulator as rsim  # noqa: E402
from repro.core import tiling as rtiling  # noqa: E402
from repro.core.einsum import parse as rparse  # noqa: E402
from repro.core.schedule import Format as RFormat  # noqa: E402
from repro.core.schedule import Schedule as RSchedule  # noqa: E402
from repro_torch.core import coord_ops as co  # noqa: E402
from repro_torch.core import tiling  # noqa: E402
from repro_torch.core import torch_backend as tb  # noqa: E402
from repro_torch.core.custard import expr_cache_key, lower  # noqa: E402
from repro_torch.core.einsum import parse  # noqa: E402
from repro_torch.core.program import numpy_reference  # noqa: E402
from repro_torch.core.schedule import (Format, Schedule,  # noqa: E402
                                       schedule_from_dict, schedule_to_dict)
from repro_torch.core.simulator import simulate_expr  # noqa: E402
from repro_torch.core.torch_backend import (CompiledExpr,  # noqa: E402
                                            TiledExpr, compile_expr)

CPU = "cpu"
EXPR = "X(i,j) = B(i,k) * C(k,j)"
DIMS = {"i": 20, "j": 14, "k": 16}
FMT = Format({"B": "cc", "C": "cc"})
IKJ = Schedule(loop_order=("i", "k", "j"))


def _ops(seed=0, density=0.3):
    rng = np.random.default_rng(seed)
    B = ((rng.random((DIMS["i"], DIMS["k"])) < density)
         * rng.integers(1, 9, (DIMS["i"], DIMS["k"]))).astype(float)
    C = ((rng.random((DIMS["k"], DIMS["j"])) < density)
         * rng.integers(1, 9, (DIMS["k"], DIMS["j"]))).astype(float)
    return {"B": B, "C": C}


def compile_cpu(*args, **kw):
    return compile_expr(*args, device=CPU, **kw)


# ---------------------------------------------------------------------------
# the copy of tiling against the reference's
# ---------------------------------------------------------------------------

# (expression, formats, loop order)
GRID = [
    (EXPR, {"B": "cc", "C": "cc"}, "ikj"),
    (EXPR, {"B": "cc", "C": "dd"}, "ikj"),
    (EXPR, {"B": "dc", "C": "cc"}, "kij"),
    ("x(i) = B(i,j) * c(j)", {"B": "cc", "c": "c"}, "ij"),
    ("x(i) = b(i) - C(i,j) * d(j)", {"b": "c", "C": "cc", "d": "c"}, "ij"),
    ("X(i,j) = B(i,j) * C(i,k) * D(j,k)", {"B": "cc", "C": "dd", "D": "dd"},
     "ijk"),
    ("x = b(i) * c(i)", {"b": "c", "c": "c"}, "i"),
    ("X(i,j) = B(i,j) + C(i,j)", {"B": "cc", "C": "cs"}, "ij"),
    ("X(i,j,k) = B(i,j,l) * C(k,l)", {"B": "chm", "C": "cc"}, "ijkl"),
]
DIM_SETS = [{"i": 20, "j": 14, "k": 16, "l": 9},
            {"i": 4096, "j": 1024, "k": 4096, "l": 300}]
DENSITIES = [None, 0.01, {"B": 0.3, "C": 1.0}]


def _both(expr, fmts, order):
    a = parse(expr)
    dims_vars = set(a.all_vars)
    return ((a, Format(dict(fmts)), Schedule(loop_order=tuple(order))),
            (rparse(expr), RFormat(dict(fmts)),
             RSchedule(loop_order=tuple(order))), dims_vars)


@pytest.mark.parametrize("expr,fmts,order", GRID, ids=[g[0] + g[2]
                                                        for g in GRID])
def test_tiling_copy_equals_reference(expr, fmts, order):
    (a, f, s), (ra, rf, rs), used = _both(expr, fmts, order)
    assert tiling.legal_tile_vars(a) == rtiling.legal_tile_vars(ra)
    for dims in DIM_SETS:
        dims = {v: d for v, d in dims.items() if v in used}
        for dens in DENSITIES:
            est = tiling.estimate_call_bytes(a, f, s, dims, densities=dens)
            assert est == rtiling.estimate_call_bytes(ra, rf, rs, dims,
                                                      densities=dens)
            for budget in (est * 2, est // 2, est // 7, est // 50, 64):
                try:
                    want = rtiling.resolve_plan(ra, rf, rs, dims, budget,
                                                densities=dens)
                except rtiling.MemoryBudgetExceeded as e:
                    with pytest.raises(tiling.MemoryBudgetExceeded) as ei:
                        tiling.resolve_plan(a, f, s, dims, budget,
                                            densities=dens)
                    assert (ei.value.estimate, ei.value.budget) == (
                        e.estimate, e.budget)
                    continue
                got = tiling.resolve_plan(a, f, s, dims, budget,
                                          densities=dens)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert tiling.plan_tiles(a, f, s, dims, budget,
                                         densities=dens) == want.tile


def test_tiling_copy_plans_the_chip_smoke_out_of_core_spmm():
    """``chip_smoke.py`` (o): 16384 x 16384 x 1024, B at 0.2%, C dense,
    under 4 GB: both copies refuse untiled at the same estimate and plan
    the same 2 x 2 grid."""
    dims = {"i": 16384, "j": 1024, "k": 16384}
    dens = {"B": 0.002, "C": 1.0}
    got = tiling.resolve_plan(EXPR, Format({"B": "cc", "C": "dd"}), IKJ,
                              dims, "4GB", densities=dens)
    want = rtiling.resolve_plan(EXPR, RFormat({"B": "cc", "C": "dd"}),
                                RSchedule(loop_order=("i", "k", "j")), dims,
                                "4GB", densities=dens)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.untiled_bytes == 16282246691
    assert got.tile == {"i": 2, "k": 2} and got.tile_bytes <= 4 << 30


@pytest.mark.parametrize("tile,msg", [({"z": 2}, "not in the"),
                                      ({"j": 2}, "contraction"),
                                      ({"i": 2}, "tiled and split")])
def test_check_tile_errors_equal_reference(tile, msg):
    expr = "x(i) = b(i) - C(i,j) * d(j)"
    sch = Schedule(loop_order=("i", "j"), split={"i": 2})
    rsch = RSchedule(loop_order=("i", "j"), split={"i": 2})
    with pytest.raises(ValueError, match=msg) as got:
        tiling.check_tile(parse(expr), tile, schedule=sch)
    with pytest.raises(ValueError) as want:
        rtiling.check_tile(rparse(expr), tile, schedule=rsch)
    assert str(got.value) == str(want.value)


def test_slice_operands_equal_reference():
    arrays = _ops(seed=2)
    tile = {"i": 3, "k": 5}
    for tids in tiling.tile_grid(tile):
        got = tiling.slice_operands(EXPR, arrays, DIMS, tile, tids)
        want = rtiling.slice_operands(EXPR, arrays, DIMS, tile, tids)
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])
    assert list(tiling.tile_grid(tile)) == list(rtiling.tile_grid(tile))
    assert (tiling.parse_budget("1.5G"), tiling.format_bytes(3 << 20)) == (
        rtiling.parse_budget("1.5G"), rtiling.format_bytes(3 << 20))


# ---------------------------------------------------------------------------
# the port's legs of tests/test_tiling.py
# ---------------------------------------------------------------------------

def test_tile_round_trips_and_keys():
    sch = Schedule(loop_order=("i", "k", "j"), tile={"k": 4})
    assert schedule_from_dict(schedule_to_dict(sch)) == sch
    a = parse(EXPR)
    assert expr_cache_key(a, FMT, sch, DIMS) != expr_cache_key(a, FMT, IKJ,
                                                               DIMS)


def test_custard_rejects_tiled_schedules():
    with pytest.raises(ValueError, match="tile"):
        lower(EXPR, FMT, Schedule(loop_order=("i", "k", "j"),
                                  tile={"k": 2}), DIMS)


def test_tiled_expr_validates_its_grid():
    with pytest.raises(ValueError, match="not in the"):
        compile_cpu(EXPR, FMT, Schedule(loop_order=("i", "k", "j"),
                                        tile={"z": 2}), DIMS)
    with pytest.raises(ValueError, match="tiled and split"):
        compile_cpu(EXPR, FMT, Schedule(loop_order=("i", "k", "j"),
                                        split={"k": 2}, tile={"k": 2}), DIMS)
    with pytest.raises(ValueError, match="exceeds its extent"):
        compile_cpu(EXPR, FMT, Schedule(loop_order=("i", "k", "j"),
                                        tile={"k": 999}), DIMS)


@pytest.mark.parametrize("tile", [{"k": 2}, {"k": 16},       # contraction
                                  {"i": 4}, {"j": 3},        # result vars
                                  {"i": 2, "k": 4},          # mixed grid
                                  {"i": 3, "j": 2, "k": 5}])
def test_tiled_engine_matches_untiled_and_numpy(tile):
    arrays = _ops()
    want = arrays["B"] @ arrays["C"]
    untiled = compile_cpu(EXPR, FMT, IKJ, DIMS)(arrays).to_dense()
    eng = compile_cpu(EXPR, FMT, dataclasses.replace(IKJ, tile=tile), DIMS)
    assert isinstance(eng, TiledExpr)
    got = eng(arrays).to_dense()
    np.testing.assert_array_equal(got, want)       # integer values: exact
    np.testing.assert_array_equal(got, untiled)
    sim = simulate_expr(EXPR, FMT, dataclasses.replace(IKJ, tile=tile),
                        arrays, DIMS)
    np.testing.assert_array_equal(sim.dense, want)
    assert sim.tiles == tiling.n_tiles(tile)


def test_tile_composes_with_split_and_lanes():
    arrays = _ops(seed=3)
    want = arrays["B"] @ arrays["C"]
    sch = Schedule(loop_order=("i", "k", "j"), split={"k": 2},
                   parallelize={"k": 2}, tile={"j": 2})
    eng = compile_cpu(EXPR, FMT, sch, DIMS, shard_lanes=False)
    assert isinstance(eng, TiledExpr) and eng.par_n == 2
    np.testing.assert_array_equal(eng(arrays).to_dense(), want)
    sim = simulate_expr(EXPR, FMT, sch, arrays, DIMS)
    np.testing.assert_array_equal(sim.dense, want)


def test_overshooting_tile_count_all_padding_tail_tiles():
    """A ceil-division grid can overshoot the extent (22 over 7 tiles of
    4 covers [0, 28)): the tail tiles are pure padding and add nothing."""
    rng = np.random.default_rng(21)
    b = ((rng.random(22) < 0.6) * rng.integers(1, 9, 22)).astype(float)
    dims = {"i": 22}
    sch = Schedule(loop_order=("i",), tile={"i": 7})
    eng = compile_cpu("x(i) = b(i)", Format({"b": "c"}), sch, dims)
    np.testing.assert_array_equal(eng({"b": b}).to_dense(), b)
    sim = simulate_expr("x(i) = b(i)", Format({"b": "c"}), sch,
                        {"b": b}, dims)
    np.testing.assert_array_equal(sim.dense, b)
    assert sim.tiles == 7


def test_tiled_scalar_full_contraction():
    rng = np.random.default_rng(7)
    b = (rng.integers(0, 5, 30)).astype(float)
    c = (rng.integers(0, 3, 30)).astype(float)
    eng = compile_cpu("x = b(i) * c(i)", Format({"b": "c", "c": "c"}),
                      Schedule(loop_order=("i",), tile={"i": 4}), {"i": 30})
    assert float(eng({"b": b, "c": c}).to_dense()) == float(b @ c)


def test_tiling_contraction_var_missing_from_a_term_is_rejected():
    dims = {"i": 8, "j": 8}
    fmt = Format(default="c")
    sch = Schedule(loop_order=("i", "j"), tile={"j": 2})
    with pytest.raises(ValueError, match="contraction"):
        compile_cpu("x(i) = b(i) - C(i,j) * d(j)", fmt, sch, dims)
    with pytest.raises(ValueError, match="contraction"):
        simulate_expr("x(i) = b(i) - C(i,j) * d(j)", fmt, sch,
                      {"b": np.ones(8), "C": np.eye(8), "d": np.ones(8)},
                      dims)


def test_tiled_contraction_var_present_in_every_term():
    rng = np.random.default_rng(13)
    Bm = ((rng.random((10, 12)) < 0.5)
          * rng.integers(1, 5, (10, 12))).astype(float)
    Dm = ((rng.random((10, 12)) < 0.5)
          * rng.integers(1, 5, (10, 12))).astype(float)
    c = rng.integers(0, 4, 12).astype(float)
    e = rng.integers(0, 4, 12).astype(float)
    eng = compile_cpu("x(i) = B(i,j) * c(j) + D(i,j) * e(j)",
                      Format(default="c"),
                      Schedule(loop_order=("i", "j"), tile={"j": 3}),
                      {"i": 10, "j": 12})
    np.testing.assert_array_equal(
        eng({"B": Bm, "c": c, "D": Dm, "e": e}).to_dense(), Bm @ c + Dm @ e)


def test_tiled_multi_term_expression():
    rng = np.random.default_rng(11)
    b = (rng.integers(0, 5, 24)).astype(float)
    Cm = ((rng.random((24, 18)) < 0.4)
          * rng.integers(1, 9, (24, 18))).astype(float)
    d = (rng.integers(0, 4, 18)).astype(float)
    eng = compile_cpu("x(i) = b(i) - C(i,j) * d(j)",
                      Format({"b": "c", "C": "cc", "d": "c"}),
                      Schedule(loop_order=("i", "j"), tile={"i": 3}),
                      {"i": 24, "j": 18})
    np.testing.assert_array_equal(eng({"b": b, "C": Cm, "d": d}).to_dense(),
                                  b - Cm @ d)


def test_every_tile_after_the_first_hits_the_plan_cache():
    arrays = _ops(seed=5)
    eng = compile_cpu(EXPR, FMT, dataclasses.replace(IKJ, tile={"k": 4}),
                      DIMS)
    m0, h0 = eng.engine.stats["plan_misses"], eng.engine.stats["plan_hits"]
    eng(arrays)
    assert eng.engine.stats["plan_misses"] - m0 == 1
    assert eng.engine.stats["plan_hits"] - h0 == eng.n_tiles - 1
    eng(arrays)                                    # warm call: ALL tiles hit
    assert eng.engine.stats["plan_misses"] - m0 == 1
    assert eng.engine.stats["plan_hits"] - h0 == 2 * eng.n_tiles - 1
    assert eng.stats["tile_calls"] == 2 * eng.n_tiles


def test_compile_expr_returns_one_tiled_engine_per_config():
    sch = dataclasses.replace(IKJ, tile={"k": 2})
    a = compile_cpu(EXPR, FMT, sch, DIMS)
    assert compile_cpu(EXPR, FMT, sch, DIMS) is a
    assert compile_cpu(EXPR, FMT, sch, DIMS, use_kernels=False) is not a
    tb.clear_compile_cache()
    assert compile_cpu(EXPR, FMT, sch, DIMS) is not a


def test_estimate_grows_with_extents_and_density():
    a = parse(EXPR)
    small = tiling.estimate_call_bytes(a, FMT, IKJ, DIMS,
                                       densities={"B": 0.1, "C": 0.1})
    denser = tiling.estimate_call_bytes(a, FMT, IKJ, DIMS,
                                        densities={"B": 0.9, "C": 0.9})
    bigger = tiling.estimate_call_bytes(
        a, FMT, IKJ, {v: 8 * d for v, d in DIMS.items()},
        densities={"B": 0.1, "C": 0.1})
    assert small < denser and small < bigger


def test_plan_tiles_fits_the_budget_or_raises():
    a = parse(EXPR)
    dens = {"B": 0.3, "C": 0.3}
    est = tiling.estimate_call_bytes(a, FMT, IKJ, DIMS, densities=dens)
    plan = tiling.plan_tiles(a, FMT, IKJ, DIMS, est // 3, densities=dens)
    assert plan and tiling.estimate_call_bytes(
        a, FMT, IKJ, tiling.tile_extents(DIMS, plan),
        densities=dens) <= est // 3
    assert tiling.plan_tiles(a, FMT, IKJ, DIMS, est * 2,
                             densities=dens) == {}
    with pytest.raises(tiling.MemoryBudgetExceeded):
        tiling.plan_tiles(a, FMT, IKJ, DIMS, 16, densities=dens)


def test_budget_refuses_or_auto_tiles():
    arrays = _ops(seed=9)
    want = arrays["B"] @ arrays["C"]
    dens = {"B": 0.3, "C": 0.3}
    est = tiling.estimate_call_bytes(EXPR, FMT, IKJ, DIMS, densities=dens)
    with pytest.raises(tiling.MemoryBudgetExceeded) as ei:
        compile_cpu(EXPR, FMT, IKJ, DIMS, mem_budget=est // 3,
                    sparsity=dens, auto_tile=False)
    assert ei.value.estimate == est and ei.value.budget == est // 3
    eng = compile_cpu(EXPR, FMT, IKJ, DIMS, mem_budget=est // 3,
                      sparsity=dens)
    assert isinstance(eng, TiledExpr) and eng.n_tiles >= 2
    assert eng.tile_bytes <= est // 3
    np.testing.assert_array_equal(eng(arrays).to_dense(), want)
    # in-budget requests keep the ordinary engine
    ok = compile_cpu(EXPR, FMT, IKJ, DIMS, mem_budget=est * 2, sparsity=dens)
    assert isinstance(ok, CompiledExpr)


def test_eager_fallback_strips_tile():
    out = tb.execute_expr("x(i) = B(i,j) * c(j)", Format({"B": "cc"}),
                          Schedule(loop_order=("i", "j"), tile={"i": 2}),
                          {"B": np.eye(6), "c": np.ones(6)},
                          {"i": 6, "j": 6}, compiled=False, device=CPU)
    np.testing.assert_array_equal(out.to_dense(), np.ones(6))


def test_search_unfittable_budget_raises_budget_error():
    from repro_torch.core.autoschedule import search

    with pytest.raises(tiling.MemoryBudgetExceeded) as ei:
        search("x(i) = B(i,j) * c(j)", Format({"B": "cc", "c": "c"}),
               {"i": 64, "j": 64}, mem_budget=1, device_count=1)
    assert ei.value.budget == 1 and ei.value.estimate > 1


def test_budget_string_forms():
    assert tiling.parse_budget("2MB") == 2 << 20
    assert tiling.parse_budget("512") == 512
    for bad in ("lots", "1..5MB"):
        with pytest.raises(ValueError, match="cannot parse"):
            tiling.parse_budget(bad)


def test_auto_schedule_with_budget_honors_auto_tile_false(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("SAM_SCHEDULE_CACHE", str(tmp_path / "s.json"))
    dens = {"B": 0.3, "C": 0.3}
    est = tiling.estimate_call_bytes(EXPR, FMT, IKJ, DIMS, densities=dens)
    with pytest.raises(tiling.MemoryBudgetExceeded):
        compile_cpu(EXPR, FMT, "auto", DIMS, mem_budget=est // 100,
                    sparsity=dens, auto_tile=False)


def test_tiled_engine_cache_partitions_on_densities():
    sch = dataclasses.replace(IKJ, tile={"k": 2})
    ext = tiling.tile_extents(DIMS, {"k": 2})
    lo = tiling.estimate_call_bytes(EXPR, FMT, IKJ, ext,
                                    densities={"B": 0.01, "C": 0.01})
    hi = tiling.estimate_call_bytes(EXPR, FMT, IKJ, ext,
                                    densities={"B": 1.0, "C": 1.0})
    budget = (lo + hi) // 2                 # sparse tile fits, dense not
    eng = compile_cpu(EXPR, FMT, sch, DIMS, mem_budget=budget,
                      sparsity={"B": 0.01, "C": 0.01})
    assert isinstance(eng, TiledExpr)
    with pytest.raises(tiling.MemoryBudgetExceeded):
        compile_cpu(EXPR, FMT, sch, DIMS, mem_budget=budget,
                    sparsity={"B": 1.0, "C": 1.0})


def test_plan_tiles_never_overshoots_the_grid():
    a = parse(EXPR)
    dims = {"i": 9, "j": 22, "k": 13}
    dens = {"B": 1.0, "C": 1.0}
    est = tiling.estimate_call_bytes(a, FMT, IKJ, dims, densities=dens)
    for frac in (2, 5, 20, 100):
        plan = tiling.plan_tiles(a, FMT, IKJ, dims, max(est // frac, 200),
                                 densities=dens)
        for v, n in plan.items():
            assert n == -(-dims[v] // -(-dims[v] // n)), (plan, v)


def test_accumulate_coo_reduce_and_concat_merges():
    k1 = np.array([1, 5, 9], np.int64)
    v1 = np.array([1.0, 2.0, 3.0], np.float32)
    # overlapping keys: a contraction-tile partial (reduce-merge)
    k, v = co.accumulate_coo(k1, v1, np.array([5, 9, 12], np.int64),
                             np.array([10.0, 20.0, 30.0], np.float32),
                             device=CPU)
    assert k.tolist() == [1, 5, 9, 12]
    assert v.tolist() == [1.0, 12.0, 23.0, 30.0]
    # disjoint keys: a result-tile partial (concat-merge, same primitive),
    # here through the dispatch entry with a dense key bound
    k2, v2 = co.accumulate_coo(
        k, v, np.array([0, 100], np.int64), np.array([7.0, 8.0], np.float32),
        key_bound=128, device=CPU,
        union_reduce_impl=tb.kops.sam_primitive("keyed_union_reduce", CPU))
    assert k2.tolist() == [0, 1, 5, 9, 12, 100]
    assert v2[0] == 7.0 and v2[-1] == 8.0
    ek, ev = co.accumulate_coo(np.zeros(0, np.int64), np.zeros(0),
                               np.zeros(0, np.int64), np.zeros(0), device=CPU)
    assert len(ek) == 0 and len(ev) == 0


def test_search_with_budget_only_returns_fitting_schedules(tmp_path):
    from repro_torch.core.autoschedule import (ScheduleCache,
                                               resolve_schedule, search)

    dims = {"i": 64, "j": 64, "k": 64}
    dens = {"B": 0.3, "C": 1.0}
    fmt = Format({"B": "cc", "C": "dd"})
    budget = tiling.estimate_call_bytes(EXPR, fmt, IKJ, dims,
                                        densities=dens) // 2
    rep = search(EXPR, fmt, dims, sparsity=dens, device_count=1,
                 mem_budget=budget, max_orders=2)
    assert rep.candidates
    for c in rep.candidates:
        assert tiling.estimate_call_bytes(
            EXPR, fmt, c.schedule, tiling.tile_extents(dims, c.schedule.tile),
            densities=dens) <= budget
    cache = ScheduleCache(path=tmp_path / "s.json")
    kw = dict(sparsity=dens, cache=cache, device_count=1, max_orders=2)
    r1 = resolve_schedule(EXPR, fmt, dims, mem_budget=budget, **kw)
    assert not r1.cache_hit
    r2 = resolve_schedule(EXPR, fmt, dims, mem_budget=budget, **kw)
    assert r2.cache_hit and r2.schedule == r1.schedule
    assert resolve_schedule(EXPR, fmt, dims, **kw).key != r1.key


def test_program_budget_tiles_unfused_stages():
    text = "T(i,k) = B(i,j) * C(j,k); x(i) = T(i,k) * d(k)"
    rng = np.random.default_rng(2)
    arrays = {"B": ((rng.random((16, 16)) < 0.4)
                    * rng.integers(1, 5, (16, 16))).astype(float),
              "C": ((rng.random((16, 16)) < 0.4)
                    * rng.integers(1, 5, (16, 16))).astype(float),
              "d": rng.integers(0, 4, 16).astype(float)}
    dims = {"i": 16, "j": 16, "k": 16}
    fmt = Format(default="c")
    sch = {"T": Schedule(loop_order=("i", "j", "k")),
           "x": Schedule(loop_order=("i", "k"))}
    est = tiling.estimate_call_bytes("T(i,k) = B(i,j) * C(j,k)", fmt,
                                     sch["T"], dims,
                                     densities={"B": 0.4, "C": 0.4})
    cp = tb.compile_program(text, fmt, sch, dims, fuse=False,
                            mem_budget=est // 2, sparsity=0.4, device=CPU)
    assert any(isinstance(u, TiledExpr) for _, _, u in cp.units)
    assert tb.compile_program(text, fmt, sch, dims, fuse=False,
                              mem_budget=est // 2, sparsity=0.4,
                              device=CPU) is cp
    assert tb.compile_program(text, fmt, sch, dims, fuse=False,
                              device=CPU) is not cp
    out = cp(arrays)
    ref = numpy_reference(text, arrays)
    np.testing.assert_array_equal(out["x"].to_dense(), ref["x"])
    np.testing.assert_array_equal(out["T"].to_dense(), ref["T"])


# ---------------------------------------------------------------------------
# against the reference's TiledExpr (three cases: each compile costs seconds)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile", [{"k": 2}, {"i": 4}, "budget"])
def test_tiled_engine_equals_reference_tiled_expr(tile):
    arrays = _ops(seed=17)
    dens = {"B": 0.3, "C": 0.3}
    rfmt = RFormat({"B": "cc", "C": "cc"})
    rikj = RSchedule(loop_order=("i", "k", "j"))
    if tile == "budget":
        budget = tiling.estimate_call_bytes(EXPR, FMT, IKJ, DIMS,
                                            densities=dens) // 5
        routed = compile_cpu(EXPR, FMT, IKJ, DIMS, mem_budget=budget,
                             sparsity=dens)
        rrouted = rjb.compile_expr(EXPR, rfmt, rikj, DIMS, mem_budget=budget,
                                   sparsity=dens)
        assert routed.tile_of == rrouted.tile_of and routed.n_tiles > 1
        assert routed.tile_bytes == rrouted.tile_bytes
        tile = routed.tile_of
    # fresh engines (the process-wide caches may hold engines other tests
    # have called), so their stats and shared hints compare from zero
    got = TiledExpr(EXPR, FMT, dataclasses.replace(IKJ, tile=tile), DIMS,
                    device=CPU)
    want = rjb.TiledExpr(EXPR, rfmt, dataclasses.replace(rikj, tile=tile),
                         DIMS)
    out, rout = got(arrays), want(arrays)
    np.testing.assert_array_equal(out.to_dense(), rout.to_dense())
    np.testing.assert_array_equal(out.to_dense(), arrays["B"] @ arrays["C"])
    assert out.mode_order == rout.mode_order
    assert got._hints == want._hints
    assert got.stats == want.stats


def test_tiled_pieces_equal_reference_tiled_expr():
    """Under a budget, the port runs each tile of the reference's plan in
    pieces (lanes over the outermost loop variable): the plan's
    ``tile_of``, ``n_tiles`` and ``tile_bytes`` stay the reference's, and
    the result equals the reference ``TiledExpr``'s bit for bit."""
    arrays = _ops(seed=17)
    dens = {"B": 0.3, "C": 0.3}
    budget = tiling.estimate_call_bytes(EXPR, FMT, IKJ, DIMS,
                                        densities=dens) // 5
    got = compile_cpu(EXPR, FMT, IKJ, DIMS, mem_budget=budget, sparsity=dens)
    want = rjb.compile_expr(EXPR, RFormat({"B": "cc", "C": "cc"}),
                            RSchedule(loop_order=("i", "k", "j")), DIMS,
                            mem_budget=budget, sparsity=dens)
    assert got.pieces > 1
    assert ((got.tile_of, got.n_tiles, got.tile_bytes)
            == (want.tile_of, want.n_tiles, want.tile_bytes))
    lanes0 = got.engine.stats["lane_dispatches"]
    out, rout = got(arrays), want(arrays)
    assert got.engine.stats["lane_dispatches"] - lanes0 == got.n_tiles
    np.testing.assert_array_equal(out.to_dense(), rout.to_dense())
    np.testing.assert_array_equal(out.to_dense(), arrays["B"] @ arrays["C"])
    assert out.mode_order == rout.mode_order


# ---------------------------------------------------------------------------
# the tiled simulation against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("expr,fmts,order,dims,tile", [
    (EXPR, {"B": "cc", "C": "cc"}, "ikj", DIMS, {"i": 3, "k": 2}),
    ("x(i) = b(i) - C(i,j) * d(j)", {"b": "c", "C": "cc", "d": "c"}, "ij",
     {"i": 13, "j": 9}, {"i": 4}),
    ("x = b(i) * c(i)", {"b": "c", "c": "c"}, "i", {"i": 30}, {"i": 4}),
    ("x(i) = b(i)", {"b": "c"}, "i", {"i": 22}, {"i": 7}),
])
def test_tiled_simulation_equals_reference(expr, fmts, order, dims, tile,
                                           workers):
    rng = np.random.default_rng(len(expr) + workers)
    arrays = {}
    for t in parse(expr).terms:
        for f in t.factors:
            shape = tuple(dims[v] for v in f.vars)
            arrays[f.tensor] = ((rng.random(shape) < 0.5)
                                * rng.integers(1, 9, shape)).astype(float)
    got = simulate_expr(expr, Format(dict(fmts)),
                        Schedule(loop_order=tuple(order), tile=tile),
                        arrays, dims, workers=workers)
    want = rsim.simulate_expr(expr, RFormat(dict(fmts)),
                              RSchedule(loop_order=tuple(order), tile=tile),
                              arrays, dims, workers=workers)
    assert (got.cycles, got.tiles, got.workers, got.merge_work) == (
        want.cycles, want.tiles, want.workers, want.merge_work)
    np.testing.assert_array_equal(got.dense, want.dense)
