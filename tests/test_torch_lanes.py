"""Split, parallel lanes and batches of the port's ``CompiledExpr``.

* The 14 Table-1 cases with ``split={outer: k}, parallelize={outer: k}``
  for k in {1, 2, 4} equal numpy and the port's simulator; four of them
  (one multi-term) at k = 2 also return the reference ``CompiledExpr``'s
  FiberTree.
* Counterparts of the reference's split conformance tests: two split
  variables, split without parallelize, a lone negative term under split.
* ``execute_batch`` equals a loop of singles (single- and multi-term),
  and the reference's ``execute_batch`` on the same operand sets (a batch
  of 3); sticky hints keep one plan over jittering batches;
  ``encode_batch`` -> ``execute_encoded`` -> ``decode_batch`` equals
  ``execute_batch``; ``execute_many`` equals singles; an overflow retry
  of a freshly recorded plan brings back only the needed sizes.
* ``execute_coo`` under split returns original-space coordinates.
* The ``shard_lanes`` resolver raises as specified.

Integer-valued data, so every comparison is exact.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from test_custard_table1 import CASES, DIMS  # noqa: E402
from test_torch_engine import (assert_same_tree, make_arrays,  # noqa: E402
                               want_of)

from repro.core.jax_backend import CompiledExpr as RCompiledExpr  # noqa: E402
from repro.core.schedule import Format as RFormat  # noqa: E402
from repro.core.schedule import Schedule as RSchedule  # noqa: E402
from repro_torch.core import torch_backend as tb  # noqa: E402
from repro_torch.core.schedule import Format, Schedule  # noqa: E402
from repro_torch.core.simulator import simulate_expr  # noqa: E402
from repro_torch.core.torch_backend import (CompiledExpr,  # noqa: E402
                                            compile_expr)

CPU = "cpu"
SPMSPM = "X(i,j) = B(i,k) * C(k,j)"
SPMSPM_FMT = {"B": "cc", "C": "cc"}
RESIDUAL = "x(i) = b(i) - C(i,j) * d(j)"
RESIDUAL_FMT = {"b": "c", "C": "cc", "d": "c"}
BDIMS = {"i": 14, "j": 11, "k": 9}


def sparse(rng, shape, density=0.4):
    return ((rng.random(shape) < density)
            * rng.integers(1, 9, shape)).astype(float)


def spmspm_set(rng, density=0.4):
    return {"B": sparse(rng, (14, 9), density),
            "C": sparse(rng, (9, 11), density)}


def residual_set(rng):
    return {"b": sparse(rng, 14, 0.5), "C": sparse(rng, (14, 11)),
            "d": sparse(rng, 11, 0.5)}


def lanes(order, k):
    return dict(loop_order=tuple(order), split={order[0]: k},
                parallelize={order[0]: k})


# -- Table 1 under split and parallelize -------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("name,expr,order,fmts,expected", CASES,
                         ids=[c[0] for c in CASES])
def test_table1_lanes_equal_numpy_and_simulator(name, expr, order, fmts,
                                                expected, k):
    arrays = make_arrays(expr, DIMS, seed=len(name))
    want = want_of(expr, arrays, DIMS)
    eng = CompiledExpr(expr, Format(dict(fmts)), Schedule(**lanes(order, k)),
                       DIMS, device=CPU)
    got = eng(arrays).to_dense()
    np.testing.assert_array_equal(got, want, err_msg=f"{name} k={k}")
    sim = simulate_expr(expr, Format(dict(fmts)), Schedule(**lanes(order, k)),
                        arrays, DIMS)
    np.testing.assert_array_equal(got, sim.dense, err_msg=f"{name} k={k}")
    assert eng.par_n == k and eng.stats["sharded_dispatches"] == 0
    assert eng.stats["lane_dispatches"] == (1 if max(eng.lane_ns) > 1
                                            else 0)


@pytest.mark.parametrize("name", ["SpMV", "SpMSpM_lc", "SDDMM", "Residual"])
def test_lanes_equal_the_reference_engine(name):
    _, expr, order, fmts, _ = next(c for c in CASES if c[0] == name)
    arrays = make_arrays(expr, DIMS, seed=len(name))
    got = CompiledExpr(expr, Format(dict(fmts)), Schedule(**lanes(order, 2)),
                       DIMS, device=CPU)
    ref = RCompiledExpr(expr, RFormat(dict(fmts)),
                        RSchedule(**lanes(order, 2)), DIMS, shard_lanes=False)
    assert got.lane_ns == ref.lane_ns and got.par_n == ref.par_n == 2
    assert_same_tree(ref(arrays), got(arrays), name)
    assert got.orig_result_order == ref.orig_result_order


# -- counterparts of the reference's split conformance tests -----------------

def test_multi_var_split_conformance():
    """Two split variables on one tensor: every axis reshapes, and only
    the outermost parallelizes."""
    rng = np.random.default_rng(9)
    B = sparse(rng, (10, 6), 0.5)
    dims = {"k": 10, "j": 6}
    fmt = Format({"B": "cc"})
    sch = Schedule(loop_order=("k", "j"), split={"k": 2, "j": 3},
                   parallelize={"k": 2})
    eng = compile_expr("X(k,j) = B(k,j)", fmt, sch, dims, device=CPU)
    np.testing.assert_array_equal(eng({"B": B}).to_dense(), B)
    sim = simulate_expr("X(k,j) = B(k,j)", fmt, sch, {"B": B}, dims)
    np.testing.assert_array_equal(sim.dense, B)
    assert eng.par_n == 2


@pytest.mark.parametrize("split", [{"i": 4}, {"k": 2}, {"j": 3},
                                   {"i": 2, "j": 2}])
def test_split_without_parallelize(split):
    rng = np.random.default_rng(3)
    arrays = spmspm_set(rng)
    sch = Schedule(loop_order=("i", "k", "j"), split=split)
    eng = CompiledExpr(SPMSPM, Format(SPMSPM_FMT), sch, BDIMS, device=CPU)
    want = arrays["B"] @ arrays["C"]
    np.testing.assert_array_equal(eng(arrays).to_dense(), want)
    sim = simulate_expr(SPMSPM, Format(SPMSPM_FMT), sch, arrays, BDIMS)
    np.testing.assert_array_equal(sim.dense, want)
    assert eng.lane_ns == [1] and eng.stats["lane_dispatches"] == 0


def test_single_term_negative_sign_under_split():
    rng = np.random.default_rng(11)
    b = sparse(rng, 8, 0.6)
    fmt = Format({"b": "c"})
    for sch in (Schedule(loop_order=("i",)),
                Schedule(loop_order=("i",), split={"i": 2}),
                Schedule(loop_order=("i",), split={"i": 2},
                         parallelize={"i": 2})):
        got = CompiledExpr("x(i) = -b(i)", fmt, sch, {"i": 8},
                           device=CPU)({"b": b})
        np.testing.assert_array_equal(got.to_dense(), -b, err_msg=str(sch))


# -- batches -----------------------------------------------------------------

@pytest.mark.parametrize("schedule", [
    dict(loop_order=("i", "k", "j")), lanes("ikj", 2)],
    ids=["unsplit", "lanes"])
def test_batch_matches_loop_of_singles(schedule):
    rng = np.random.default_rng(21)
    eng = CompiledExpr(SPMSPM, Format(SPMSPM_FMT), Schedule(**schedule),
                       BDIMS, device=CPU)
    batch = [spmspm_set(rng) for _ in range(5)]
    outs = eng.execute_batch(batch)
    assert len(outs) == 5 and eng.stats["batch_calls"] == 1
    for o, a in zip(outs, batch):
        np.testing.assert_array_equal(o.to_dense(), a["B"] @ a["C"])
        assert_same_tree(eng(a), o)
    # a second dispatch of fresh values reuses the batch plan
    traces, misses = eng.stats["traces"], eng.stats["plan_misses"]
    fresh = [{k: v * 2 for k, v in a.items()} for a in batch]
    for o, a in zip(eng.execute_batch(fresh), fresh):
        np.testing.assert_array_equal(o.to_dense(), a["B"] @ a["C"])
    assert eng.stats["traces"] == traces
    assert eng.stats["plan_misses"] == misses


def test_batch_multiterm():
    rng = np.random.default_rng(22)
    eng = CompiledExpr(RESIDUAL, Format(RESIDUAL_FMT),
                       Schedule(loop_order=("i", "j")), BDIMS, device=CPU)
    batch = [residual_set(rng) for _ in range(3)]
    for o, a in zip(eng.execute_batch(batch), batch):
        np.testing.assert_array_equal(o.to_dense(),
                                      a["b"] - a["C"] @ a["d"])
        assert_same_tree(eng(a), o)


def test_batch_equals_the_reference_execute_batch():
    rng = np.random.default_rng(23)
    batch = [residual_set(rng) for _ in range(3)]
    sch = lanes("ij", 2)
    got = CompiledExpr(RESIDUAL, Format(RESIDUAL_FMT), Schedule(**sch),
                       BDIMS, device=CPU)
    ref = RCompiledExpr(RESIDUAL, RFormat(RESIDUAL_FMT), RSchedule(**sch),
                        BDIMS, shard_lanes=False)
    for r, o in zip(ref.execute_batch(batch), got.execute_batch(batch)):
        assert_same_tree(r, o)
    for key in ("batch_calls", "plan_misses", "lane_dispatches"):
        assert got.stats[key] == ref.stats[key] == 1, key


def test_sticky_hints_keep_one_plan_over_jittering_batches():
    rng = np.random.default_rng(24)
    eng = CompiledExpr(SPMSPM, Format(SPMSPM_FMT),
                       Schedule(loop_order=("i", "k", "j")), BDIMS,
                       device=CPU)
    first = [spmspm_set(rng, 0.7) for _ in range(4)]
    eng.execute_batch(first)
    for _ in range(4):
        batch = [spmspm_set(rng, rng.uniform(0.05, 0.6))
                 for _ in range(int(rng.integers(3, 5)))]
        for o, a in zip(eng.execute_batch(batch), batch):
            np.testing.assert_array_equal(o.to_dense(), a["B"] @ a["C"])
    assert eng.stats["plan_misses"] == 1
    assert eng.stats["plan_hits"] == 4


def test_staged_batch_equals_execute_batch():
    rng = np.random.default_rng(25)
    eng = CompiledExpr(SPMSPM, Format(SPMSPM_FMT), Schedule(**lanes("ikj", 2)),
                       BDIMS, device=CPU)
    batch = [spmspm_set(rng) for _ in range(3)]
    enc = eng.encode_batch(batch)
    assert enc.b == 3
    staged = eng.decode_batch(enc, eng.execute_encoded(enc))
    for s, o in zip(staged, eng.execute_batch(batch)):
        assert_same_tree(o, s)


def test_execute_many_equals_singles():
    rng = np.random.default_rng(26)
    eng = CompiledExpr(SPMSPM, Format(SPMSPM_FMT), Schedule(**lanes("ikj", 4)),
                       BDIMS, device=CPU)
    sets = [spmspm_set(rng, d) for d in (0.2, 0.5, 0.3)]
    outs = eng.execute_many(sets)
    assert eng.stats["plan_misses"] == 1 and eng.stats["calls"] == 3
    for o, a in zip(outs, sets):
        assert_same_tree(eng(a), o)
        np.testing.assert_array_equal(o.to_dense(), a["B"] @ a["C"])


def test_fresh_plan_retry_moves_only_needs(monkeypatch):
    rng = np.random.default_rng(28)
    eng = CompiledExpr(SPMSPM, Format(SPMSPM_FMT), Schedule(**lanes("ikj", 2)),
                       BDIMS, device=CPU)
    honest = eng._record_caps
    monkeypatch.setattr(eng, "_record_caps",
                        lambda flats: {k: 8 for k in honest(flats)})
    moved, to_host = [], tb._to_host
    monkeypatch.setattr(tb, "_to_host",
                        lambda t: moved.append(sorted(t)) or to_host(t))
    arrays = spmspm_set(rng, 0.7)
    np.testing.assert_array_equal(eng(arrays).to_dense(),
                                  arrays["B"] @ arrays["C"])
    assert eng.stats["overflow_retries"] >= 1
    assert all(m == ["needs"] for m in moved[:-2]) and len(moved) >= 3
    assert moved[-2] == ["needs"] and "out.keys" in moved[-1]
    # a plan hit brings its result and its needs back in one transfer
    moved.clear()
    eng(arrays)
    assert len(moved) == 1 and {"needs", "out.keys"} <= set(moved[0])


# -- original-space results --------------------------------------------------

@pytest.mark.parametrize("split", [{"i": 4}, {"j": 3}, {"i": 4, "j": 3}])
def test_execute_coo_returns_original_coordinates(split):
    rng = np.random.default_rng(27)
    arrays = spmspm_set(rng)
    eng = CompiledExpr(SPMSPM, Format(SPMSPM_FMT),
                       Schedule(loop_order=("i", "k", "j"), split=split,
                                parallelize={"i": 4} if "i" in split else {}),
                       BDIMS, device=CPU)
    coords, vals = eng.execute_coo(arrays)
    assert eng.orig_result_order == ["i", "j"]
    want = arrays["B"] @ arrays["C"]
    assert coords.shape == (np.count_nonzero(want), 2)
    dense = np.zeros_like(want)
    dense[coords[:, 0], coords[:, 1]] = vals
    np.testing.assert_array_equal(dense, want)


# -- lane placement -----------------------------------------------------------

def test_shard_lanes_resolver(monkeypatch):
    sch = Schedule(**lanes("ikj", 4))
    fmt = Format(SPMSPM_FMT)
    for shard in (None, False):
        eng = compile_expr(SPMSPM, fmt, sch, BDIMS, device=CPU,
                           shard_lanes=shard)
        eng(spmspm_set(np.random.default_rng(1)))
        assert eng.stats["sharded_dispatches"] == 0
    # no GPU, or too few: a required mesh cannot fit
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for shard in (True, 2):
        with pytest.raises(ValueError, match="cannot shard 4 lane"):
            compile_expr(SPMSPM, fmt, sch, BDIMS, device=CPU,
                         shard_lanes=shard)
    # a mesh would fit: lanes over GPUs belong to the distributed slice
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tb.lane_mesh_size(4) == 4 and tb.lane_mesh_size(4, 2) == 2
    assert tb.lane_mesh_size(3) == 3 and tb.lane_mesh_size(3, 2) == 1
    for shard in (True, 2):
        with pytest.raises(NotImplementedError, match="still to port #5"):
            CompiledExpr(SPMSPM, fmt, sch, BDIMS, device=CPU,
                         shard_lanes=shard)
    with pytest.raises(ValueError, match="with --devices 1"):
        CompiledExpr(SPMSPM, fmt, sch, BDIMS, device=CPU, shard_lanes=1)
