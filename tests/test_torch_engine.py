"""The port's compiled engine against the reference engine, the simulator
and numpy (the 14 Table-1 cases are in ``test_torch_table1*.py``).

* Counterparts of the reference's compiled-engine tests: plan-cache hits,
  shared engines, overflow growth, forced tiny capacities, larger buckets,
  scalar results, eager == compiled.
* ``s``/``h``/``m`` operands canonicalize at ingest (stored trees carried
  across with ``tree_from_arrays``); ``b`` storage is refused.
* Custard's copies lower to graphs whose structural hashes equal the
  reference's, so the copies cannot fork silently.
* The multi-fiber locate case, where the reference misses coordinates,
  equals the simulator and numpy.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from test_custard_table1 import CASES, DIMS, oracle  # noqa: E402
from test_fused_golden import _as_dict  # noqa: E402

from repro.core.custard import lower as r_lower  # noqa: E402
from repro.core.einsum import parse  # noqa: E402
from repro.core.jax_backend import execute_graph as r_execute_graph  # noqa: E402
from repro.core.schedule import Format as RFormat  # noqa: E402
from repro.core.schedule import Schedule as RSchedule  # noqa: E402
from repro_torch.core import custard  # noqa: E402
from repro_torch.core.convert import tree_from_arrays  # noqa: E402
from repro_torch.core.custard import expr_cache_key, lower  # noqa: E402
from repro_torch.core.program import numpy_reference  # noqa: E402
from repro_torch.core.schedule import Format, Schedule  # noqa: E402
from repro_torch.core.simulator import simulate_expr  # noqa: E402
from repro_torch.core.tiling import estimate_call_bytes  # noqa: E402
from repro_torch.core.torch_backend import (  # noqa: E402
    CompiledExpr, JTensor, TiledExpr, clear_compile_cache, compile_expr,
    compile_program, execute_expr, execute_graph)
from repro_torch.kernels import ops as kops  # noqa: E402

CPU = "cpu"


def make_arrays(expr, dims, seed, density=0.4):
    rng = np.random.default_rng(seed)
    arrays = {}
    for term in parse(expr).terms:
        for acc in term.factors:
            if acc.tensor in arrays:
                continue
            if not acc.vars:
                arrays[acc.tensor] = np.asarray(float(rng.integers(1, 5)))
            else:
                shape = tuple(dims[v] for v in acc.vars)
                arrays[acc.tensor] = ((rng.random(shape) < density)
                                      * rng.integers(1, 9, shape)
                                      ).astype(float)
    return arrays


def want_of(expr, arrays, dims):
    assign = parse(expr)
    terms = [(t.sign, [(f.tensor, "".join(f.vars)) for f in t.factors])
             for t in assign.terms]
    return oracle(terms, arrays, "".join(assign.result_vars), dims)


def assert_same_tree(ref, got, msg=""):
    assert tuple(got.shape) == tuple(ref.shape), msg
    assert tuple(got.mode_order) == tuple(ref.mode_order), msg
    assert got.format_str == ref.format_str, msg
    for lr, lg in zip(ref.levels, got.levels):
        for name in ("seg", "crd"):
            a, b = getattr(lr, name), getattr(lg, name)
            assert (a is None) == (b is None), f"{msg}: {name}"
            if a is not None:
                np.testing.assert_array_equal(b, a, err_msg=f"{msg}: {name}")
    np.testing.assert_array_equal(got.vals, ref.vals, err_msg=f"{msg}: vals")


def inject_cuda_entries(eng):
    """Route a CPU engine through the dispatch table's CUDA entries; on
    CPU tensors every kernel wrapper runs its plain version."""
    eng._segsum = kops._keyed_segment_sum_cuda
    eng._union_reduce = kops._keyed_union_reduce_cuda
    eng._mul_reduce = kops._mul_reduce_cuda
    return eng


@pytest.mark.parametrize("name,expr,order,fmts,expected", CASES,
                         ids=[c[0] for c in CASES])
def test_custard_copies_lower_to_the_reference_graphs(name, expr, order,
                                                      fmts, expected):
    variants = [dict(loop_order=tuple(order)),
                dict(loop_order=tuple(order), split={order[0]: 2}),
                dict(loop_order=tuple(order), split={order[-1]: 2},
                     parallelize={order[-1]: 2}),
                # the lanes the engine runs: the outer variable by 4, and
                # two split variables with the outer one parallelized
                dict(loop_order=tuple(order), split={order[0]: 4},
                     parallelize={order[0]: 4})]
    if len(order) > 1:
        variants.append(dict(loop_order=tuple(order),
                             split={order[0]: 2, order[1]: 3},
                             parallelize={order[0]: 2}))
    for kw in variants:
        ref = r_lower(expr, RFormat(dict(fmts)), RSchedule(**kw), DIMS)
        got = lower(expr, Format(dict(fmts)), Schedule(**kw), DIMS)
        assert ([t.graph.structural_hash() for t in got.terms]
                == [t.graph.structural_hash() for t in ref.terms]), kw
        assert [t.lane_n for t in got.terms] == [t.lane_n
                                                 for t in ref.terms], kw
        assert got.par_n == ref.par_n and got.split_of == ref.split_of, kw
        assert ((got.graph is None) == (ref.graph is None)), kw
        if ref.graph is not None:
            assert got.graph.structural_hash() == ref.graph.structural_hash()
            assert got.graph.primitive_counts() == ref.graph.primitive_counts()
        assert got.result_vars == ref.result_vars and got.dims == ref.dims


@pytest.mark.parametrize("fmt", ["dd", "dc", "cd", "ss", "hh", "mm", "sh",
                                 "dm"])
def test_custard_copies_hash_format_variants(fmt):
    cases = [("X(i,j) = B(i,k) * C(k,j)", ("i", "k", "j"), frozenset()),
             ("X(i,j) = B(i,j) * C(i,j)", ("i", "j"),
              frozenset({("C", "j")}))]
    dims = {"i": 5, "j": 4, "k": 6}
    for expr, order, loc in cases:
        ref = r_lower(expr, RFormat({"B": fmt, "C": fmt}),
                      RSchedule(loop_order=order, locate=loc), dims)
        got = lower(expr, Format({"B": fmt, "C": fmt}),
                    Schedule(loop_order=order, locate=loc), dims)
        assert got.graph.structural_hash() == ref.graph.structural_hash()


# -- the multi-fiber locate fault of the reference ----------------------------

@pytest.mark.parametrize("c_fmt", ["dd", "dc", "cc"])
def test_locate_into_multi_fiber_level(c_fmt):
    expr = "X(i,j) = B(i,j) * C(i,j)"
    dims = {"i": 6, "j": 7}
    rng = np.random.default_rng(7)
    B = ((rng.random((6, 7)) < 0.6) * rng.integers(1, 9, (6, 7))).astype(
        float)
    C = ((rng.random((6, 7)) < 0.6) * rng.integers(1, 9, (6, 7))).astype(
        float)
    loc = frozenset({("C", "j")})
    got = CompiledExpr(expr, Format({"B": "cc", "C": c_fmt}),
                       Schedule(loop_order=("i", "j"), locate=loc), dims,
                       device=CPU)({"B": B, "C": C})
    np.testing.assert_array_equal(got.to_dense(), B * C)
    low = r_lower(expr, RFormat({"B": "cc", "C": c_fmt}),
                  RSchedule(loop_order=("i", "j"), locate=loc), dims)
    from repro.core.simulator import Simulator
    from test_split_golden import decode_writer_tokens
    res = Simulator(low.graph, low.build_inputs({"B": B, "C": C})).run()
    assert _as_dict(got, 2) == decode_writer_tokens(res, "X", ["i", "j"])


# -- compiled-engine behaviour (counterparts of test_compiled_engine.py) -------

EDIMS = {"i": 24, "j": 20, "k": 16}


def sparse(rng, shape, density=0.3):
    return ((rng.random(shape) < density)
            * rng.integers(1, 9, shape)).astype(float)


def fresh_values(rng, arrays):
    return {k: a if a.ndim == 0 else a * rng.integers(1, 9, a.shape)
            for k, a in arrays.items()}


@pytest.mark.parametrize("expr,fmts,n_terms", [
    ("x(i) = b(i) - C(i,j) * d(j)", {"b": "c", "C": "cc", "d": "c"}, 2),
    ("x(i) = alpha * Bt(i,j) * c(j) + beta * d(i)",
     {"Bt": "cc", "c": "c", "d": "c", "alpha": "", "beta": ""}, 2),
    ("X(i,j) = B(i,j) + C(i,j) + D(i,j)",
     {"B": "cc", "C": "cc", "D": "cc"}, 3)])
def test_multi_term_fuses_into_one_plan(expr, fmts, n_terms):
    eng = CompiledExpr(expr, Format(fmts), Schedule(loop_order=("i", "j")),
                       EDIMS, device=CPU)
    arrays = make_arrays(expr, EDIMS, seed=3, density=0.3)
    np.testing.assert_array_equal(eng(arrays).to_dense(),
                                  want_of(expr, arrays, EDIMS))
    assert len(eng.graphs) == n_terms
    assert eng.stats["traces"] == 1
    assert any("fused" in p.caps for p in eng._plans.values())


def test_cache_hit_no_rebuild_identical_results():
    rng = np.random.default_rng(11)
    eng = CompiledExpr("X(i,j) = B(i,k) * C(k,j)",
                       Format({"B": "cc", "C": "cc"}),
                       Schedule(loop_order=("i", "k", "j")), EDIMS,
                       device=CPU)
    arrays = {"B": sparse(rng, (24, 16)), "C": sparse(rng, (16, 20))}
    got1 = eng(arrays).to_dense()
    traces = eng.stats["traces"]
    np.testing.assert_array_equal(eng(arrays).to_dense(), got1)
    assert eng.stats["traces"] == traces and eng.stats["plan_hits"] >= 1
    arrays3 = fresh_values(rng, arrays)
    np.testing.assert_array_equal(eng(arrays3).to_dense(),
                                  arrays3["B"] @ arrays3["C"])
    assert eng.stats["traces"] == traces
    assert set(eng.stats) == {"traces", "plan_hits", "plan_misses",
                              "overflow_retries", "calls", "batch_calls",
                              "lane_dispatches", "sharded_dispatches"}


def test_compile_expr_returns_shared_engine():
    clear_compile_cache()
    fmt = Format({"B": "cc", "c": "c"})
    sch = Schedule(loop_order=("i", "j"))
    e1 = compile_expr("x(i) = B(i,j) * c(j)", fmt, sch, EDIMS, device=CPU)
    e2 = compile_expr("x(i) = B(i,j) * c(j)", fmt, sch, EDIMS, device="cpu")
    assert e1 is e2
    e3 = compile_expr("x(i) = B(i,j) * c(j)", fmt,
                      Schedule(loop_order=("i", "j"),
                               locate=frozenset({("c", "j")})), EDIMS,
                      device=CPU)
    assert e3 is not e1
    e4 = compile_expr("x(i) = B(i,j) * c(j)", fmt, sch, EDIMS,
                      use_kernels=False, device=CPU)
    assert e4 is not e1 and e4._mul_reduce is None


def test_cache_key_and_graph_hash_stability():
    fmt = Format({"B": "cc", "C": "cc"})
    sch = Schedule(loop_order=("i", "k", "j"))
    a = custard.parse("X(i,j) = B(i,k) * C(k,j)")
    assert (expr_cache_key(a, fmt, sch, EDIMS)
            == expr_cache_key(custard.parse("X(i,j) = B(i,k) * C(k,j)"),
                              fmt, sch, EDIMS))
    g1 = custard.compile_expr("X(i,j) = B(i,k) * C(k,j)", fmt, sch, EDIMS)
    g3 = custard.compile_expr("X(i,j) = B(i,k) * C(k,j)", fmt,
                              Schedule(loop_order=("i", "j", "k")), EDIMS)
    assert g1.structural_hash() != g3.structural_hash()


def test_overflow_grows_instead_of_truncating():
    dims = {"i": 16, "j": 16, "k": 16}
    eng = CompiledExpr("X(i,j) = B(i,k) * C(k,j)",
                       Format({"B": "cc", "C": "cc"}),
                       Schedule(loop_order=("i", "k", "j")), dims,
                       device=CPU)
    C = np.zeros((16, 16))
    C[:7, 0] = 1.0
    C[7, :8] = 1.0
    B1 = np.zeros((16, 16))
    B1[:8, 0] = 1.0
    np.testing.assert_array_equal(eng({"B": B1, "C": C}).to_dense(), B1 @ C)
    B2 = np.zeros((16, 16))
    B2[:8, 7] = 1.0
    np.testing.assert_array_equal(eng({"B": B2, "C": C}).to_dense(), B2 @ C)
    assert eng.stats["overflow_retries"] >= 1


def test_forced_tiny_capacity_regrows_and_rehits():
    rng = np.random.default_rng(5)
    dims = {"i": 16, "j": 12, "k": 10}
    eng = CompiledExpr("X(i,j) = B(i,k) * C(k,j)",
                       Format({"B": "cc", "C": "cc"}),
                       Schedule(loop_order=("i", "k", "j")), dims,
                       device=CPU)
    arrays = {"B": sparse(rng, (16, 10), 0.4), "C": sparse(rng, (10, 12), 0.4)}
    flat, sig = eng._pad_flat(eng._raw_flat(arrays))
    honest = eng._record_caps([flat])
    assert any(c > 8 for c in honest.values())
    eng._install_plan(sig, {k: 8 for k in honest})
    np.testing.assert_array_equal(eng(arrays).to_dense(),
                                  arrays["B"] @ arrays["C"])
    assert eng.stats["overflow_retries"] >= 1
    assert any(c > 8 for c in eng._plans[sig].caps.values())
    traces, retries = eng.stats["traces"], eng.stats["overflow_retries"]
    arrays2 = fresh_values(rng, arrays)
    np.testing.assert_array_equal(eng(arrays2).to_dense(),
                                  arrays2["B"] @ arrays2["C"])
    assert eng.stats["traces"] == traces
    assert eng.stats["overflow_retries"] == retries
    assert eng.stats["plan_hits"] >= 2


def test_larger_inputs_new_bucket_correct():
    rng = np.random.default_rng(8)
    eng = CompiledExpr("x(i) = B(i,j) * c(j)", Format({"B": "cc", "c": "c"}),
                       Schedule(loop_order=("i", "j")), EDIMS, device=CPU)
    small = {"B": sparse(rng, (24, 20), 0.1), "c": sparse(rng, 20, 0.5)}
    np.testing.assert_array_equal(eng(small).to_dense(),
                                  small["B"] @ small["c"])
    big = {"B": sparse(rng, (24, 20), 0.9), "c": sparse(rng, 20, 0.9)}
    np.testing.assert_array_equal(eng(big).to_dense(), big["B"] @ big["c"])
    assert eng.stats["plan_misses"] >= 2


def test_scalar_result_compiled():
    rng = np.random.default_rng(9)
    eng = CompiledExpr("x = B(i,j) * C(i,j)", Format({"B": "cc", "C": "cc"}),
                       Schedule(loop_order=("i", "j")), {"i": 12, "j": 10},
                       device=CPU)
    B, C = sparse(rng, (12, 10), 0.4), sparse(rng, (12, 10), 0.4)
    assert float(eng({"B": B, "C": C}).to_dense()) == float(np.sum(B * C))
    assert eng.execute_coo({"B": B, "C": C}) == (None, float(np.sum(B * C)))


def test_execute_expr_compiled_equals_eager():
    rng = np.random.default_rng(10)
    fmt = Format({"B": "cc", "C": "cc"})
    sch = Schedule(loop_order=("i", "j", "k"))
    arrays = {"B": sparse(rng, (24, 16)), "C": sparse(rng, (16, 20))}
    got_c = execute_expr("X(i,j) = B(i,k) * C(k,j)", fmt, sch, arrays,
                         EDIMS, compiled=True, device=CPU).to_dense()
    got_e = execute_expr("X(i,j) = B(i,k) * C(k,j)", fmt, sch, arrays,
                         EDIMS, compiled=False, device=CPU).to_dense()
    np.testing.assert_array_equal(got_c, got_e)
    np.testing.assert_array_equal(got_c, arrays["B"] @ arrays["C"])


def test_execute_coo_decodes_live_entries():
    rng = np.random.default_rng(12)
    eng = CompiledExpr("X(i,j) = B(i,k) * C(k,j)",
                       Format({"B": "cc", "C": "cc"}),
                       Schedule(loop_order=("i", "k", "j")), EDIMS,
                       device=CPU)
    arrays = {"B": sparse(rng, (24, 16)), "C": sparse(rng, (16, 20))}
    coords, vals = eng.execute_coo(arrays)
    dense = np.zeros((24, 20))
    dense[coords[:, 0], coords[:, 1]] = vals
    np.testing.assert_array_equal(dense, arrays["B"] @ arrays["C"])
    assert eng.orig_result_order == ["i", "j"]


# -- s/h/m ingest and the b refusal ------------------------------------------

def _unpack(ft):
    return dict(shape=ft.shape, mode_order=ft.mode_order, vals=ft.vals,
                levels=[{"format": lv.format, "dim": lv.dim, "seg": lv.seg,
                         "crd": lv.crd, "words": lv.words}
                        for lv in ft.levels])


@pytest.mark.parametrize("fmt", ["ss", "hh", "mm", "sh", "dm", "hc"])
def test_shm_operands_canonicalize_at_ingest(fmt):
    expr = "X(i,j) = B(i,k) * C(k,j)"
    dims = {"i": 6, "j": 70, "k": 5}
    arrays = make_arrays(expr, dims, seed=ord(fmt[0]) + ord(fmt[1]))
    order = ("i", "k", "j")
    rlow = r_lower(expr, RFormat({"B": fmt, "C": fmt}),
                   RSchedule(loop_order=order), dims)
    plow = lower(expr, Format({"B": fmt, "C": fmt}), Schedule(loop_order=order),
                 dims)
    assert plow.graph.structural_hash() == rlow.graph.structural_hash()
    # the same stored trees, carried across as plain arrays
    r_trees = rlow.build_inputs(arrays)
    p_trees = {k: tree_from_arrays(**_unpack(v)) for k, v in r_trees.items()}
    for k in r_trees:
        assert p_trees[k].format_str == r_trees[k].format_str == fmt
    want = arrays["B"] @ arrays["C"]
    got = execute_graph(plow.graph, p_trees, plow.dims, plow.result_vars,
                        device=CPU)["X"]
    ref = r_execute_graph(rlow.graph, r_trees, rlow.dims, rlow.result_vars)["X"]
    assert_same_tree(ref, got, fmt)
    np.testing.assert_array_equal(got.to_dense(), want)
    # and through the compiled entry, which builds its own trees
    eng = CompiledExpr(expr, Format({"B": fmt, "C": fmt}),
                       Schedule(loop_order=order), dims, device=CPU)
    np.testing.assert_array_equal(eng(arrays).to_dense(), want)


def test_bitvector_storage_is_refused():
    expr = "x(i) = b(i) * c(i)"
    dims = {"i": 70}
    arrays = make_arrays(expr, dims, seed=4)
    sch = Schedule(loop_order=("i",), bitvector=frozenset({"i"}))
    low = lower(expr, Format({"b": "b", "c": "b"}), sch, dims)
    trees = low.build_inputs(arrays)
    with pytest.raises(NotImplementedError, match="bitvector"):
        execute_graph(low.graph, trees, low.dims, low.result_vars,
                      device=CPU)
    with pytest.raises(NotImplementedError, match="bitvector"):
        JTensor.from_fibertree(trees["b"], CPU)
    # no block-sparse pattern (rank-1 result): the engine refuses the b
    # levels when it meets them, as the reference's does
    eng = compile_expr(expr, Format({"b": "b", "c": "b"}), sch, dims,
                       device=CPU)
    assert isinstance(eng, CompiledExpr)
    with pytest.raises(NotImplementedError, match="bitvector"):
        eng(arrays)


# -- paths once refused here now run: lanes over a lane mesh, tiles, "auto" -

@pytest.mark.parametrize("what", ["split", "parallelize", "tile", "auto",
                                  "mem_budget", "lower_auto",
                                  "lower_program"])
def test_unported_paths_raise_not_implemented(what, monkeypatch, tmp_path):
    # every path this test once saw refused now runs, and each case holds
    # its path against numpy: split and parallelize lanes spread over a
    # lane mesh (a CPU one of two here; shard_lanes True and 2 require
    # one), tiles, budgets and "auto" schedules
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("SAM_SCHEDULE_CACHE", str(tmp_path / "s.json"))
    expr = "x(i) = B(i,j) * c(j)"
    fmt = Format({"B": "cc", "c": "c"})
    dims = {"i": 4, "j": 6}
    base = dict(loop_order=("i", "j"))
    meshes = {
        "split": lambda: compile_expr(expr, fmt, Schedule(
            **base, split={"i": 2}, parallelize={"i": 2}), dims, device=CPU,
            shard_lanes=True),
        "parallelize": lambda: CompiledExpr(expr, fmt, Schedule(
            **base, split={"i": 2}, parallelize={"i": 2}), dims, device=CPU,
            shard_lanes=2),
    }
    if what in meshes:
        monkeypatch.setenv("SAM_LANE_DEVICES", "1")
        with pytest.raises(ValueError, match="cannot shard 2 lane"):
            meshes[what]()
        monkeypatch.setenv("SAM_LANE_DEVICES", "2")
    rng = np.random.default_rng(len(what))
    arrays = {"B": sparse(rng, (4, 6)), "c": sparse(rng, 6, 0.8)}
    want = arrays["B"] @ arrays["c"]
    if what == "lower_auto":
        low = lower(expr, fmt, "auto", dims)
        # the pick is cached: resolving again answers with the same one
        # (lower searches for the one device its lanes run on, whatever
        # the host's count)
        from repro_torch.core.autoschedule import resolve_schedule
        res = resolve_schedule(expr, fmt, dims, device_count=1)
        assert res.cache_hit and lower(expr, fmt, res.schedule, dims) is low
        got = simulate_expr(expr, fmt, res.schedule, arrays, dims).dense
    elif what == "lower_program":
        text = "T(i,j) = B(i,k) * C(k,j); A(i,j) = T(i,k) * E(k,j)"
        pdims = {"i": 4, "j": 4, "k": 4}
        lp = custard.lower_program(text, Format(default="c"), "auto", pdims)
        parrays = {t: sparse(rng, (4, 4), 0.5) for t in "BCE"}
        out = compile_program(text, Format(default="c"), "auto", pdims,
                              device=CPU)(parrays)
        assert [s.schedule for s in lp.stages] == [
            s.schedule for s in compile_program(
                text, Format(default="c"), "auto", pdims,
                device=CPU).lp.stages]
        got, want = out["A"].to_dense(), numpy_reference(text, parrays)["A"]
    elif what in meshes:
        eng = meshes[what]()
        got = eng(arrays).to_dense()
        assert eng._lane_mesh == 2
        assert eng.stats["sharded_dispatches"] == 1
    else:
        eng = {"tile": lambda: compile_expr(
                   expr, fmt, Schedule(**base, tile={"j": 2}), dims,
                   device=CPU),
               "auto": lambda: compile_expr(expr, fmt, "auto", dims,
                                            device=CPU),
               "mem_budget": lambda: compile_expr(
                   expr, fmt, Schedule(**base), dims, device=CPU,
                   mem_budget=estimate_call_bytes(
                       expr, fmt, Schedule(**base), dims) * 3 // 4)}[what]()
        assert isinstance(eng, TiledExpr) == (what != "auto")
        got = eng(arrays).to_dense()
    np.testing.assert_array_equal(got, want)


def test_execute_expr_split_falls_back_to_eager():
    # a split and tiled schedule runs compiled, through a TiledExpr over a
    # split per-tile engine (the eager path, which strips the tiles and
    # unsplits the result, is the fallback for what the engine refuses)
    rng = np.random.default_rng(13)
    arrays = {"B": sparse(rng, (4, 6)), "c": sparse(rng, 6, 0.8)}
    got = execute_expr("x(i) = B(i,j) * c(j)", Format({"B": "cc", "c": "c"}),
                       Schedule(loop_order=("i", "j"), split={"j": 2},
                                tile={"i": 2}),
                       arrays, {"i": 4, "j": 6}, device=CPU)
    np.testing.assert_array_equal(got.to_dense(), arrays["B"] @ arrays["c"])
