"""The port's program layer against the reference's.

* The copies of ``program`` and ``simulator`` parse, lower, decide fusion,
  key and simulate every program of ``tests/test_program.py`` (plus the
  GAT-style SDDMM→SpMM and ``MOE_PROGRAM``) exactly as the reference does:
  the same ``FusionDecision``s, cache keys, components, stage-graph
  structural hashes, simulated cycles and dense results.
* ``compile_program(..., device="cpu")`` returns the same FiberTrees
  (dense equal, exactly, on integer data) and the same ``stats`` as the
  reference's ``compile_program``, fused and unfused, and equals
  ``numpy_reference``. Each reference program is compiled once per module.
* The ``coo_to_levels`` wrapper on CPU tensors (its plain version) equals
  the reference's ``coord_ops.coo_to_levels`` bit for bit, dtypes
  included, also beyond the TPU kernel's guards (capacities above 4096, a
  level extent of 2**24 and more), and under capacity overflow.
* ``"auto"`` schedules (for the program or one stage) and a program
  under ``mem_budget`` (its over-budget unfused stage a ``TiledExpr``)
  equal numpy and the unfused program; a split stage runs unfused and
  equals the unsplit program; a tiled simulation gives the reference's
  cycles.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings
except ImportError:
    from _hypothesis_stub import given, settings

from test_kernel_conformance import coo_levels_case  # noqa: E402

from repro.core import coord_ops as rco  # noqa: E402
from repro.core import jax_backend as rjb  # noqa: E402
from repro.core import program as rprog  # noqa: E402
from repro.core import simulator as rsimulator  # noqa: E402
from repro.core.schedule import Format as RFormat  # noqa: E402
from repro.core.schedule import Schedule as RSchedule  # noqa: E402
from repro.models import moe_blocks  # noqa: E402
from repro_torch.core import program as prog  # noqa: E402
from repro_torch.core import torch_backend as tb  # noqa: E402
from repro_torch.core.custard import (  # noqa: E402
    lower_program as custard_lower_program)
from repro_torch.core.schedule import Format, Schedule  # noqa: E402
from repro_torch.core.simulator import simulate_expr  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.coo_levels import coo_to_levels  # noqa: E402

CPU = "cpu"
SDDMM_SPMM = ("T(i,j) = B(i,j) * C(i,k) * D(j,k); "
              "A(i,j) = T(i,k) * E(k,j)")
GAT = ("T(i,j) = B(i,j) * C(i,f) * D(j,f); "
       "A(i,g) = T(i,j) * E(j,g)")


def sparse(shape, density=0.3, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) < density)
            * rng.integers(1, 9, shape)).astype(float)


def _moe_arrays():
    rng = np.random.default_rng(33)
    e, cap, t, d, f = 3, 2, 5, 2, 3
    G, S, _ = moe_blocks.routing_tensors(np.ones((t, 2)),
                                         rng.integers(0, e, (t, 2)), e, cap)
    return {"G": G, "S": S,
            "X": rng.integers(-3, 4, (t, d)).astype(float),
            "Wu": rng.integers(-2, 3, (e, d, f)).astype(float),
            "Wd": rng.integers(-2, 3, (e, f, d)).astype(float)}


def _gat_arrays(n=10, f=4):
    rng = np.random.default_rng(11)
    adj = (rng.random((n, n)) < 0.3) * rng.integers(-3, 4, (n, n))
    return {"B": adj.astype(float),
            **{t: rng.integers(-3, 4, (n, f)).astype(float) for t in "CDE"}}


# name -> (text, formats, default format, loop orders, dims, arrays)
CASES = {
    "sddmm_spmm": (SDDMM_SPMM, {}, "c",
                   {"T": "ijk", "A": "ikj"}, {"i": 12, "j": 12, "k": 12},
                   lambda: {t: sparse((12, 12), seed=i)
                            for i, t in enumerate("BCDE")}),
    "three_stage": ("T(i,k) = B(i,j) * C(j,k); U(i,m) = T(i,k) * D(k,m); "
                    "x(i) = U(i,m) * e(m)", {}, "c",
                    {"T": "ijk", "U": "ikm", "x": "im"},
                    {"i": 8, "j": 8, "k": 8, "m": 8},
                    lambda: {"B": sparse((8, 8), seed=1),
                             "C": sparse((8, 8), seed=2),
                             "D": sparse((8, 8), seed=3),
                             "e": sparse((8,), seed=4)}),
    "negative_sign": ("T(i,k) = -B(i,j) * C(j,k); x(i) = T(i,k) * d(k)",
                      {}, "c", {"T": "ijk", "x": "ik"},
                      {"i": 6, "j": 6, "k": 6},
                      lambda: {"B": sparse((6, 6), seed=5),
                               "C": sparse((6, 6), seed=6),
                               "d": sparse((6,), seed=7)}),
    "interleaved": ("T(i,k) = B(i,j) * C(j,k); U(k,m) = D(k,m) * F(k,m); "
                    "A(i,m) = T(i,k) * U(k,m)", {}, "c",
                    {"T": "ijk", "U": "km", "A": "ikm"},
                    {"i": 6, "j": 6, "k": 6, "m": 6},
                    lambda: {t: sparse((6, 6), seed=i)
                             for i, t in enumerate("BCDF")}),
    "scalar_intermediate": ("s = b(i) * c(i); x(j) = s * d(j)", {"s": ""},
                            "c", {"s": "i", "x": "j"}, {"i": 5, "j": 4},
                            lambda: {"b": sparse((5,), seed=1),
                                     "c": sparse((5,), seed=2),
                                     "d": sparse((4,), seed=3)}),
    "multi_consumer": ("T(i,j) = B(i,k) * C(k,j); X(i,j) = T(i,j) * D(i,j); "
                       "Y(i,j) = T(i,j) * E(i,j)", {}, "c",
                       {"T": "ikj", "X": "ij", "Y": "ij"},
                       {"i": 6, "j": 6, "k": 6},
                       lambda: {t: sparse((6, 6), seed=i)
                                for i, t in enumerate("BCDE")}),
    "dense_intermediate": (SDDMM_SPMM, {"T": "dc"}, "c",
                           {"T": "ijk", "A": "ikj"},
                           {"i": 12, "j": 12, "k": 12}, None),
    "broken_scan_chain": (SDDMM_SPMM, {}, "c", {"T": "ijk", "A": "ijk"},
                          {"i": 12, "j": 12, "k": 12}, None),
    "discordant_modes": (SDDMM_SPMM, {}, "c", {"T": "ijk", "A": "kij"},
                         {"i": 12, "j": 12, "k": 12}, None),
    "moe": (moe_blocks.MOE_PROGRAM, dict(moe_blocks.moe_formats().formats),
            None,
            {k: "".join(s.loop_order)
             for k, s in moe_blocks.moe_schedules().items()},
            moe_blocks.moe_dims(3, 2, 5, 2, 3), _moe_arrays),
    "gat": (GAT, {"B": "cc", "T": "cc", "C": "dd", "D": "dd", "E": "dd",
                  "A": "dd"}, None, {"T": "ijf", "A": "ijg"},
            {"i": 10, "j": 10, "f": 4, "g": 4}, _gat_arrays),
}
EXECUTED = ["sddmm_spmm", "three_stage", "negative_sign", "interleaved",
            "scalar_intermediate", "moe", "gat"]


def _fmt(cls, formats, default):
    return cls(dict(formats)) if default is None else cls(dict(formats),
                                                          default=default)


def _schedules(cls, orders):
    return {k: cls(loop_order=tuple(o)) for k, o in orders.items()}


def both(name):
    """(reference args, port args) of one case: text, fmt, schedules,
    dims."""
    text, formats, default, orders, dims, _ = CASES[name]
    return ((text, _fmt(RFormat, formats, default),
             _schedules(RSchedule, orders), dims),
            (text, _fmt(Format, formats, default),
             _schedules(Schedule, orders), dims))


def _decisions(lp):
    return [(d.tensor, d.producer, d.consumer, d.fused, d.reason)
            for d in lp.decisions]


def _hashes(lp):
    return [[t.graph.structural_hash() for t in s.lowered.require_terms()]
            for s in lp.stages]


# -- the copies equal the reference --------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("fuse", [True, False])
def test_lowering_equals_reference(name, fuse):
    (rt, rf, rs, dims), (pt, pf, ps, _) = both(name)
    rp, pp = rprog.parse_program(rt), prog.parse_program(pt)
    assert (pp.names, pp.inputs, pp.intermediates, pp.outputs) == (
        rp.names, rp.inputs, rp.intermediates, rp.outputs)
    assert [pp.dependencies(i) for i in range(len(pp.assigns))] == [
        rp.dependencies(i) for i in range(len(rp.assigns))]
    rlp = rprog.lower_program(rt, rf, rs, dims, fuse=fuse)
    plp = prog.lower_program(pt, pf, ps, dims, fuse=fuse)
    assert _decisions(plp) == _decisions(rlp)
    assert plp.components() == rlp.components()
    assert prog.program_cache_key(plp) == rprog.program_cache_key(rlp)
    assert _hashes(plp) == _hashes(rlp)
    assert [(s.fused_inputs, s.fused_output) for s in plp.stages] == [
        (s.fused_inputs, s.fused_output) for s in rlp.stages]
    # custard's wrapper delegates to the same lowering
    assert _decisions(custard_lower_program(pt, pf, ps, dims,
                                            fuse=fuse)) == _decisions(rlp)


@pytest.mark.parametrize("name", ["sddmm_spmm", "three_stage"])
@pytest.mark.parametrize("fuse", [True, False])
def test_simulate_program_equals_reference(name, fuse):
    (rt, rf, rs, dims), (pt, pf, ps, _) = both(name)
    arrays = CASES[name][5]()
    ref = rprog.simulate_program(rt, rf, rs, dims, arrays, fuse=fuse)
    got = prog.simulate_program(pt, pf, ps, dims, arrays, fuse=fuse)
    assert got.cycles == ref.cycles
    assert got.component_cycles == ref.component_cycles
    assert sorted(got.dense) == sorted(ref.dense)
    for k in ref.dense:
        np.testing.assert_array_equal(got.dense[k], ref.dense[k], err_msg=k)
    assert [s.work for s in got.stages] == [s.work for s in ref.stages]


# -- execution equals the reference --------------------------------------

_REF_RUNS = {}


def reference_run(name, fuse):
    """The reference's outputs and stats after two calls (compiled once per
    module: the reference's first call spends seconds in XLA)."""
    key = (name, fuse)
    if key not in _REF_RUNS:
        (rt, rf, rs, dims), _ = both(name)
        arrays = CASES[name][5]()
        rjb.clear_compile_cache()
        rjb.clear_program_cache()
        cp = rjb.compile_program(rt, rf, rs, dims, fuse=fuse)
        first = cp(arrays)
        cp(arrays)
        _REF_RUNS[key] = (
            {k: ft.to_dense() for k, ft in first.items()}, dict(cp.stats),
            [dict(u.stats) for _, _, u in cp.units])
    return _REF_RUNS[key]


def _fresh_port_program(name, fuse, **kw):
    tb.clear_compile_cache()
    tb.clear_program_cache()
    _, (pt, pf, ps, dims) = both(name)
    return tb.compile_program(pt, pf, ps, dims, fuse=fuse, device=CPU, **kw)


@pytest.mark.parametrize("name,fuse", [(n, True) for n in EXECUTED]
                         + [("sddmm_spmm", False), ("gat", False)])
def test_compile_program_equals_reference(name, fuse):
    ref_out, ref_stats, ref_unit_stats = reference_run(name, fuse)
    arrays = CASES[name][5]()
    cp = _fresh_port_program(name, fuse)
    out = cp(arrays)
    cp(arrays)
    assert sorted(out) == sorted(ref_out)
    want = rprog.numpy_reference(CASES[name][0], arrays)
    for k, ft in out.items():
        np.testing.assert_array_equal(ft.to_dense(), ref_out[k], err_msg=k)
        np.testing.assert_array_equal(ft.to_dense(), want[k], err_msg=k)
    assert cp.stats == ref_stats
    assert [dict(u.stats) for _, _, u in cp.units] == ref_unit_stats
    assert cp.device == torch.device(CPU)


@pytest.mark.parametrize("name", ["three_stage", "negative_sign", "moe"])
def test_unfused_program_equals_numpy(name):
    arrays = CASES[name][5]()
    cp = _fresh_port_program(name, False)
    out = cp(arrays)
    want = rprog.numpy_reference(CASES[name][0], arrays)
    assert cp.stats["fused_stages"] == 0
    assert sorted(out) == sorted(k for k in want if k not in arrays)
    for k, ft in out.items():
        np.testing.assert_array_equal(ft.to_dense(), want[k], err_msg=k)


def test_compiled_program_plan_cache_and_overflow_growth():
    arrays = CASES["sddmm_spmm"][5]()
    cp = _fresh_port_program("sddmm_spmm", True)
    chain = next(u for k, _, u in cp.units if k == "chain")
    before = dict(chain.stats)
    cp(arrays)
    cp(arrays)
    assert chain.stats["plan_misses"] == before["plan_misses"] + 1
    assert chain.stats["plan_hits"] >= before["plan_hits"] + 1
    # denser data under the same dims: exact (grown or re-planned, never
    # truncated)
    dense_arrays = {t: sparse((12, 12), density=0.95, seed=i)
                    for i, t in enumerate("BCDE")}
    ref = rprog.numpy_reference(SDDMM_SPMM, dense_arrays)
    np.testing.assert_array_equal(cp(dense_arrays)["A"].to_dense(), ref["A"])


def test_forced_tiny_chain_capacities_regrow_and_rehit():
    """Capacities of 8 everywhere, the intermediate's levels included:
    the coo_to_levels counts report the overflow, the chain grows, and the
    result stays exact; the grown plan then serves fresh values."""
    arrays = CASES["sddmm_spmm"][5]()
    cp = _fresh_port_program("sddmm_spmm", True)
    chain = next(u for k, _, u in cp.units if k == "chain")
    flat, sig = tb._pad_flat_arrays(chain._raw_flat(arrays),
                                    chain._level_meta)
    honest = chain._record_caps(flat)
    assert honest["s0.lv1"] > 8
    chain._install_plan(sig, {k: 8 for k in honest})
    want = rprog.numpy_reference(SDDMM_SPMM, arrays)["A"]
    np.testing.assert_array_equal(cp(arrays)["A"].to_dense(), want)
    assert chain.stats["overflow_retries"] >= 1
    assert chain._plans[sig].caps["s0.lv1"] > 8
    retries = chain.stats["overflow_retries"]
    arrays2 = dict(arrays, E=2 * arrays["E"])
    np.testing.assert_array_equal(cp(arrays2)["A"].to_dense(), 2 * want)
    assert chain.stats["overflow_retries"] == retries


def test_compile_program_is_cached_and_keyed_on_fusion():
    tb.clear_program_cache()
    _, (pt, pf, ps, dims) = both("sddmm_spmm")
    a = tb.compile_program(pt, pf, ps, dims, device=CPU)
    b = tb.compile_program(pt, pf, ps, dims, device=CPU)
    c = tb.compile_program(pt, pf, ps, dims, fuse=False, device=CPU)
    d = tb.compile_program(pt, pf, ps, dims, use_kernels=False, device=CPU)
    assert a is b and a is not c and a is not d
    assert a.cache_key != c.cache_key   # fusion plan is part of the key
    lp = prog.lower_program(pt, pf, ps, dims)
    assert "fuse=T:1" in prog.program_cache_key(lp)
    tb.clear_program_cache()
    assert tb.compile_program(pt, pf, ps, dims, device=CPU) is not a


def test_program_chain_resolves_the_dispatch_entries():
    cp = _fresh_port_program("sddmm_spmm", True)
    chain = next(u for k, _, u in cp.units if k == "chain")
    assert chain._coo_levels is kops.sam_primitive("coo_to_levels", CPU)
    assert chain._segsum is kops.sam_primitive("keyed_segment_sum", CPU)
    assert chain._intersect is kops.sam_primitive("sorted_intersect", CPU)


# -- "auto" programs, budgets and tiled simulation (once refused) --------

def test_refusals_name_their_slice(tmp_path, monkeypatch):
    # "auto" schedules, a program under a budget and a tiled simulation
    # were refused until tiles and the autoscheduler were ported: each now
    # runs and is held to the unfused program, numpy and the reference
    monkeypatch.setenv("SAM_SCHEDULE_CACHE", str(tmp_path / "s.json"))
    _, (pt, pf, ps, dims) = both("sddmm_spmm")
    arrays = CASES["sddmm_spmm"][5]()
    want = tb.compile_program(pt, pf, ps, dims, fuse=False,
                              device=CPU)(arrays)
    ref = prog.numpy_reference(pt, arrays)
    for name in want:
        np.testing.assert_array_equal(want[name].to_dense(), ref[name])
    for sch in ("auto", {"T": "auto", "A": ps["A"]}):
        got = tb.compile_program(pt, pf, sch, dims, device=CPU)(arrays)
        assert sorted(got) <= sorted(want)
        for name in got:
            np.testing.assert_array_equal(got[name].to_dense(), ref[name])
    from repro_torch.core import tiling
    est = tiling.estimate_call_bytes(prog.parse_program(pt).assigns[0], pf,
                                     ps["T"], dims)
    cp = tb.compile_program(pt, pf, ps, dims, fuse=False, mem_budget=est // 2,
                            device=CPU)
    assert any(isinstance(u, tb.TiledExpr) for _, _, u in cp.units)
    got = cp(arrays)
    for name in want:
        np.testing.assert_array_equal(got[name].to_dense(),
                                      want[name].to_dense())
    # a split stage is ported: it cannot fuse, so it runs as its own
    # CompiledExpr and gives the unfused unsplit program's results
    split = {"T": Schedule(loop_order=("i", "j", "k"), split={"i": 2}),
             "A": ps["A"]}
    got = tb.compile_program(pt, pf, split, dims, device=CPU)(arrays)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name].to_dense(),
                                      want[name].to_dense())
    sim = simulate_expr("x(i) = B(i,j) * c(j)", Format({"B": "cc"}),
                        Schedule(loop_order=("i", "j"), tile={"j": 3}),
                        {"B": np.eye(2, 3), "c": np.ones(3)},
                        {"i": 2, "j": 3})
    rsim = rsimulator.simulate_expr(
        "x(i) = B(i,j) * c(j)", RFormat({"B": "cc"}),
        RSchedule(loop_order=("i", "j"), tile={"j": 3}),
        {"B": np.eye(2, 3), "c": np.ones(3)}, {"i": 2, "j": 3})
    assert (sim.cycles, sim.tiles) == (rsim.cycles, rsim.tiles) and \
        sim.tiles == 3
    np.testing.assert_array_equal(sim.dense, [1.0, 1.0])


# -- coo_to_levels -------------------------------------------------------

def _check_levels(dims, keys, caps=None, pad=2):
    nnz = len(keys)
    cap = max(8, nnz + pad)
    padded = np.full(cap, rco.PAD_KEY, np.int64)
    padded[:nnz] = keys
    valid = np.arange(cap) < nnz
    caps = caps or [cap] * len(dims)
    ref = rco.coo_to_levels(jnp.asarray(padded), jnp.asarray(valid),
                            list(dims), caps)
    got = coo_to_levels(torch.as_tensor(padded), torch.as_tensor(valid),
                        list(dims), caps)
    for lvl in range(len(dims)):
        for part, dtype in ((0, torch.int32), (1, torch.int32),
                            (2, torch.int64)):
            g = got[part][lvl]
            assert g.dtype == dtype, (part, lvl)
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(ref[part][lvl]),
                                          err_msg=f"part {part} level {lvl}")
    return [int(c) for c in got[2]]


@settings(max_examples=12, deadline=None)
@given(coo_levels_case())
def test_coo_to_levels_wrapper_matches_reference(case):
    _check_levels(*case)


def test_coo_to_levels_edges_beyond_the_tpu_guards():
    _check_levels((4, 5), np.zeros(0, np.int64))                  # empty
    _check_levels((4,), np.asarray([2], np.int64))                # one row
    _check_levels((6, 5, 4), np.arange(120, dtype=np.int64))      # dense
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(0, 64 * 200, 6000)).astype(np.int64)
    _check_levels((64, 200), keys)                          # caps > 4096
    big = 1 << 24                                           # extent >= 2**24
    _check_levels((3, big + 2), np.asarray([0, big + 1, 2 * (big + 2) + 5],
                                           np.int64))
    _check_levels((big, 8), np.asarray([7, 8 * (big - 1) + 3], np.int64))


@pytest.mark.parametrize("seed", range(3))
def test_coo_to_levels_counts_are_exact_under_overflow(seed):
    rng = np.random.default_rng(seed)
    dims = (6, 7, 5)
    keys = np.unique(rng.integers(0, 210, 80)).astype(np.int64)
    p1 = np.unique(keys // 5)
    honest = [len(np.unique(p1 // 7)), len(p1), len(keys)]
    counts = _check_levels(dims, keys, caps=[c // 2 for c in honest])
    assert counts == honest
