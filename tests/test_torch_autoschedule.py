"""``schedule="auto"`` in the port, against the reference.

* The copy ``repro_torch.core.autoschedule`` against the reference's
  ``repro.core.autoschedule``: ``enumerate_space`` (with and without
  format choices), ``analytic_cost``, ``search`` rankings (spec keys,
  cycles, analytic costs; under a budget too) and ``auto_cache_key`` are
  equal at ``device_count`` 1 and 4.
* ``compile_expr``, ``lower`` and ``compile_program`` with ``"auto"``
  pick what the reference picks, each package with its own temporary
  cache file, and the port's engines give numpy's result.
* The copy's default cache file differs from the reference's.
* The port's legs of ``tests/test_autoschedule.py`` (the serving smoke
  waits for the serving slice) and of the format-search tests of
  ``tests/test_format_conformance.py``.

Integer-valued data, so every comparison is exact.
"""
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

try:
    from hypothesis import given, settings, strategies as hst
except ImportError:  # clean checkout: deterministic stub keeps tests running
    from _hypothesis_stub import given, settings, strategies as hst

from repro.core import autoschedule as ra  # noqa: E402
from repro.core import custard as rcustard  # noqa: E402
from repro.core import program as rprog  # noqa: E402
from repro.core.einsum import parse as rparse  # noqa: E402
from repro.core.schedule import Format as RFormat  # noqa: E402
from repro_torch.core import autoschedule as a  # noqa: E402
from repro_torch.core import torch_backend as tb  # noqa: E402
from repro_torch.core.autoschedule import (FORMAT_CHOICES,  # noqa: E402
                                           CandidateSpec, ScheduleCache,
                                           auto_cache_key, enumerate_space,
                                           resolve_densities,
                                           resolve_schedule, search)
from repro_torch.core.custard import clear_lowering_cache, lower  # noqa: E402
from repro_torch.core.einsum import parse  # noqa: E402
from repro_torch.core.fibertree import spec_of  # noqa: E402
from repro_torch.core.program import numpy_reference  # noqa: E402
from repro_torch.core.schedule import (Format, Schedule,  # noqa: E402
                                       schedule_from_dict, schedule_to_dict,
                                       split_dims)
from repro_torch.core.simulator import (downsample_operands,  # noqa: E402
                                        sampled_cycles, simulate_expr)

CPU = "cpu"
EXPR = "X(i,j) = B(i,k) * C(k,j)"
FMT = Format({"B": "cc", "C": "cc"})
RFMT = RFormat({"B": "cc", "C": "cc"})


def _spmspm(i, j, k, density=0.05, seed=7):
    rng = np.random.default_rng(seed)
    B = ((rng.random((i, k)) < density)
         * rng.integers(1, 9, (i, k))).astype(float)
    C = ((rng.random((k, j)) < density)
         * rng.integers(1, 9, (k, j))).astype(float)
    return {"B": B, "C": C}, {"i": i, "j": j, "k": k}


def _ranking(rep):
    return [(c.spec.key(), c.cycles, c.analytic) for c in rep.candidates]


@pytest.fixture(autouse=True)
def _own_cache(tmp_path, monkeypatch):
    """Every test resolves against a temporary cache file, never a
    user's."""
    monkeypatch.setenv("SAM_SCHEDULE_CACHE", str(tmp_path / "port.json"))
    a.clear_resolution_memo()
    ra.clear_resolution_memo()
    yield
    a.clear_resolution_memo()
    ra.clear_resolution_memo()


# ---------------------------------------------------------------------------
# the copy against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("devices", [1, 4])
@pytest.mark.parametrize("formats", [None, FORMAT_CHOICES])
def test_enumeration_and_analytic_cost_equal_reference(devices, formats):
    dims = {"i": 16, "j": 16, "k": 8}
    specs = enumerate_space(parse(EXPR), dims, device_count=devices,
                            fmt=FMT, format_choices=formats)
    rspecs = ra.enumerate_space(rparse(EXPR), dims, device_count=devices,
                                fmt=RFMT, format_choices=formats)
    assert [s.key() for s in specs] == [s.key() for s in rspecs]
    dens = resolve_densities(parse(EXPR), 0.05)
    assert dens == ra.resolve_densities(rparse(EXPR), 0.05)
    for s, rs in zip(specs, rspecs):
        assert a.analytic_cost(parse(EXPR), FMT, dims, s, dens) == \
            ra.analytic_cost(rparse(EXPR), RFMT, dims, rs, dens)


@pytest.mark.parametrize("devices", [1, 4])
@pytest.mark.parametrize("case", ["arrays", "hint", "budget", "formats"])
def test_search_ranking_equals_reference(case, devices):
    arrays, dims = _spmspm(40, 36, 24, density=0.1)
    kw = {"device_count": devices}
    fmt, rfmt = FMT, RFMT
    if case == "arrays":
        kw["arrays"] = arrays
    elif case == "hint":
        kw["sparsity"] = {"B": 0.1, "C": 0.3}
    elif case == "budget":
        fmt, rfmt = Format({"B": "cc", "C": "dd"}), RFormat({"B": "cc",
                                                             "C": "dd"})
        kw["sparsity"] = {"B": 0.1, "C": 1.0}
        from repro_torch.core import tiling
        kw["mem_budget"] = tiling.estimate_call_bytes(
            EXPR, fmt, Schedule(loop_order=("i", "k", "j")), dims,
            densities=kw["sparsity"]) // 3
        kw["max_orders"] = 3
    else:
        kw["arrays"] = arrays
        kw["format_choices"] = ("c", "m")
        kw["max_orders"] = 2
    rep = search(EXPR, fmt, dims, **kw)
    want = ra.search(EXPR, rfmt, dims, **kw)
    assert _ranking(rep) == _ranking(want)
    assert (rep.enumerated, rep.simulated, rep.sample_dims,
            rep.orders_truncated) == (want.enumerated, want.simulated,
                                      want.sample_dims, want.orders_truncated)
    assert rep.expr == want.expr
    if case == "budget":
        assert all(c.spec.tile for c in rep.candidates)


@pytest.mark.parametrize("devices", [1, 4])
def test_auto_cache_key_equals_reference(devices):
    for expr in (EXPR, "x(i) = b(i) - C(i,j) * d(j)",
                 "X(i,j) = B(i,k) * C(k,j) + D(i,j)"):
        dens = resolve_densities(parse(expr), 0.05)
        for dims in ({"i": 100, "j": 60, "k": 7}, {"i": 4096, "j": 1,
                                                    "k": 3}):
            got = auto_cache_key(parse(expr), FMT, dims, dens, devices)
            want = ra.auto_cache_key(rparse(expr), RFMT, dims, dens, devices)
            assert got == want


def test_default_cache_path_differs_from_reference(monkeypatch):
    monkeypatch.delenv("SAM_SCHEDULE_CACHE")
    port, ref = a.default_cache_path(), ra.default_cache_path()
    assert port != ref
    assert os.path.dirname(port) == os.path.dirname(ref)
    assert os.path.basename(port) == f"schedules-torch-v{a.CACHE_VERSION}.json"
    assert a.CACHE_VERSION == ra.CACHE_VERSION
    monkeypatch.setenv("SAM_SCHEDULE_CACHE", "/somewhere/shared.json")
    assert a.default_cache_path() == ra.default_cache_path()


def test_device_count_defaults_to_cuda_devices(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert a._device_count() == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert a._device_count() == 4
    specs = enumerate_space(parse(EXPR), {"i": 16, "j": 16, "k": 8})
    assert max(s.lanes for s in specs) == 4


def test_every_auto_entry_searches_for_one_device(tmp_path, monkeypatch):
    """The port runs an expression's and a program stage's lanes on one
    device, so ``compile_expr``, ``lower`` and ``compile_program`` all
    search with ``device_count=1`` even where four GPUs are visible: one
    expression gets one pick under one cache key through each."""
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    arrays, dims = _spmspm(16, 16, 8, density=0.3, seed=11)
    want = ra.resolve_schedule(EXPR, RFMT, dims, cache=False,
                               device_count=1).schedule
    key = auto_cache_key(parse(EXPR), FMT, dims,
                         resolve_densities(parse(EXPR), None, None), 1)
    picks = [tb.compile_expr(EXPR, FMT, "auto", dims, device=CPU).schedule,
             lower(EXPR, FMT, "auto", dims).schedule]
    a.clear_resolution_memo()
    os.remove(os.environ["SAM_SCHEDULE_CACHE"])
    cp = tb.compile_program(EXPR, FMT, "auto", dims, device=CPU)
    picks.append(cp.lp.stages[0].schedule)
    for pick in picks:
        assert schedule_to_dict(pick) == ra.schedule_to_dict(want)
    with open(os.environ["SAM_SCHEDULE_CACHE"]) as f:
        text = f.read()
    assert key in text and "devices=4" not in text
    assert resolve_schedule(EXPR, FMT, dims, device_count=1).cache_hit
    np.testing.assert_array_equal(cp(arrays)["X"].to_dense(),
                                  arrays["B"] @ arrays["C"])


def _ref_pick(monkeypatch, tmp_path, fn):
    """Run the reference's resolution against its own cache file."""
    monkeypatch.setenv("SAM_SCHEDULE_CACHE", str(tmp_path / "ref.json"))
    try:
        return fn()
    finally:
        monkeypatch.setenv("SAM_SCHEDULE_CACHE", str(tmp_path / "port.json"))


@pytest.mark.parametrize("case", ["plain", "sparsity", "budget"])
def test_compile_expr_auto_picks_what_the_reference_picks(case, tmp_path,
                                                          monkeypatch):
    arrays, dims = _spmspm(24, 20, 16, density=0.3, seed=len(case))
    fmt, rfmt = FMT, RFMT
    kw, rkw = {}, {"device_count": 1}
    if case == "sparsity":
        kw["sparsity"] = rkw["sparsity"] = 0.3
    elif case == "budget":
        fmt, rfmt = Format({"B": "cc", "C": "dd"}), RFormat({"B": "cc",
                                                             "C": "dd"})
        from repro_torch.core import tiling
        kw["sparsity"] = rkw["sparsity"] = {"B": 0.3, "C": 1.0}
        kw["mem_budget"] = rkw["mem_budget"] = tiling.estimate_call_bytes(
            EXPR, fmt, Schedule(loop_order=("i", "k", "j")), dims,
            densities=kw["sparsity"]) // 4
    eng = tb.compile_expr(EXPR, fmt, "auto", dims, device=CPU, **kw)
    want = _ref_pick(monkeypatch, tmp_path, lambda: ra.resolve_schedule(
        EXPR, rfmt, dims, **rkw).schedule)
    assert schedule_to_dict(eng.schedule) == ra.schedule_to_dict(want)
    if case == "budget":
        assert isinstance(eng, tb.TiledExpr) and eng.n_tiles > 1
    np.testing.assert_array_equal(eng(arrays).to_dense(),
                                  arrays["B"] @ arrays["C"])
    # the pick is cached: the same call hits the same engine
    assert tb.compile_expr(EXPR, fmt, "auto", dims, device=CPU, **kw) is eng


def test_lower_auto_picks_what_the_reference_picks(tmp_path, monkeypatch):
    arrays, dims = _spmspm(12, 12, 8, density=0.3)
    low = lower(EXPR, FMT, "auto", dims)
    rlow = _ref_pick(monkeypatch, tmp_path,
                     lambda: rcustard.lower(EXPR, RFMT, "auto", dims))
    assert schedule_to_dict(low.schedule) == ra.schedule_to_dict(
        rlow.schedule)
    assert low.graph.structural_hash() == rlow.graph.structural_hash()
    res = simulate_expr(EXPR, FMT, low.schedule, arrays, dims)
    np.testing.assert_array_equal(res.dense, arrays["B"] @ arrays["C"])


def test_compile_program_auto_picks_what_the_reference_picks(tmp_path,
                                                             monkeypatch):
    text = "T(i,k) = B(i,j) * C(j,k); x(i) = T(i,k) * d(k)"
    rng = np.random.default_rng(4)
    arrays = {"B": ((rng.random((12, 10)) < 0.4)
                    * rng.integers(1, 5, (12, 10))).astype(float),
              "C": ((rng.random((10, 8)) < 0.4)
                    * rng.integers(1, 5, (10, 8))).astype(float),
              "d": rng.integers(0, 4, 8).astype(float)}
    dims = {"i": 12, "j": 10, "k": 8}
    cp = tb.compile_program(text, Format(default="c"), "auto", dims,
                            sparsity=0.4, device=CPU)
    rlp = _ref_pick(monkeypatch, tmp_path, lambda: rprog.lower_program(
        text, RFormat(default="c"), "auto", dims, sparsity=0.4))
    assert [schedule_to_dict(s.schedule) for s in cp.lp.stages] == \
        [ra.schedule_to_dict(s.schedule) for s in rlp.stages]
    assert cp.cache_key == rprog.program_cache_key(rlp)
    out, ref = cp(arrays), numpy_reference(text, arrays)
    for name, ft in out.items():
        np.testing.assert_array_equal(ft.to_dense(), ref[name])
    # a stage may be "auto" alone
    cp2 = tb.compile_program(text, Format(default="c"),
                             {"T": "auto", "x": Schedule(loop_order=("i",
                                                                     "k"))},
                             dims, sparsity=0.4, device=CPU)
    np.testing.assert_array_equal(cp2(arrays)["x"].to_dense(), ref["x"])


# ---------------------------------------------------------------------------
# the port's legs of tests/test_autoschedule.py
# ---------------------------------------------------------------------------

def test_enumeration_legality():
    assign = parse(EXPR)
    dims = {"i": 16, "j": 16, "k": 8}
    specs = enumerate_space(assign, dims, device_count=4)
    assert specs
    all_vars = sorted(assign.all_vars)
    for spec in specs:
        assert sorted(spec.order) == all_vars
        for v, f in spec.split:
            assert f >= 2 and (f & (f - 1)) == 0 and f <= dims[v]
            sd = split_dims({v: dims[v]}, {v: f})
            assert sd[f"{v}o"] == f and sd[f"{v}o"] * sd[f"{v}i"] >= dims[v]
            assert f"{v}o" not in all_vars and f"{v}i" not in all_vars
        assert spec.lanes <= 4
        if spec.lanes > 1:
            assert spec.split and spec.lanes <= spec.split[0][1]
    assert len({s.order for s in specs if not s.split}) == 6
    assert all(s.lanes == 1
               for s in enumerate_space(assign, dims, device_count=1))


def test_enumeration_excludes_split_rename_clashes():
    assign = parse("X(i) = B(i,k) * C(k,ko) * d(ko)")
    specs = enumerate_space(assign, {"i": 8, "k": 8, "ko": 8},
                            device_count=1)
    assert not any(v == "k" for s in specs for v, _ in s.split)
    assert any(v == "ko" for s in specs for v, _ in s.split)


def test_enumeration_split_factors_fit_dims():
    specs = enumerate_space(parse(EXPR), {"i": 16, "j": 16, "k": 3},
                            device_count=1)
    assert {f for s in specs for v, f in s.split if v == "k"} == {2}


def test_candidates_are_executable_and_correct():
    """Every ranked candidate, lanes included, simulates AND runs on the
    port's engine to the right answer."""
    arrays, dims = _spmspm(24, 24, 12)
    rep = search(EXPR, FMT, dims, arrays=arrays, device_count=2, top_k=6)
    want = arrays["B"] @ arrays["C"]
    for cand in rep.candidates:
        res = simulate_expr(EXPR, FMT, cand.schedule, arrays, dims)
        np.testing.assert_array_equal(res.dense, want, cand.spec.key())
        got = tb.compile_expr(EXPR, FMT, cand.schedule, dims, device=CPU)
        np.testing.assert_array_equal(got(arrays).to_dense(), want,
                                      cand.spec.key())


@settings(max_examples=5, deadline=None)
@given(hst.integers(8, 24), hst.integers(8, 24), hst.integers(4, 16),
       hst.integers(1, 4))
def test_cost_ranking_is_deterministic(i, j, k, devices):
    dims = {"i": i, "j": j, "k": k}
    reps = [search(EXPR, FMT, dims, sparsity=0.25, device_count=devices)
            for _ in range(2)]
    assert _ranking(reps[0]) == _ranking(reps[1])
    assert reps[0].best.schedule == reps[1].best.schedule
    # and the reference ranks the same candidates the same way
    assert _ranking(reps[0]) == _ranking(ra.search(
        EXPR, RFMT, dims, sparsity=0.25, device_count=devices))


def test_fig12_auto_schedule_quality():
    arrays, dims = _spmspm(120, 120, 50, seed=20230325)
    exhaustive = {}
    for order in ("ijk", "ikj", "jik", "jki", "kij", "kji"):
        exhaustive[order] = simulate_expr(
            EXPR, FMT, Schedule(loop_order=tuple(order)), arrays,
            dims).cycles
    rep = search(EXPR, FMT, dims, arrays=arrays, device_count=1)
    auto = simulate_expr(EXPR, FMT, rep.best.schedule, arrays, dims).cycles
    assert auto <= 1.1 * min(exhaustive.values())
    assert max(exhaustive.values()) >= 5.0 * auto


def test_downsample_operands_clamps_dims_and_slices():
    arrays, dims = _spmspm(64, 32, 16)
    s_arrays, s_dims = downsample_operands(parse(EXPR), arrays, dims,
                                           max_dim=24)
    assert s_dims == {"i": 24, "j": 24, "k": 16}
    assert s_arrays["B"].shape == (24, 16) and s_arrays["C"].shape == (16,
                                                                       24)
    np.testing.assert_array_equal(s_arrays["B"], arrays["B"][:24, :16])


def test_sampled_cycles_matches_downsampled_sim():
    arrays, dims = _spmspm(64, 32, 16)
    sch = Schedule(loop_order=("k", "j", "i"))
    got = sampled_cycles(EXPR, FMT, sch, arrays, dims, max_dim=24)
    s_arrays, s_dims = downsample_operands(parse(EXPR), arrays, dims, 24)
    assert got == simulate_expr(EXPR, FMT, sch, s_arrays, s_dims).cycles


def test_schedule_dict_roundtrip():
    sch = Schedule(loop_order=("i", "k", "j"),
                   locate=frozenset({("B", "j")}), skip=frozenset({"k"}),
                   bitvector=frozenset({"j"}), split={"k": 4},
                   parallelize={"k": 2}, reduce_empty="zero")
    assert schedule_from_dict(schedule_to_dict(sch)) == sch
    assert schedule_from_dict(
        json.loads(json.dumps(schedule_to_dict(sch)))) == sch


def test_cache_second_request_hits_without_search(tmp_path):
    arrays, dims = _spmspm(32, 32, 16)
    cache = ScheduleCache(path=tmp_path / "schedules.json")
    r1 = resolve_schedule(EXPR, FMT, dims, arrays=arrays, cache=cache,
                          device_count=1)
    assert not r1.cache_hit and r1.report is not None
    r2 = resolve_schedule(EXPR, FMT, dims, arrays=arrays, cache=cache,
                          device_count=1)
    assert r2.cache_hit and r2.report is None
    assert r2.schedule == r1.schedule and r2.key == r1.key


def test_cache_key_buckets_and_invalidation():
    assign = parse(EXPR)
    dens = resolve_densities(assign, 0.05)

    def key(dims, d=dens, fmt=FMT, devices=1):
        return auto_cache_key(assign, fmt, dims, d, devices)

    base = key({"i": 100, "j": 100, "k": 100})
    assert key({"i": 120, "j": 80, "k": 65}) == base
    assert key({"i": 200, "j": 100, "k": 100}) != base
    assert key({"i": 100, "j": 100, "k": 100},
               resolve_densities(assign, 0.06)) == base
    assert key({"i": 100, "j": 100, "k": 100},
               resolve_densities(assign, 0.005)) != base
    assert key({"i": 100, "j": 100, "k": 100},
               fmt=Format({"B": "dc", "C": "cc"})) != base
    assert key({"i": 100, "j": 100, "k": 100}, devices=4) != base
    assert auto_cache_key(parse("X(i,j) = B(i,k) * C(k,j) + D(i,j)"),
                          FMT, {"i": 100, "j": 100, "k": 100},
                          dens, 1) != base


def test_cache_key_separates_search_spaces(tmp_path):
    dims = {"i": 16, "j": 16, "k": 8}
    cache = ScheduleCache(path=tmp_path / "schedules.json")
    kw = dict(sparsity=0.25, cache=cache, device_count=1)
    r1 = resolve_schedule(EXPR, FMT, dims, **kw)
    r2 = resolve_schedule(EXPR, FMT, dims, max_orders=1, **kw)
    assert r2.key != r1.key and not r2.cache_hit
    r3 = resolve_schedule(EXPR, FMT, dims, **kw)
    assert r3.cache_hit and r3.key == r1.key and r3.schedule == r1.schedule


def test_cache_tolerates_corrupt_file(tmp_path):
    path = tmp_path / "schedules.json"
    cache = ScheduleCache(path=path)
    for bad in ("{not json", "[1, 2, 3]", '{"version": 1, "entries": 7}',
                '{"version": 1, "entries": {"k1": {"no_schedule": 1}}}'):
        path.write_text(bad)
        assert cache.lookup("k1") is None
    cache.store("k1", Schedule(loop_order=("i",)))
    assert cache.lookup("k1") == Schedule(loop_order=("i",))


def test_search_accepts_partial_arrays_with_hints():
    arrays, dims = _spmspm(24, 24, 12)
    rep = search(EXPR, FMT, dims, arrays={"B": arrays["B"]},
                 sparsity={"C": 0.1}, device_count=1)
    assert rep.candidates


def test_search_flags_truncated_order_space():
    dims = {"i": 8, "j": 8, "k": 8}
    assert search(EXPR, FMT, dims, sparsity=0.25, device_count=1,
                  max_orders=2).orders_truncated
    assert not search(EXPR, FMT, dims, sparsity=0.25,
                      device_count=1).orders_truncated


def test_cache_file_deletion_busts_inprocess_memo(tmp_path):
    arrays, dims = _spmspm(16, 16, 8, density=0.3)
    cache = ScheduleCache(path=tmp_path / "schedules.json")
    resolve_schedule(EXPR, FMT, dims, arrays=arrays, cache=cache,
                     device_count=1)
    os.unlink(cache.path)
    r = resolve_schedule(EXPR, FMT, dims, arrays=arrays, cache=cache,
                         device_count=1)
    assert not r.cache_hit and r.report is not None


def test_cache_clear_purges_inprocess_memo(tmp_path):
    arrays, dims = _spmspm(16, 16, 8, density=0.3)
    cache = ScheduleCache(path=tmp_path / "schedules.json")
    resolve_schedule(EXPR, FMT, dims, arrays=arrays, cache=cache,
                     device_count=1)
    cache.clear()
    r = resolve_schedule(EXPR, FMT, dims, arrays=arrays, cache=cache,
                         device_count=1)
    assert not r.cache_hit and r.report is not None


def test_clear_lowering_cache_also_clears_resolution_memo(tmp_path):
    arrays, dims = _spmspm(16, 16, 8, density=0.3)
    cache = ScheduleCache(path=tmp_path / "schedules.json")
    resolve_schedule(EXPR, FMT, dims, arrays=arrays, cache=cache,
                     device_count=1)
    assert a._RESOLVED
    clear_lowering_cache()
    assert not a._RESOLVED


def test_lower_auto_resolves_and_executes():
    arrays, dims = _spmspm(12, 12, 8, density=0.3)
    low = lower(EXPR, FMT, "auto", dims)
    assert sorted(low.schedule.loop_order) == ["i", "j", "k"]
    res = simulate_expr(EXPR, FMT, low.schedule, arrays, dims)
    np.testing.assert_array_equal(res.dense, arrays["B"] @ arrays["C"])
    eng = tb.compile_expr(EXPR, FMT, "auto", dims, sparsity=0.3, device=CPU)
    np.testing.assert_array_equal(eng.execute(arrays).to_dense(),
                                  arrays["B"] @ arrays["C"])


def test_lower_rejects_unknown_schedule_string():
    with pytest.raises(ValueError):
        lower(EXPR, FMT, "fastest", {"i": 4, "j": 4, "k": 4})
    with pytest.raises(ValueError):
        tb.compile_expr(EXPR, FMT, "fastest", {"i": 4, "j": 4, "k": 4},
                        device=CPU)


# ---------------------------------------------------------------------------
# the port's legs of the format-search tests (tests/test_format_conformance)
# ---------------------------------------------------------------------------

def _rand(shape, seed, density=0.4):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) < density)
            * rng.integers(1, 9, shape)).astype(float)


def test_autoscheduler_enumerates_only_iterable_formats():
    specs = enumerate_space(parse("x(i) = B(i,j) * c(j)"),
                            {"i": 8, "j": 8}, device_count=1,
                            fmt=Format({}), format_choices=FORMAT_CHOICES)
    combos = {s.formats for s in specs}
    assert len(combos) == 16          # {c,m,h,s}^2, baseline included
    for combo in combos:
        for _, s in combo:
            assert all(spec_of(ch).iterate for ch in s)
    assert "fmt=B:mm" in CandidateSpec(order=("i", "j"),
                                       formats=(("B", "mm"),)).key()
    assert "fmt=" not in CandidateSpec(order=("i", "j")).key()


def test_format_search_beats_dc_space():
    """The joint (format x schedule) search finds a strictly cheaper
    modeled plan than the d/c-only space on a bitmap-friendly operand,
    and the winner runs on the port's engine to numpy's result."""
    arrays = {"B": _rand((64, 64), 21, density=0.25),
              "C": _rand((64, 64), 22, density=0.25)}
    fmt = Format({"B": "cc", "C": "cc", "X": "cc"})
    dims = {"i": 64, "j": 64}
    expr = "X(i,j) = B(i,j) * C(i,j)"
    plain = search(expr, fmt, dims, arrays=arrays, device_count=1)
    joint = search(expr, fmt, dims, arrays=arrays, device_count=1,
                   format_choices=FORMAT_CHOICES)
    assert joint.best.cycles < plain.best.cycles
    assert joint.best.spec.formats
    eng = tb.compile_expr(expr, joint.best.spec.format(fmt),
                          joint.best.schedule, dims, device=CPU)
    np.testing.assert_array_equal(eng(arrays).to_dense(),
                                  arrays["B"] * arrays["C"])


def test_schedule_cache_rejects_prior_version_entries(tmp_path, monkeypatch):
    path = tmp_path / "shared_cache.json"
    monkeypatch.setenv("SAM_SCHEDULE_CACHE", str(path))
    a.clear_resolution_memo()
    with open(path, "w") as f:
        json.dump({"version": 2, "entries": {
            "k": {"schedule": {"loop_order": ["i", "j"]},
                  "meta": {}, "created": 0.0}}}, f)
    cache = ScheduleCache()
    assert cache.path == str(path)
    assert cache.lookup("k") is None          # v2 entries never served
    cache.store("k", Schedule(loop_order=("j", "i")))
    got = cache.lookup("k")
    assert got is not None and tuple(got.loop_order) == ("j", "i")
    with open(path) as f:
        assert json.load(f)["version"] == a.CACHE_VERSION
