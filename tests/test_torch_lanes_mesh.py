"""Lanes over a lane mesh of several devices (``shard_lanes``).

* The 14 Table-1 cases under ``split``/``parallelize`` 4 on a CPU lane
  mesh of four (``$SAM_LANE_DEVICES``: the CPU repeated, the port's
  counterpart of the reference's forced host devices) equal the port's
  serial lanes exactly, and the reference's single-device lane engine
  (its ``vmap`` path: its ``shard_map`` path does not run under the
  installed jax, whose ``shard_map`` takes ``check_vma``), on its jnp
  primitives, since its Pallas kernels in interpret mode take five times
  as long to compile and give the same integers. Its 14 engines compile
  once, four at a time on threads (XLA compiles outside the GIL).
* The lane-mesh resolver's None/False/True/int cases equal the
  reference's ``_resolve_shard_lanes`` at device counts 1 to 4, the
  count patched on both sides.
* ``execute_many``, ``SamServer``'s "many" route and
  ``serve --sam --split i=4 --devices 2 --device cpu`` equal the serial
  results.

Integer-valued data, so every comparison is exact.
"""
import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
from test_custard_table1 import CASES, DIMS  # noqa: E402
from test_torch_engine import assert_same_tree, make_arrays  # noqa: E402

from repro.core import jax_backend as rjb  # noqa: E402
from repro.core.schedule import Format as RFormat  # noqa: E402
from repro.core.schedule import Schedule as RSchedule  # noqa: E402
from repro_torch.core import torch_backend as tb  # noqa: E402
from repro_torch.core.schedule import Format, Schedule  # noqa: E402
from repro_torch.core.serving import Request, SamServer  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

CPU = "cpu"
SPMSPM = "X(i,j) = B(i,k) * C(k,j)"
SPMSPM_FMT = {"B": "cc", "C": "cc"}
BDIMS = {"i": 16, "j": 11, "k": 9}


def lanes(order, k):
    return dict(loop_order=tuple(order), split={order[0]: k},
                parallelize={order[0]: k})


def spmspm_set(rng, density=0.4):
    def sparse(shape):
        return ((rng.random(shape) < density)
                * rng.integers(1, 9, shape)).astype(float)
    return {"B": sparse((16, 9)), "C": sparse((9, 11))}


@pytest.fixture
def mesh_of(monkeypatch):
    """Sets the CPU lane mesh's device count (unset to begin with, and
    restored after the test, also where ``serve.main`` sets it)."""
    def set_count(n):
        monkeypatch.setenv(tb.LANE_DEVICES_ENV, str(n))
    monkeypatch.setenv(tb.LANE_DEVICES_ENV, "1")
    monkeypatch.delenv(tb.LANE_DEVICES_ENV)
    return set_count


@pytest.fixture(scope="module")
def reference_lanes():
    """{case: (lane counts, FiberTree)} of the reference's single-device
    lane engine on each Table-1 case under four lanes."""
    def run(case):
        name, expr, order, fmts, _ = case
        eng = rjb.CompiledExpr(expr, RFormat(dict(fmts)),
                               RSchedule(**lanes(order, 4)), DIMS,
                               shard_lanes=False, use_kernels=False)
        return name, (eng.lane_ns, eng(make_arrays(expr, DIMS,
                                                   seed=len(name))))
    with ThreadPoolExecutor(4) as pool:
        return dict(pool.map(run, CASES))


@pytest.mark.parametrize("name,expr,order,fmts,expected", CASES,
                         ids=[c[0] for c in CASES])
def test_table1_on_a_lane_mesh_of_four(name, expr, order, fmts, expected,
                                       mesh_of, caplog, reference_lanes):
    arrays = make_arrays(expr, DIMS, seed=len(name))
    fmt, sch = Format(dict(fmts)), Schedule(**lanes(order, 4))
    serial = tb.CompiledExpr(expr, fmt, sch, DIMS, device=CPU,
                             shard_lanes=False)
    mesh_of(4)
    with caplog.at_level(logging.WARNING, logger=tb.__name__):
        eng = tb.CompiledExpr(expr, fmt, sch, DIMS, device=CPU,
                              shard_lanes=4)
    assert eng._lane_mesh == 4 and "cpu repeated 4 times" in caplog.text
    got = eng(arrays)
    assert_same_tree(serial(arrays), got, name)
    sharded = 1 if max(eng.lane_ns) > 1 else 0
    assert eng.stats["sharded_dispatches"] == sharded
    assert serial.stats["sharded_dispatches"] == 0
    ref_lane_ns, ref = reference_lanes[name]
    assert ref_lane_ns == eng.lane_ns
    assert_same_tree(ref, got, name)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
def test_resolver_equals_the_reference(n_dev, mesh_of, monkeypatch):
    mesh_of(n_dev)
    monkeypatch.setattr(jax, "device_count", lambda: n_dev)
    for par_n in (1, 2, 3, 4, 6, 8):
        for shard in (None, False, True, 1, 2, 3, 4):
            try:
                want = rjb._resolve_shard_lanes(shard, par_n)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    tb._resolve_shard_lanes(shard, par_n, CPU)
                assert str(got.value) == str(e)
                continue
            assert tb._resolve_shard_lanes(shard, par_n, CPU) == want, (
                n_dev, par_n, shard)
            assert tb.lane_mesh_size(par_n, None, CPU) \
                == rjb.lane_mesh_size(par_n)


def test_execute_many_and_the_server_equal_serial_lanes(mesh_of):
    rng = np.random.default_rng(3)
    sets = [spmspm_set(rng, d) for d in (0.2, 0.5, 0.3)]
    fmt, sch = Format(SPMSPM_FMT), Schedule(**lanes("ikj", 4))
    serial = tb.compile_expr(SPMSPM, fmt, sch, BDIMS, device=CPU,
                             shard_lanes=False)
    want = [serial(a) for a in sets]
    mesh_of(4)
    eng = tb.compile_expr(SPMSPM, fmt, sch, BDIMS, device=CPU)
    assert eng is not serial and eng._lane_mesh == 4
    for w, o in zip(want, eng.execute_many(sets)):
        assert_same_tree(w, o)
    assert eng.stats["sharded_dispatches"] == 3
    # a batch keeps its lanes in series
    for w, o in zip(want, eng.execute_batch(sets)):
        assert_same_tree(w, o)
    assert eng.stats["sharded_dispatches"] == 3
    srv = SamServer(max_batch=4, sync=True, devices=4, device=CPU)
    handles = srv.submit_many([Request(SPMSPM, a, formats=fmt, dims=BDIMS,
                                       schedule=sch) for a in sets])
    srv.drain(timeout=60)
    for w, h in zip(want, handles):
        assert_same_tree(w, h.result(timeout=60))
    srv.shutdown()
    assert eng.stats["sharded_dispatches"] == 6      # one a request


def test_serve_devices_on_the_cpu_equals_serial(mesh_of, capsys):
    mesh_of(1)
    args = ["--sam", SPMSPM, "--sam-order", "ikj", "--sam-formats",
            "B=cc,C=cc", "--sam-dims", "i=16,j=12,k=8", "--split", "i=4",
            "--sam-density", "0.3", "--batch", "2", "--reps", "1",
            "--device", CPU]
    want = serve.main(args)
    assert "lanes run one after another" in capsys.readouterr().out
    got = serve.main(args + ["--devices", "2"])
    out = capsys.readouterr().out
    assert "lanes over a lane mesh of 2 devices (cpu, cpu)" in out
    assert "'sharded_dispatches': 2" in out
    for w, g in zip(want, got):
        assert_same_tree(w, g)
