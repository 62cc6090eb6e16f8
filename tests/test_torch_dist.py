"""The port's distributed tile driver (``repro_torch.core.dist_exec``) on
the CPU.

* The nine cases of ``tests/test_dist_chaos.py`` against the port: retry
  on a surviving worker, a worker killed mid-run, the fail limit,
  machine-readable terminal failures, injected slowness on a
  ``FakeClock`` (timeouts and the straggler watchdog), fault bookkeeping
  and the refusal of an untiled engine.
* As ``tests/test_conformance.py::test_random_distributed_conformance``
  checks: the port's ``DistTiledExpr`` over 1, 2 and 4 workers (the
  inline and the threaded scheduler) equals the port's ``TiledExpr`` and
  numpy bytewise, and equals the reference's ``DistTiledExpr``
  (``overlap=False``) on the same cases.
* Merge-order determinism, and the mesh pieces it uses (``Mesh``,
  ``shrink_mesh``, ``data_axes``).

Integer-valued operands, so every comparison is exact.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.dist_exec import (DistributedError, DistTiledExpr,
                                        FaultInjector, InjectedFault,
                                        dist_compile, worker_devices)
from repro_torch.core.schedule import Format, Schedule
from repro_torch.core.serving import FakeClock
from repro_torch.core.torch_backend import TiledExpr, compile_expr
from repro_torch.distributed.elastic import shrink_mesh
from repro_torch.distributed.fault_tolerance import StragglerPolicy
from repro_torch.distributed.sharding import data_axes
from repro_torch.launch.mesh import Mesh, make_host_mesh

CPU = "cpu"
EXPR = "X(i,j) = B(i,k) * C(k,j)"
FMT = Format({"B": "cc", "C": "cc"})
SCH = Schedule(loop_order=("i", "k", "j"), tile={"i": 2, "k": 2})  # 4 tiles
N = 8
DIMS = {"i": N, "j": N, "k": N}


def _operands(seed: int = 0):
    rng = np.random.default_rng(seed)
    B = ((rng.random((N, N)) < 0.4)
         * rng.integers(1, 9, (N, N))).astype(float)
    C = ((rng.random((N, N)) < 0.4)
         * rng.integers(1, 9, (N, N))).astype(float)
    return {"B": B, "C": C}


def _dist(faults=(), **kw):
    kw.setdefault("clock", FakeClock())
    return dist_compile(EXPR, FMT, SCH, DIMS, faults=list(faults),
                        device=CPU, **kw)


# -- the chaos cases of tests/test_dist_chaos.py ----------------------------

def test_injected_fail_retries_on_surviving_worker():
    # inline: tile 1 attempt 0 -> worker 1; the fail moves attempt 1 to
    # worker (1 + 1) % 2 = 0
    arrays = _operands()
    d = _dist([InjectedFault(tile=1, worker=1, attempt=0, kind="fail")],
              workers=2, overlap=False)
    assert np.array_equal(d(arrays).to_dense(), arrays["B"] @ arrays["C"])
    assert d.stats["failures"] == 1 and d.stats["retries"] == 1
    assert d.stats["workers_lost"] == 0
    assert d.live_workers == [0, 1]
    assert d.failure_log == [{"tile": 1, "worker": 1, "attempt": 0,
                              "reason": "injected-fail",
                              "worker_lost": False}]
    assert [(f.tile, f.worker) for f in d.faults.fired] == [(1, 1)]


def test_kill_one_worker_mid_run_bit_identical():
    arrays = _operands(seed=1)
    want = arrays["B"] @ arrays["C"]
    ref = compile_expr(EXPR, FMT, SCH, DIMS, device=CPU)(arrays).to_dense()
    d = _dist([InjectedFault(tile=1, worker=1, attempt=0, kind="kill")],
              workers=2, overlap=True)
    out = d(arrays).to_dense()
    assert out.tobytes() == ref.tobytes()
    assert np.array_equal(out, want)
    assert d.stats["workers_lost"] == 1 and d.stats["replans"] == 1
    assert d.stats["retries"] == 1
    assert d.live_workers == [0]
    [entry] = d.failure_log
    assert entry["reason"] == "injected-kill" and entry["worker_lost"]
    assert sum(w.tiles_done for w in d.workers) == 4
    d.revive()
    d.faults = FaultInjector()
    assert d.live_workers == [0, 1]
    assert np.array_equal(d(arrays).to_dense(), want)
    assert d.stats["workers_lost"] == 1      # history, not state


def test_fail_limit_drops_flaky_worker():
    arrays = _operands(seed=2)
    d = _dist([InjectedFault(tile=1, worker=1, attempt=0, kind="fail")],
              workers=2, overlap=False, worker_fail_limit=0)
    assert np.array_equal(d(arrays).to_dense(), arrays["B"] @ arrays["C"])
    assert d.stats["workers_lost"] == 1
    assert d.live_workers == [0]
    assert d.failure_log[0]["worker_lost"]


def test_retries_exhausted_is_machine_readable():
    arrays = _operands(seed=3)
    d = _dist([InjectedFault(tile=1, worker=1, attempt=0),
               InjectedFault(tile=1, worker=0, attempt=1)],
              workers=2, overlap=False, max_attempts=2)
    with pytest.raises(DistributedError) as ei:
        d(arrays)
    assert ei.value.reason == "retries-exhausted"
    assert [e["reason"] for e in d.failure_log] == ["injected-fail"] * 2


def test_all_workers_lost_is_machine_readable():
    arrays = _operands(seed=4)
    d = _dist([InjectedFault(tile=0, worker=0, attempt=0, kind="kill")],
              workers=1)
    with pytest.raises(DistributedError) as ei:
        d(arrays)
    assert ei.value.reason == "no-workers"
    with pytest.raises(DistributedError) as ei2:
        d(arrays)
    assert ei2.value.reason == "no-workers"
    d.revive()
    d.faults = FaultInjector()
    assert np.array_equal(d(arrays).to_dense(), arrays["B"] @ arrays["C"])


def test_slow_fault_trips_timeout_and_retries():
    arrays = _operands(seed=5)
    d = _dist([InjectedFault(tile=0, worker=0, attempt=0, kind="slow",
                             dt=10.0)],
              workers=2, overlap=False, tile_timeout_s=5.0)
    assert np.array_equal(d(arrays).to_dense(), arrays["B"] @ arrays["C"])
    assert d.stats["timeouts"] == 1 and d.stats["retries"] == 1
    assert d.failure_log[0]["reason"] == "tile-timeout"


def test_straggler_watchdog_flags_injected_slowness():
    arrays = _operands(seed=6)
    pol = StragglerPolicy(threshold=2.0, grace_steps=0)
    d = _dist([InjectedFault(tile=3, worker=1, attempt=0, kind="slow",
                             dt=1.0)],
              workers=2, overlap=False, tile_timeout_s=5.0, straggler=pol)
    assert np.array_equal(d(arrays).to_dense(), arrays["B"] @ arrays["C"])
    assert d.stats["stragglers"] == 1 and d.stats["timeouts"] == 0
    [(step, dt, _ema)] = pol.flagged
    assert step == 3 and dt == 1.0
    assert d.stats["failures"] == 0


def test_fault_validation_and_injector_bookkeeping():
    with pytest.raises(ValueError):
        InjectedFault(tile=0, worker=0, kind="meteor")
    inj = FaultInjector([InjectedFault(tile=2, worker=0, attempt=1)])
    assert inj.check(2, 0, 0) is None
    assert inj.check(2, 0, 1) is not None
    assert len(inj.fired) == 1
    arrays = _operands(seed=7)
    d = _dist([], workers=2, overlap=False)
    assert np.array_equal(d(arrays).to_dense(), arrays["B"] @ arrays["C"])
    assert d.stats["failures"] == 0 and d.faults.fired == []


def test_dist_requires_a_tiled_engine():
    plain = compile_expr(EXPR, FMT, Schedule(loop_order=("i", "k", "j")),
                         DIMS, device=CPU)
    with pytest.raises(TypeError):
        DistTiledExpr(plain)
    with pytest.raises(ValueError):
        dist_compile(EXPR, FMT, Schedule(loop_order=("i", "k", "j")), DIMS,
                     device=CPU)


# -- conformance: workers x schedulers against TiledExpr and numpy ----------

# (expression, loop order, dims, tile): contraction tiles that reduce-merge,
# result tiles that concatenate, a scalar result, ragged tiles, a 3-tensor
CASES = [
    ("X(i,j) = B(i,k) * C(k,j)", "ikj", {"i": 7, "j": 6, "k": 5},
     {"i": 2, "k": 3}),
    ("x(i) = B(i,j) * c(j)", "ij", {"i": 9, "j": 7}, {"j": 3}),
    ("x = B(i,j) * C(i,j)", "ij", {"i": 6, "j": 5}, {"i": 4}),
    ("X(i,j) = B(i,j,k) * c(k)", "ijk", {"i": 5, "j": 4, "k": 6},
     {"i": 2, "k": 2}),
]


def _case(idx):
    expr, order, dims, tile = CASES[idx]
    rng = np.random.default_rng(100 + idx)
    from repro_torch.core.einsum import parse

    assign = parse(expr)
    arrays = {}
    for term in assign.terms:
        for f in term.factors:
            shape = tuple(dims[v] for v in f.vars)
            arrays[f.tensor] = ((rng.random(shape) < 0.5)
                                * rng.integers(1, 5, shape)).astype(float)
    fmt = Format({t: "c" * a.ndim for t, a in arrays.items()})
    spec = (",".join("".join(f.vars) for f in assign.terms[0].factors)
            + "->" + "".join(assign.lhs.vars))
    want = np.einsum(spec, *[arrays[f.tensor]
                             for f in assign.terms[0].factors])
    return expr, fmt, Schedule(loop_order=tuple(order), tile=tile), dims, \
        arrays, want


@pytest.mark.parametrize("idx", range(len(CASES)))
def test_distributed_equals_tiled_and_numpy(idx):
    """Worker count and scheduler are invisible in the result bytes."""
    expr, fmt, sch, dims, arrays, want = _case(idx)
    eng = compile_expr(expr, fmt, sch, dims, device=CPU)
    assert isinstance(eng, TiledExpr)
    ref = np.asarray(eng(arrays).to_dense())
    np.testing.assert_array_equal(ref, want)
    for workers in (1, 2, 4):
        d = DistTiledExpr(eng, workers=workers, clock=FakeClock(),
                          overlap=bool((idx + workers) % 2))
        got = np.asarray(d(arrays).to_dense())
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes(), \
            f"dist(workers={workers}) != tiled: {expr} {sch.tile}"
        assert d.stats["failures"] == 0
        assert d.stats["tile_calls"] == eng.n_tiles


@pytest.mark.parametrize("idx", [0, 2])
def test_distributed_equals_the_reference_distributed(idx):
    """The port's DistTiledExpr equals the reference's on the same case
    (the reference inline, the port threaded)."""
    pytest.importorskip("jax")
    from repro.core import schedule as rs
    from repro.core.dist_exec import DistTiledExpr as RefDist
    from repro.core.jax_backend import compile_expr as ref_compile
    from repro.core.serving import FakeClock as RefClock

    expr, fmt, sch, dims, arrays, _ = _case(idx)
    ref_eng = ref_compile(expr, rs.Format(dict(fmt.formats)),
                          rs.Schedule(loop_order=sch.loop_order,
                                      tile=dict(sch.tile)), dims)
    want = np.asarray(RefDist(ref_eng, workers=2, clock=RefClock(),
                              overlap=False)(arrays).to_dense())
    got = np.asarray(DistTiledExpr(
        compile_expr(expr, fmt, sch, dims, device=CPU), workers=2,
        clock=FakeClock(), overlap=True)(arrays).to_dense())
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_distributed_merge_order_determinism():
    """Shuffled arrival order of the tile partials -> identical bytes."""
    rng = np.random.default_rng(11)
    n = 10
    dims = {"i": n, "j": n, "k": n}
    arrays = {m: ((rng.random((n, n)) < 0.5)
                  * rng.integers(1, 5, (n, n))).astype(float)
              for m in ("B", "C")}
    d = dist_compile(EXPR, FMT, Schedule(loop_order=("i", "k", "j"),
                                         tile={"i": 3, "k": 2}),
                     dims, workers=2, clock=FakeClock(), device=CPU)
    partials = d.tile_partials(arrays)
    assert len(partials) == d.n_tiles >= 4
    ref = d.merge_partials(partials).to_dense().tobytes()
    order = list(partials)
    for shuffle_seed in range(5):
        np.random.default_rng(shuffle_seed).shuffle(order)
        shuffled = {idx: partials[idx] for idx in order}
        assert list(shuffled) != sorted(shuffled) or shuffle_seed == 0
        assert d.merge_partials(shuffled).to_dense().tobytes() == ref


def test_mesh_pieces_and_worker_placement():
    mesh = make_host_mesh(device=CPU)
    assert mesh.shape == {"data": 1, "model": 1} and data_axes(mesh) == (
        "data",)
    mesh, devs = worker_devices(3, CPU)
    assert [str(d) for d in devs] == ["cpu"] * 3
    assert shrink_mesh(mesh, failed_hosts=1, devices_per_host=1) == (None, 0)
    # a mesh of four devices loses one host: the data axis shrinks
    four = Mesh(np.array([torch.device("cuda", i) for i in range(4)],
                         dtype=object).reshape(4, 1), ("data", "model"))
    small, data = shrink_mesh(four, failed_hosts=1, devices_per_host=1)
    assert data == 3 and small.shape == {"data": 3, "model": 1}
    assert [d.index for d in small.devices.reshape(-1)] == [0, 1, 2]


def test_host_mesh_refuses_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_host_mesh()
