"""The port's serving layer (``repro_torch.core.serving``) on the CPU.

* The cases of ``tests/test_serving.py`` against the port's ``SamServer``
  with ``device="cpu"`` (admission's refusal and tiling as one
  parametrised case): coalescing, ``FakeClock`` stats, queue bounds,
  threaded soak, shutdown, admission control, reset.
* The fuzz case of ``tests/test_serving_fuzz.py``: random interleavings
  over several cache keys never cross-contaminate a batch.
* A differential case: one request stream, with a refused and a tiled
  request in it, through the reference ``SamServer(sync=True,
  clock=FakeClock())`` and the port's; dispatch counts, every ``stats()``
  counter and the dense results must be equal, bit for bit.
* The thread-start race of the reference (ROADMAP queue 3, item 2): eight
  threads make their first ``submit`` at once; the port starts exactly one
  pipeline.

The reference is only ever driven in sync mode here. Every wait in this
file has its own bound (60 s at most), and the integer-valued operands make
every comparison exact.
"""
import sys
import threading

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as hst
except ImportError:  # clean checkout: deterministic stub keeps tests running
    from _hypothesis_stub import given, settings, strategies as hst

from repro_torch.core import tiling
from repro_torch.core.schedule import Format, Schedule
from repro_torch.core.serving import (AdmissionError, FakeClock, Request,
                                      ResultHandle, SamServer,
                                      active_servers, reset_serving)
from repro_torch.core.torch_backend import compile_expr

CPU = "cpu"
WAIT = 60            # seconds: the bound of every wait in this file
MV = "x(i) = B(i,j) * c(j)"
MM = "X(i,j) = B(i,k) * C(k,j)"
MV_FMT = {"B": "cc", "c": "c"}
MM_FMT = {"B": "cc", "C": "cc"}
N = 8


def _ops_mv(rng, density=0.5):
    B = (rng.random((N, N)) < density) * rng.integers(1, 9, (N, N))
    return {"B": B.astype(np.float32),
            "c": rng.integers(1, 9, N).astype(np.float32)}


def _ops_mm(rng, density=0.5):
    def sp():
        return ((rng.random((N, N)) < density)
                * rng.integers(1, 9, (N, N))).astype(np.float32)
    return {"B": sp(), "C": sp()}


def _mv_engine():
    return compile_expr(MV, Format(MV_FMT), Schedule(loop_order=("i", "j")),
                        {"i": N, "j": N}, device=CPU)


def _mm_engine():
    return compile_expr(MM, Format(MM_FMT),
                        Schedule(loop_order=("i", "k", "j")),
                        {"i": N, "j": N, "k": N}, device=CPU)


def _server(**kw):
    return SamServer(device=CPU, **kw)


def test_server_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SamServer(sync=True)


# -- sync mode: deterministic batching + stats ------------------------------

def test_sync_coalescing_auto_dispatch_and_fake_clock_stats():
    rng = np.random.default_rng(0)
    clock = FakeClock()
    srv = _server(sync=True, max_batch=4, clock=clock)
    sets = [_ops_mv(rng) for _ in range(6)]
    handles = []
    for s in sets:
        clock.advance(0.01)        # requests arrive 10ms apart
        handles.append(srv.submit(Request(MV, s, formats=MV_FMT)))
    # 4 of 6 auto-dispatched at max_batch; 2 pending until flush
    assert [h.done() for h in handles] == [True] * 4 + [False] * 2
    clock.advance(0.5)
    srv.flush()
    assert all(h.done() for h in handles)
    for h, s in zip(handles, sets):
        assert np.array_equal(h.result().to_dense(), s["B"] @ s["c"])
    st = srv.stats()
    assert st["dispatches"] == 2 < st["completed"] == 6   # coalesced
    assert st["batch_occupancy"] == 3.0
    assert st["max_batch_seen"] == 4
    # latencies [30, 20, 10, 0] ms and [510, 500] ms on the fake clock
    assert st["p99_ms"] == pytest.approx(509.5)
    assert st["p50_ms"] == pytest.approx(25.0)
    srv.shutdown()


def test_latency_split_service_vs_queue_wait():
    rng = np.random.default_rng(2)
    clock = FakeClock()
    srv = _server(sync=True, max_batch=8, clock=clock)
    h1 = srv.submit(Request(MV, _ops_mv(rng), formats=MV_FMT))
    clock.advance(0.1)
    h2 = srv.submit(Request(MV, _ops_mv(rng), formats=MV_FMT))
    clock.advance(0.15)
    srv.flush()                    # dispatch leaves the queue at t=0.25
    assert h1.queue_wait_s == pytest.approx(0.25)
    assert h2.queue_wait_s == pytest.approx(0.15)
    assert h1.service_s == h2.service_s == 0.0
    for h in (h1, h2):
        assert h.latency_s == pytest.approx(h.queue_wait_s + h.service_s)
    st = srv.stats()
    assert st["queue_wait_p50_ms"] == pytest.approx(200.0)
    assert st["queue_wait_p99_ms"] == pytest.approx(249.0)
    assert st["service_p50_ms"] == st["service_p99_ms"] == 0.0
    assert st["p50_ms"] == pytest.approx(200.0)
    srv.shutdown()


def test_sync_results_match_execute_batch_and_staged_api():
    rng = np.random.default_rng(1)
    eng = _mm_engine()
    sets = [_ops_mm(rng) for _ in range(4)]
    singles = [eng.execute(s).to_dense() for s in sets]
    batched = [o.to_dense() for o in eng.execute_batch(sets)]
    enc = eng.encode_batch(sets)
    staged = [o.to_dense()
              for o in eng.decode_batch(enc, eng.execute_encoded(enc))]
    srv = _server(sync=True, max_batch=4)
    served = [h.result().to_dense() for h in srv.submit_many(
        [Request(MM, s, formats=MM_FMT) for s in sets])]
    srv.shutdown()
    assert srv.stats()["dispatches"] == 1
    for got in (batched, staged, served):
        assert all(np.array_equal(a, b) for a, b in zip(singles, got))
    assert all(np.array_equal(a, s["B"] @ s["C"])
               for a, s in zip(singles, sets))


def test_sync_queue_full_rejects_with_reason():
    rng = np.random.default_rng(2)
    srv = _server(sync=True, max_batch=64, max_queue=2)
    hs = [srv.submit(Request(MV, _ops_mv(rng), formats=MV_FMT))
          for _ in range(3)]
    with pytest.raises(AdmissionError) as ei:
        hs[2].result()
    assert ei.value.reason == "queue-full"
    srv.flush()
    assert hs[0].result() is not None and hs[1].result() is not None
    assert srv.stats()["rejected"] == 1
    srv.shutdown()


# -- threaded mode: soak, coalescing, graceful shutdown ---------------------

def test_threaded_soak_mixed_exprs_bit_identical():
    """Four submitter threads x mixed expressions through the pipeline:
    every result equals the single-request engine's, and coalescing
    batched (fewer dispatches than requests)."""
    rng = np.random.default_rng(3)
    per_thread, n_threads = 6, 4
    jobs = [[("mv", _ops_mv(rng)) if rng.random() < 0.5
             else ("mm", _ops_mm(rng)) for _ in range(per_thread)]
            for _ in range(n_threads)]
    srv = _server(max_batch=4)
    results: dict = {}
    errors: list = []

    def submit_loop(ti: int):
        try:
            hs = [srv.submit(Request(MV, ops, formats=MV_FMT) if kind == "mv"
                             else Request(MM, ops, formats=MM_FMT))
                  for kind, ops in jobs[ti]]
            results[ti] = [h.result(timeout=WAIT) for h in hs]
        except Exception as e:  # noqa: BLE001 — reported by the assert
            errors.append(e)

    threads = [threading.Thread(target=submit_loop, args=(ti,))
               for ti in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    st = srv.stats()
    srv.shutdown()
    mv_eng, mm_eng = _mv_engine(), _mm_engine()
    for ti, job in enumerate(jobs):
        for (kind, ops), got in zip(job, results[ti]):
            eng = mv_eng if kind == "mv" else mm_eng
            assert np.array_equal(got.to_dense(), eng.execute(ops).to_dense())
    total = per_thread * n_threads
    assert st["completed"] == total
    assert st["dispatches"] < total
    assert st["batch_occupancy"] > 1.0


def test_first_submits_racing_start_one_pipeline():
    """Eight threads make their first submit behind one barrier: exactly
    one batcher (and one encoder, dispatcher, decoder) starts, and every
    request is served (the reference started two or three pipelines on
    one server, and a queue no encoder read could hang its handles)."""
    rng = np.random.default_rng(10)
    sets = [_ops_mv(rng) for _ in range(8)]
    srv = _server(max_batch=4)
    barrier = threading.Barrier(len(sets))
    handles = [None] * len(sets)

    def first_submit(i):
        barrier.wait(timeout=WAIT)
        handles[i] = srv.submit(Request(MV, sets[i], formats=MV_FMT))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_submit, args=(i,))
                   for i in range(len(sets))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    names = sorted(t.name for t in srv._threads)
    assert names == ["sam-serve-batcher", "sam-serve-decode",
                     "sam-serve-dispatch", "sam-serve-encode"]
    assert sum(t.name == "sam-serve-batcher" and t.is_alive()
               for t in threading.enumerate()) == 1
    srv.drain(timeout=WAIT)
    for h, s in zip(handles, sets):
        assert np.array_equal(h.result(timeout=WAIT).to_dense(),
                              s["B"] @ s["c"])
    srv.shutdown()
    assert not any(t.is_alive() for t in threading.enumerate()
                   if t.name.startswith("sam-serve-"))


def test_threaded_graceful_shutdown_drains_queue():
    rng = np.random.default_rng(4)
    srv = _server(max_batch=4)
    sets = [_ops_mv(rng) for _ in range(10)]
    hs = srv.submit_many([Request(MV, s, formats=MV_FMT) for s in sets])
    srv.shutdown(drain=True)                 # graceful: serves everything
    for h, s in zip(hs, sets):
        assert np.array_equal(h.result(timeout=WAIT).to_dense(),
                              s["B"] @ s["c"])
    # after shutdown new submissions are refused and start no thread
    h = srv.submit(Request(MV, sets[0], formats=MV_FMT))
    with pytest.raises(AdmissionError) as ei:
        h.result(timeout=WAIT)
    assert ei.value.reason == "closed"
    assert srv._threads == []


def test_shutdown_without_drain_fails_pending():
    rng = np.random.default_rng(5)
    srv = _server(sync=True, max_batch=64)     # nothing auto-dispatches
    hs = [srv.submit(Request(MV, _ops_mv(rng), formats=MV_FMT))
          for _ in range(3)]
    srv.shutdown(drain=False)
    for h in hs:
        with pytest.raises(AdmissionError) as ei:
            h.result()
        assert ei.value.reason == "shutdown"


# -- admission control -------------------------------------------------------

def _budget_case(n=16):
    """An expression whose untiled estimate is three times the budget
    (the dense C densifies, as in benchmarks/tiled_oob.py)."""
    dims = {"i": n, "j": n, "k": n}
    est = tiling.estimate_call_bytes(
        MM, Format({"B": "cc", "C": "dd"}),
        Schedule(loop_order=("i", "k", "j")), dims,
        densities={"B": 0.05, "C": 1.0})
    rng = np.random.default_rng(6)
    B = ((rng.random((n, n)) < 0.05)
         * rng.integers(1, 9, (n, n))).astype(np.float32)
    C = rng.integers(1, 9, (n, n)).astype(np.float32)
    return dims, est // 3, {"B": B, "C": C}


@pytest.mark.parametrize("admission", ["reject", "tile"])
def test_admission_over_budget_before_batching(admission):
    """"reject" refuses an over-budget request before it is batched;
    "tile" serves it out-of-core, integer-exact."""
    dims, budget, ops = _budget_case()
    srv = _server(sync=True, max_batch=2, mem_budget=budget,
                  admission=admission)
    h = srv.submit(Request(MM, ops, formats={"B": "cc", "C": "dd"},
                           dims=dims, order="ikj", density=0.05))
    srv.flush()
    st = srv.stats()
    if admission == "reject":
        with pytest.raises(AdmissionError) as ei:
            h.result()
        assert ei.value.reason == "over-budget"
        assert st["rejected"] == 1 and st["dispatches"] == 0
    else:
        assert np.array_equal(h.result().to_dense(), ops["B"] @ ops["C"])
        assert st["tiled_requests"] == 1 and st["completed"] == 1
    srv.shutdown()


def test_admission_refuses_engine_unsupported_formats():
    rng = np.random.default_rng(7)
    srv = _server(sync=True, max_batch=2)
    h = srv.submit(Request(MV, _ops_mv(rng), formats={"B": "bb", "c": "c"}))
    with pytest.raises(AdmissionError) as ei:
        h.result()
    assert ei.value.reason == "unsupported-format"
    srv.shutdown()


# -- reset: the clear_lowering_cache() analogue -----------------------------

def test_reset_releases_threads_queues_and_engines():
    rng = np.random.default_rng(8)
    baseline_threads = threading.active_count()
    srv = _server(max_batch=4)
    sets = [_ops_mv(rng) for _ in range(6)]
    hs = srv.submit_many([Request(MV, s, formats=MV_FMT) for s in sets])
    for h in hs:
        h.result(timeout=WAIT)
    assert srv.stats()["engines"] >= 1

    srv.reset()
    assert threading.active_count() == baseline_threads   # workers joined
    st = srv.stats()
    assert st["submitted"] == st["completed"] == st["dispatches"] == 0
    assert st["engines"] == 0 and st["queue_depth"] == 0
    assert st["p50_ms"] == st["p99_ms"] == 0.0

    # session 2 on the SAME server: fully functional after reset
    hs2 = srv.submit_many([Request(MV, s, formats=MV_FMT)
                           for s in sets[:4]])
    for h, s in zip(hs2, sets[:4]):
        assert np.array_equal(h.result(timeout=WAIT).to_dense(),
                              s["B"] @ s["c"])
    assert srv.stats()["completed"] == 4
    srv.shutdown()
    assert threading.active_count() == baseline_threads


def test_reset_serving_resets_every_live_server():
    rng = np.random.default_rng(9)
    a = _server(sync=True, max_batch=2)
    b = _server(sync=True, max_batch=2)
    assert a in active_servers() and b in active_servers()
    for srv in (a, b):
        hs = srv.submit_many([Request(MV, _ops_mv(rng), formats=MV_FMT)
                              for _ in range(2)])
        assert all(h.done() for h in hs)
        assert srv.stats()["completed"] == 2
    reset_serving()
    assert a.stats()["completed"] == 0 and b.stats()["completed"] == 0
    a.shutdown(), b.shutdown()


def test_result_handle_timeout_and_exception_surface():
    h = ResultHandle(FakeClock())
    with pytest.raises(TimeoutError):
        h.result(timeout=0.0)
    err = AdmissionError("nope", reason="test")
    h._fulfill(error=err)
    assert h.exception(timeout=WAIT) is err
    with pytest.raises(AdmissionError):
        h.result(timeout=WAIT)


# -- the fuzz case of tests/test_serving_fuzz.py ----------------------------

FLAVORS = {
    "mv_cc": {"expr": "x(i) = B(i,j) * c(j)",
              "formats": {"B": "cc", "c": "c"},
              "oracle": lambda o: o["B"] @ o["c"]},
    "mv_dc": {"expr": "y(i) = D(i,j) * e(j)",
              "formats": {"D": "dc", "e": "d"},
              "oracle": lambda o: o["D"] @ o["e"]},
    "mm_cc": {"expr": "X(i,j) = B(i,k) * C(k,j)",
              "formats": {"B": "cc", "C": "cc"},
              "oracle": lambda o: o["B"] @ o["C"]},
    "add_c": {"expr": "s(i) = u(i) + v(i)",
              "formats": {"u": "c", "v": "c"},
              "oracle": lambda o: o["u"] + o["v"]},
    "bv": {"expr": "x(i) = B(i,j) * c(j)",
           "formats": {"B": "bb", "c": "c"},
           "oracle": None},
}
FN = 6


def _fuzz_operands(flavor: str, rng) -> dict:
    def sp(shape):
        return ((rng.random(shape) < 0.5)
                * rng.integers(1, 9, shape)).astype(np.float32)
    if flavor in ("mv_cc", "mv_dc", "bv"):
        mat = "B" if flavor != "mv_dc" else "D"
        vec = "c" if flavor != "mv_dc" else "e"
        return {mat: sp((FN, FN)), vec: sp(FN)}
    if flavor == "mm_cc":
        return {"B": sp((FN, FN)), "C": sp((FN, FN))}
    return {"u": sp(FN), "v": sp(FN)}


@hst.composite
def interleaving(draw):
    """A random interleaved request stream over three or more cache keys
    with refused block-format requests among them."""
    seed = draw(hst.integers(0, 2 ** 31 - 1))
    max_batch = draw(hst.integers(2, 4))
    n_req = draw(hst.integers(6, 14))
    rng = np.random.default_rng(seed)
    names = list(FLAVORS)
    stream = ["mv_cc", "mv_dc", "mm_cc"]
    stream += [names[int(rng.integers(0, len(names)))]
               for _ in range(n_req - 3)]
    stream = [stream[i] for i in rng.permutation(len(stream))]
    return [(f, _fuzz_operands(f, rng)) for f in stream], max_batch


@settings(max_examples=5, deadline=None)
@given(interleaving())
def test_interleaved_batches_never_cross_contaminate(case):
    stream, max_batch = case
    srv = _server(sync=True, max_batch=max_batch)
    handles = srv.submit_many([Request(FLAVORS[f]["expr"], ops,
                                       formats=FLAVORS[f]["formats"])
                               for f, ops in stream])
    srv.flush()
    admitted = {}
    for (flavor, ops), h in zip(stream, handles):
        if flavor == "bv":
            err = h.exception()
            assert isinstance(err, AdmissionError)
            assert err.reason == "unsupported-format"
            continue
        assert np.array_equal(h.result().to_dense(),
                              FLAVORS[flavor]["oracle"](ops)), flavor
        admitted[flavor] = admitted.get(flavor, 0) + 1
    st = srv.stats()
    srv.shutdown()
    total = sum(admitted.values())
    assert st["completed"] == total
    assert st["rejected"] == len(stream) - total
    assert st["dispatches"] >= sum(-(-c // max_batch)
                                   for c in admitted.values())
    assert st["max_batch_seen"] <= max_batch


# -- the port against the reference ----------------------------------------

def _stream(rng, ops_tiled, dims_tiled):
    """(request kwargs, clock advance) in submission order: three keys
    that batch, a refused block-format request and a tiled request."""
    out = []
    for i in range(7):
        kind = ("mv", "mm", "mv", "bad", "mv", "mm", "tiled")[i]
        if kind == "mv":
            req = dict(expr=MV, arrays=_ops_mv(rng), formats=MV_FMT)
        elif kind == "mm":
            req = dict(expr=MM, arrays=_ops_mm(rng), formats=MM_FMT)
        elif kind == "bad":
            req = dict(expr=MV, arrays=_ops_mv(rng),
                       formats={"B": "bb", "c": "c"})
        else:
            req = dict(expr=MM, arrays=ops_tiled,
                       formats={"B": "cc", "C": "dd"}, dims=dims_tiled,
                       order="ikj", density=0.05)
        out.append((req, 0.01 * (i + 1)))
    return out


def test_port_server_equals_the_reference_server():
    """The same stream through the reference's sync server and the
    port's: equal dispatches, equal counters, equal results bit for bit,
    equal refusals."""
    pytest.importorskip("jax")
    from repro.core import serving as ref_serving

    dims_t, budget, ops_t = _budget_case()
    runs = {}
    for side, mod in (("ref", ref_serving),
                      ("port", sys.modules[SamServer.__module__])):
        rng = np.random.default_rng(12)
        clock = mod.FakeClock()
        kw = {"device": CPU} if side == "port" else {}
        srv = mod.SamServer(sync=True, max_batch=2, clock=clock,
                            mem_budget=budget, admission="tile", **kw)
        handles = []
        for req, dt in _stream(rng, ops_t, dims_t):
            clock.advance(dt)
            handles.append(srv.submit(mod.Request(**req)))
        clock.advance(0.25)
        srv.flush()
        outs = []
        for h in handles:
            err = h.exception(timeout=WAIT)
            outs.append(("error", type(err).__name__, err.reason)
                        if err is not None else h.result().to_dense())
        runs[side] = (srv.stats(), outs)
        srv.shutdown()
    (st_ref, out_ref), (st_port, out_port) = runs["ref"], runs["port"]
    assert st_port == st_ref
    assert st_port["dispatches"] == 4 and st_port["tiled_requests"] == 1
    assert st_port["rejected"] == 1 and st_port["completed"] == 6
    for a, b in zip(out_ref, out_port):
        if isinstance(a, tuple):
            assert a == b == ("error", "AdmissionError",
                              "unsupported-format")
        else:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
