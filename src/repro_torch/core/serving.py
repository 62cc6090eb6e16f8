"""High-throughput SAM serving: continuous batching + async dispatch.

The port of the reference's ``core/serving.py`` onto the PyTorch engine
(``core/torch_backend.py``). Three edits: ``SamServer(device=)`` places the
engines it compiles (CUDA by default, ``device="cpu"`` for the plain
PyTorch versions); the pipeline's threads start exactly once, under the
server's lock, however many first submits race; and the device stage
enters the engine's CUDA device before its first launch. Device work runs
only on the dispatch thread: ``encode_batch`` is numpy only, and
``execute_encoded`` uploads, runs the plan and brings the results back in
one transfer, so host encode and decode of neighbouring dispatches overlap
the device stage.

``launch/serve.py`` used to dispatch one request (well, one
hand-assembled batch) at a time; this module is the serving subsystem
that sits between concurrent callers and the compiled engine:

* **Continuous batching** — ``SamServer.submit`` accepts requests from
  any thread and returns a future-like ``ResultHandle``. A batcher
  coalesces queued requests *by compiled-cache key* (the process-wide
  engine identity: expression structural hash + formats + schedule +
  dims) into batched ``CompiledExpr.execute_batch`` dispatches of up to
  ``max_batch`` requests. The batcher never waits for a batch to fill —
  whatever same-key requests are queued when a dispatch slot frees go
  out together (the continuous-batching discipline), so light traffic
  keeps low latency and heavy traffic gets batched throughput.
* **Async dispatch pipeline** — each dispatch flows through three
  stages: host encode (``CompiledExpr.encode_batch``), device execute
  (``execute_encoded``), host decode (``decode_batch``), each on its own
  worker thread connected by depth-bounded queues (``pipeline_depth``,
  default 2 = double buffering). While dispatch N executes on the
  device, dispatch N+1 encodes and dispatch N-1 decodes.
* **Admission control** — with a ``mem_budget``, a request whose
  untiled allocation estimate exceeds the budget is either routed
  through the out-of-core tiled driver (``admission="tile"``, the
  default — tiled requests form their own dispatch groups and stream
  sequentially) or refused with ``AdmissionError`` *before* it enters a
  batch (``admission="reject"``). Formats the compiled engine cannot
  execute (``b`` levels outside the block-sparse patterns) are likewise
  refused at admission rather than poisoning a batch.
* **Engine stats** — ``SamServer.stats()`` snapshots queue depth, batch
  occupancy, dispatch counts, p50/p99 latency, and requests/sec.

Determinism for tests (this subsystem lands with its archetype: a
load/soak test layer): ``SamServer(sync=True)`` runs the whole pipeline
inline with NO threads — requests queue until a key reaches
``max_batch`` (auto-dispatch) or ``flush()``/``drain()`` forces the
pending groups out — and every timestamp flows through the injectable
``clock`` (``FakeClock`` advances only when told), so batching,
admission, and latency accounting are unit-testable without wall-clock
flakiness. The threaded mode uses the same code path per group; tests
synchronize on futures, never on sleeps.

>>> import numpy as np
>>> srv = SamServer(sync=True, max_batch=2, clock=FakeClock(), device="cpu")
>>> B = np.array([[1., 0.], [0., 2.]])
>>> h = [srv.submit(Request("x(i) = B(i,j) * c(j)",
...                         {"B": B, "c": np.ones(2)},
...                         formats={"B": "cc", "c": "c"}))
...      for _ in range(2)]
>>> [x.result().to_dense().tolist() for x in h]   # coalesced: 1 dispatch
[[1.0, 2.0], [1.0, 2.0]]
>>> srv.stats()["dispatches"], srv.stats()["completed"]
(1, 2)
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import coord_ops as co
from . import tiling
from .einsum import Assignment, parse
from .schedule import Format, Schedule
from .torch_backend import (CompiledExpr, CompiledProgram, TiledExpr,
                            compile_expr, compile_program)

__all__ = ["AdmissionError", "FakeClock", "Request", "ResultHandle",
           "SamServer", "active_servers", "reset_serving"]


class AdmissionError(RuntimeError):
    """A request was refused before entering a batch (over the memory
    budget with ``admission="reject"``, an engine-unsupported format,
    or a full queue). ``reason`` carries the machine-readable cause."""

    def __init__(self, message: str, *, reason: str):
        super().__init__(message)
        self.reason = reason


class FakeClock:
    """Deterministic clock for tests: returns a fixed time until
    ``advance`` moves it. Inject as ``SamServer(clock=FakeClock())`` so
    latency/throughput stats are exact, not wall-clock samples."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


@dataclasses.dataclass
class Request:
    """One serving request: an expression (or a ``;``-separated program)
    plus its operand arrays.

    ``dims`` default to the operand array shapes; ``formats`` defaults
    to all-compressed; ``schedule`` may be a ``Schedule``, ``"auto"``
    (autoscheduler + persistent schedule cache), or None for the default
    loop order (lhs vars then contraction vars, as ``launch/serve.py``
    does). ``density`` is the sparsity hint for auto scheduling and the
    admission estimate."""

    expr: str
    arrays: Dict[str, np.ndarray]
    formats: Any = None              # Format | {tensor: "cc"} | None
    dims: Optional[Dict[str, int]] = None
    schedule: Any = None             # Schedule | "auto" | None
    order: Optional[str] = None
    density: float = 0.1

    @property
    def is_program(self) -> bool:
        return ";" in self.expr


class ResultHandle:
    """Future for one submitted request. ``result()`` blocks until the
    pipeline fulfills it (already fulfilled in sync mode); failures
    re-raise the original exception (``AdmissionError`` for refused
    requests)."""

    def __init__(self, clock: Callable[[], float]):
        self._event = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self.submitted_at = clock()
        self.latency_s: Optional[float] = None       # submit -> done
        self.service_s: Optional[float] = None       # dispatch -> done
        self.queue_wait_s: Optional[float] = None    # submit -> dispatch

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("request not fulfilled within timeout")
        if self._error is not None:
            raise self._error
        return self._result

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise TimeoutError("request not fulfilled within timeout")
        return self._error

    def _fulfill(self, result=None, error: Optional[BaseException] = None,
                 latency_s: Optional[float] = None,
                 service_s: Optional[float] = None,
                 queue_wait_s: Optional[float] = None) -> None:
        self._result, self._error = result, error
        self.latency_s = latency_s
        self.service_s = service_s
        self.queue_wait_s = queue_wait_s
        self._event.set()


@dataclasses.dataclass
class _EngineEntry:
    """A resolved engine + its dispatch discipline."""

    engine: Any
    kind: str          # "batch" | "many" | "seq" | "program"


@dataclasses.dataclass
class _Group:
    """One coalesced dispatch: same-engine requests travelling the
    pipeline together."""

    entry: _EngineEntry
    handles: List[ResultHandle]
    arrays: List[Dict[str, np.ndarray]]
    started_at: float = 0.0     # when the dispatch left the queue
    enc: Any = None
    out: Any = None
    results: Optional[List] = None
    error: Optional[BaseException] = None


def _engine_kind(engine) -> str:
    from .bsr_bridge import BsrEngine
    from .dist_exec import DistTiledExpr

    if isinstance(engine, CompiledProgram):
        return "program"
    if isinstance(engine, (TiledExpr, DistTiledExpr, BsrEngine)):
        return "seq"       # tiles stream sequentially (or fan out over
        #                    workers inside the request); no batch axis
    # a batch keeps its lanes in series, so an engine whose lanes spread
    # over a lane mesh serves requests one by one (each its own mesh run)
    if isinstance(engine, CompiledExpr) and engine._shard_lanes:
        return "many"
    return "batch"


def _on_device(engine):
    """The engine's CUDA device as the calling thread's current device (a
    worker thread starts on device 0), or nothing for a CPU engine. An
    engine over a lane mesh enters each lane device's in turn as it runs
    that device's lanes."""
    dev = getattr(engine, "device", None)
    if dev is not None and torch.device(dev).type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


# compile_expr/compile_program mutate process-wide caches; serialize
# them when requests arrive from many threads
_COMPILE_LOCK = threading.Lock()
# device dispatch is owned by one thread per server; a process running
# several servers still serializes device work through this lock
_DISPATCH_LOCK = threading.Lock()

_REGISTRY: "weakref.WeakSet[SamServer]" = weakref.WeakSet()


def active_servers() -> List["SamServer"]:
    """The live (not yet garbage-collected) ``SamServer`` instances."""
    return list(_REGISTRY)


def reset_serving() -> None:
    """``clear_lowering_cache()``-style reset for the serving layer:
    drain and reset every live server (threads joined, queues emptied,
    stats zeroed, compiled-engine handles dropped). Back-to-back serve
    sessions in one process start clean."""
    for srv in active_servers():
        srv.reset()


class SamServer:
    """Concurrent SAM serving front-end (see module docstring).

    Args:
        max_batch: coalescing cap — at most this many same-key requests
            per dispatch.
        mem_budget: peak device-allocation budget (bytes or ``"64MB"``);
            admission control measures every expression request's
            untiled estimate against it.
        admission: ``"tile"`` routes over-budget requests out-of-core,
            ``"reject"`` refuses them with ``AdmissionError``.
        sync: True runs the pipeline inline (no threads, deterministic;
            requests queue until auto-dispatch at ``max_batch`` or an
            explicit ``flush()``/``drain()``).
        clock: timestamp source (``time.monotonic`` by default;
            ``FakeClock`` for deterministic tests). Every latency and
            throughput figure flows through it.
        pipeline_depth: bound of the inter-stage queues (2 = double
            buffering).
        max_queue: admission bound on the pending-request queue; beyond
            it requests are refused (reason ``"queue-full"``).
        devices: shard parallel lanes of scheduled requests over this
            many devices (forwarded to ``compile_expr(shard_lanes=)``);
            such an engine serves requests one by one.
        device: where the engines this server compiles run (forwarded to
            ``compile_expr`` and ``compile_program``): CUDA by default,
            an error without a GPU; ``"cpu"`` for the plain PyTorch
            versions. A precompiled ``engine=`` keeps its own.
    """

    def __init__(self, *, max_batch: int = 8, mem_budget=None,
                 admission: str = "tile", sync: bool = False,
                 clock: Optional[Callable[[], float]] = None,
                 pipeline_depth: int = 2, max_queue: int = 4096,
                 devices: Optional[int] = None, device=None):
        if admission not in ("tile", "reject"):
            raise ValueError(f"admission must be 'tile' or 'reject', "
                             f"got {admission!r}")
        if max_batch < 1 or pipeline_depth < 1 or max_queue < 1:
            raise ValueError("max_batch, pipeline_depth and max_queue "
                             "must be >= 1")
        self.max_batch = max_batch
        self.mem_budget = (None if mem_budget is None
                           else tiling.parse_budget(mem_budget))
        self.admission = admission
        self.devices = devices
        self.device = co.resolve_device(device)
        self._sync = sync
        self._clock = clock or time.monotonic
        self._depth = pipeline_depth
        self.max_queue = max_queue
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._done = threading.Condition(self._lock)
        self._queue: deque = deque()      # (key, handle, entry, arrays)
        self._engines: Dict[Any, _EngineEntry] = {}
        self._threads: List[threading.Thread] = []
        self._stage_qs: List["queue.Queue"] = []
        self._closing = False
        self._reset_counters()
        _REGISTRY.add(self)

    # -- lifecycle -------------------------------------------------------
    def _reset_counters(self) -> None:
        self._submitted = 0
        self._completed = 0
        self._failed = 0
        self._rejected = 0
        self._dispatches = 0
        self._batched_requests = 0
        self._tiled_requests = 0
        self._max_batch_seen = 0
        self._max_queue_depth = 0
        self._latencies: deque = deque(maxlen=4096)
        self._service_lat: deque = deque(maxlen=4096)
        self._queue_waits: deque = deque(maxlen=4096)
        self._first_submit_t: Optional[float] = None
        self._last_done_t: Optional[float] = None

    def _ensure_threads(self) -> None:
        """Start the pipeline lazily on first threaded submit. The caller
        holds ``self._lock``, so concurrent first submits start exactly
        one pipeline (checking ``_threads`` outside it let two or three
        start, each replacing ``_stage_qs``); a closed server starts
        none."""
        if self._sync or self._threads or self._closing:
            return
        self._stage_qs = [queue.Queue(self._depth) for _ in range(3)]
        stages = [("sam-serve-batcher", self._batcher_loop),
                  ("sam-serve-encode", self._encode_loop),
                  ("sam-serve-dispatch", self._dispatch_loop),
                  ("sam-serve-decode", self._decode_loop)]
        for name, fn in stages:
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def shutdown(self, drain: bool = True) -> None:
        """Stop the server. ``drain=True`` (graceful, the default)
        serves every queued request first; ``drain=False`` fails pending
        requests with ``AdmissionError(reason="shutdown")``."""
        with self._lock:
            if self._closing and not self._threads:
                return
            self._closing = True
            threads, self._threads = self._threads, []
            if not drain:
                while self._queue:
                    _, handle, _, _ = self._queue.popleft()
                    handle._fulfill(error=AdmissionError(
                        "server shut down before dispatch",
                        reason="shutdown"))
                    self._rejected += 1
                self._done.notify_all()
            self._work.notify_all()
        if self._sync:
            if drain:
                self.flush()
            return
        for t in threads:
            t.join(timeout=600)
        self._stage_qs = []

    def reset(self) -> None:
        """Drain, stop, and return to the just-constructed state: queues
        empty, no worker threads, stats zeroed, compiled-engine handles
        dropped (a later session re-resolves engines, so caches cleared
        elsewhere cannot leave stale handles here). The server is
        reusable after reset."""
        self.shutdown(drain=True)
        with self._lock:
            self._queue.clear()
            self._engines.clear()
            self._reset_counters()
            self._closing = False

    def __enter__(self) -> "SamServer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=not any(exc))

    # -- admission + engine resolution ----------------------------------
    def _derive_dims(self, assign: Assignment,
                     arrays: Dict[str, np.ndarray]) -> Dict[str, int]:
        dims: Dict[str, int] = {}
        for term in assign.terms:
            for acc in term.factors:
                arr = np.asarray(arrays[acc.tensor])
                if arr.ndim != len(acc.vars):
                    raise ValueError(
                        f"{acc.tensor} is rank {arr.ndim}, accessed with "
                        f"{len(acc.vars)} indices")
                for v, d in zip(acc.vars, arr.shape):
                    if dims.setdefault(v, d) != d:
                        raise ValueError(
                            f"extent of {v} disagrees across operands: "
                            f"{dims[v]} vs {d}")
        return dims

    def _check_formats(self, fmt: Format, assign: Assignment) -> None:
        from .bsr_bridge import bsr_pattern

        if bsr_pattern(assign, fmt) is not None:
            # block-format contractions in SpMM/SDDMM/attention shape
            # execute on the BSR kernels (core/bsr_bridge.py) — admitted
            return
        tensors = {a.tensor: len(a.vars) for t in assign.terms
                   for a in t.factors}
        tensors[assign.lhs.tensor] = len(assign.lhs.vars)
        for name, order in tensors.items():
            levels = fmt.of(name, order) or ""
            # s/h/m storage canonicalizes to d/c on engine ingest
            # (torch_backend._engine_tree); only 'b' levels outside the
            # block-sparse patterns remain simulator-only
            bad = set(levels) - set("dcshm")
            if bad:
                raise AdmissionError(
                    f"{name}={levels}: the compiled engine serves "
                    f"d/c/s/h/m level formats; {sorted(bad)} run on the "
                    f"simulator only", reason="unsupported-format")

    def _resolve_engine(self, req: Request) -> Tuple[Any, _EngineEntry,
                                                     Dict[str, np.ndarray]]:
        """Admission-check and compile (process-wide cached) the engine
        for one request; returns (group key, entry, arrays)."""
        fmt = req.formats if isinstance(req.formats, Format) \
            else Format(dict(req.formats or {}))
        if req.is_program:
            from .program import parse_program

            prog = parse_program(req.expr)
            if req.dims:
                dims = dict(req.dims)
            else:
                dims = {}
                for a in prog.assigns:
                    for t in a.terms:
                        for f in t.factors:
                            if f.tensor in req.arrays:
                                arr = np.asarray(req.arrays[f.tensor])
                                for v, d in zip(f.vars, arr.shape):
                                    dims[v] = d
                for a in prog.assigns:
                    for v in a.all_vars:
                        if not dims.get(v):
                            raise ValueError(f"extent of {v} not derivable "
                                             f"from operands; pass dims=")
            schedules = req.schedule
            if schedules is None:
                schedules = {a.lhs.tensor: Schedule(
                    loop_order=tuple(a.all_vars)) for a in prog.assigns}
            with _COMPILE_LOCK:
                cp = compile_program(prog, fmt, schedules, dims,
                                     sparsity=req.density,
                                     mem_budget=self.mem_budget,
                                     device=self.device)
            return id(cp), _EngineEntry(cp, "program"), dict(req.arrays)

        assign = parse(req.expr)
        self._check_formats(fmt, assign)
        dims = dict(req.dims) if req.dims \
            else self._derive_dims(assign, req.arrays)
        schedule = req.schedule
        if schedule is None:
            order = req.order or "".join(assign.all_vars)
            schedule = Schedule(loop_order=tuple(order))
        try:
            with _COMPILE_LOCK:
                eng = compile_expr(
                    assign, fmt, schedule, dims, sparsity=req.density,
                    shard_lanes=self.devices,
                    mem_budget=self.mem_budget,
                    auto_tile=self.admission == "tile", device=self.device)
        except tiling.MemoryBudgetExceeded as e:
            raise AdmissionError(
                f"request refused by admission control: {e}",
                reason="over-budget") from e
        return id(eng), _EngineEntry(eng, _engine_kind(eng)), dict(req.arrays)

    # -- submission ------------------------------------------------------
    def submit(self, req: Request, *, engine=None) -> ResultHandle:
        """Enqueue one request; returns its ``ResultHandle`` immediately.

        Refused requests (admission/queue bound/closed server) come back
        as handles whose ``result()`` raises ``AdmissionError`` — a
        rejected request never fails the submitting thread mid-burst.
        ``engine`` bypasses resolution with a precompiled
        ``CompiledExpr``/``TiledExpr``/``CompiledProgram`` (the
        ``launch/serve.py`` path, which compiles first to log routing).
        """
        return self._submit_all([req], engine=engine)[0]

    def submit_many(self, reqs: Sequence[Request], *, engine=None
                    ) -> List[ResultHandle]:
        """Enqueue a burst atomically: every request is queued before the
        batcher sees any of them, so a full burst coalesces into
        ``ceil(n / max_batch)`` dispatches per key deterministically."""
        return self._submit_all(list(reqs), engine=engine)

    def _submit_all(self, reqs: List[Request], *, engine=None
                    ) -> List[ResultHandle]:
        handles = []
        resolved = []
        for req in reqs:
            handle = ResultHandle(self._clock)
            handles.append(handle)
            try:
                if engine is not None:
                    key, entry, arrays = (id(engine),
                                          _EngineEntry(engine,
                                                       _engine_kind(engine)),
                                          dict(req.arrays))
                else:
                    key, entry, arrays = self._resolve_engine(req)
            except AdmissionError as e:
                with self._lock:
                    self._submitted += 1
                    self._rejected += 1
                    self._done.notify_all()
                handle._fulfill(error=e)
                continue
            resolved.append((key, handle, entry, arrays))
        with self._lock:
            for key, handle, entry, arrays in resolved:
                self._submitted += 1
                if self._first_submit_t is None:
                    self._first_submit_t = handle.submitted_at
                if self._closing:
                    self._rejected += 1
                    self._done.notify_all()
                    handle._fulfill(error=AdmissionError(
                        "server is shut down", reason="closed"))
                    continue
                if len(self._queue) >= self.max_queue:
                    self._rejected += 1
                    self._done.notify_all()
                    handle._fulfill(error=AdmissionError(
                        f"queue full ({self.max_queue} pending)",
                        reason="queue-full"))
                    continue
                self._engines[key] = entry
                self._queue.append((key, handle, entry, arrays))
                self._max_queue_depth = max(self._max_queue_depth,
                                            len(self._queue))
            self._work.notify_all()
            self._ensure_threads()
        if self._sync:
            self._sync_auto_dispatch()
        return handles

    # -- coalescing ------------------------------------------------------
    def _pop_group_locked(self) -> Optional[_Group]:
        """Pop the head request plus every queued same-key request, up to
        ``max_batch`` (continuous batching: no waiting for a full batch).
        Caller holds the lock."""
        if not self._queue:
            return None
        key0, handle, entry, arrays = self._queue.popleft()
        group = _Group(entry=entry, handles=[handle], arrays=[arrays],
                       started_at=self._clock())
        if len(group.handles) < self.max_batch:
            keep = deque()
            while self._queue:
                item = self._queue.popleft()
                if item[0] == key0 and len(group.handles) < self.max_batch:
                    group.handles.append(item[1])
                    group.arrays.append(item[3])
                else:
                    keep.append(item)
            self._queue = keep
        return group

    # -- the pipeline stages --------------------------------------------
    def _stage_encode(self, group: _Group) -> None:
        try:
            if group.entry.kind == "batch":
                group.enc = group.entry.engine.encode_batch(group.arrays)
        except Exception as e:  # noqa: BLE001 — fail the group, not the server
            group.error = e

    def _stage_execute(self, group: _Group) -> None:
        if group.error is not None:
            return
        eng = group.entry.engine
        try:
            with _DISPATCH_LOCK, _on_device(eng):
                if group.entry.kind == "batch":
                    group.out = eng.execute_encoded(group.enc)
                elif group.entry.kind == "many":
                    group.results = eng.execute_many(group.arrays)
                elif group.entry.kind == "seq":
                    group.results = eng.execute_batch(group.arrays)
                else:                                    # program
                    group.results = [eng(a) for a in group.arrays]
        except Exception as e:  # noqa: BLE001
            group.error = e

    def _stage_decode(self, group: _Group) -> None:
        if group.error is None and group.entry.kind == "batch":
            try:
                group.results = group.entry.engine.decode_batch(group.enc,
                                                                group.out)
            except Exception as e:  # noqa: BLE001
                group.error = e
        now = self._clock()
        results = group.results or []
        # service latency runs dispatch-start -> done; queue wait runs
        # submit -> dispatch-start. Together they partition the
        # queue-inclusive latency, so a burst submit no longer makes the
        # service figure look pathological (see stats()).
        service = now - group.started_at
        for i, handle in enumerate(group.handles):
            lat = now - handle.submitted_at
            wait = group.started_at - handle.submitted_at
            if group.error is not None:
                handle._fulfill(error=group.error, latency_s=lat,
                                service_s=service, queue_wait_s=wait)
            else:
                handle._fulfill(result=results[i], latency_s=lat,
                                service_s=service, queue_wait_s=wait)
        with self._lock:
            n = len(group.handles)
            self._dispatches += 1
            self._batched_requests += n
            self._max_batch_seen = max(self._max_batch_seen, n)
            if group.entry.kind == "seq":
                self._tiled_requests += n
            if group.error is not None:
                self._failed += n
            else:
                self._completed += n
                self._latencies.extend(h.latency_s for h in group.handles)
                self._service_lat.extend(h.service_s
                                         for h in group.handles)
                self._queue_waits.extend(h.queue_wait_s
                                         for h in group.handles)
            self._last_done_t = now
            self._done.notify_all()

    def _run_group(self, group: _Group) -> None:
        self._stage_encode(group)
        self._stage_execute(group)
        self._stage_decode(group)

    # -- worker loops (threaded mode) -----------------------------------
    def _batcher_loop(self) -> None:
        enc_q = self._stage_qs[0]
        while True:
            with self._lock:
                while not self._queue and not self._closing:
                    self._work.wait()
                if not self._queue and self._closing:
                    break
                group = self._pop_group_locked()
                self._done.notify_all()     # flush() watches queue_depth
            if group is not None:
                enc_q.put(group)
        enc_q.put(None)

    def _encode_loop(self) -> None:
        enc_q, run_q = self._stage_qs[0], self._stage_qs[1]
        while True:
            group = enc_q.get()
            if group is None:
                run_q.put(None)
                break
            self._stage_encode(group)
            run_q.put(group)

    def _dispatch_loop(self) -> None:
        run_q, dec_q = self._stage_qs[1], self._stage_qs[2]
        while True:
            group = run_q.get()
            if group is None:
                dec_q.put(None)
                break
            self._stage_execute(group)
            dec_q.put(group)

    def _decode_loop(self) -> None:
        dec_q = self._stage_qs[2]
        while True:
            group = dec_q.get()
            if group is None:
                break
            self._stage_decode(group)

    # -- sync mode -------------------------------------------------------
    def _sync_auto_dispatch(self) -> None:
        """Dispatch every key whose pending count reached ``max_batch``
        (deterministic inline continuous batching)."""
        while True:
            with self._lock:
                counts: Dict[Any, int] = {}
                for key, *_ in self._queue:
                    counts[key] = counts.get(key, 0) + 1
                full = next((k for k, c in counts.items()
                             if c >= self.max_batch), None)
                if full is None:
                    return
                # rotate the full key's requests to the head, then pop
                rest = deque(x for x in self._queue if x[0] != full)
                head = deque(x for x in self._queue if x[0] == full)
                self._queue = head + rest
                group = self._pop_group_locked()
            self._run_group(group)

    def flush(self) -> None:
        """Dispatch every pending request now. Sync mode: runs the
        groups inline. Threaded mode: the batcher never lingers, so this
        just waits for the queue to empty (dispatches may still be in
        flight — use ``drain`` to wait for completion)."""
        if self._sync:
            while True:
                with self._lock:
                    group = self._pop_group_locked()
                if group is None:
                    return
                self._run_group(group)
        else:
            with self._lock:
                self._work.notify_all()
                while self._queue and self._threads:
                    self._done.wait(timeout=0.1)

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted request is fulfilled (sync mode:
        flush inline)."""
        if self._sync:
            self.flush()
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while (self._completed + self._failed + self._rejected
                   < self._submitted):
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("drain timed out with "
                                       f"{self.pending} requests pending")
                self._done.wait(timeout=remaining if remaining is not None
                                else 0.5)

    # -- introspection ---------------------------------------------------
    @property
    def pending(self) -> int:
        with self._lock:
            return (self._submitted - self._completed - self._failed
                    - self._rejected)

    def stats(self) -> Dict[str, Any]:
        """Snapshot of the serving counters (all timing through the
        injected clock).

        Keys: ``submitted/completed/failed/rejected``, ``queue_depth``
        (now) and ``max_queue_depth``, ``dispatches`` and
        ``batched_requests`` (their ratio is ``batch_occupancy``),
        ``max_batch_seen``, ``tiled_requests`` (admitted out-of-core),
        ``p50_ms``/``p99_ms`` over the completed-request latencies, and
        ``requests_per_sec`` (completed over first-submit→last-done).

        ``p50_ms``/``p99_ms`` are *queue-inclusive* (submit → done), so a
        burst submit inflates them with queue wait.
        ``service_p50_ms``/``service_p99_ms`` cover only dispatch-start →
        done, and ``queue_wait_p50_ms``/``queue_wait_p99_ms`` cover
        submit → dispatch-start; use those to tell congestion apart from
        slow execution."""

        def _pcts(samples: deque) -> tuple:
            arr = np.asarray(samples, dtype=float)
            if not arr.size:
                return 0.0, 0.0
            return (float(np.percentile(arr, 50) * 1e3),
                    float(np.percentile(arr, 99) * 1e3))

        with self._lock:
            lat = np.asarray(self._latencies, dtype=float)
            service_p50, service_p99 = _pcts(self._service_lat)
            wait_p50, wait_p99 = _pcts(self._queue_waits)
            elapsed = None
            if self._first_submit_t is not None and self._last_done_t:
                elapsed = self._last_done_t - self._first_submit_t
            return {
                "submitted": self._submitted,
                "completed": self._completed,
                "failed": self._failed,
                "rejected": self._rejected,
                "queue_depth": len(self._queue),
                "max_queue_depth": self._max_queue_depth,
                "dispatches": self._dispatches,
                "batched_requests": self._batched_requests,
                "batch_occupancy": (self._batched_requests
                                    / self._dispatches
                                    if self._dispatches else 0.0),
                "max_batch_seen": self._max_batch_seen,
                "tiled_requests": self._tiled_requests,
                "engines": len(self._engines),
                "p50_ms": float(np.percentile(lat, 50) * 1e3)
                if lat.size else 0.0,
                "p99_ms": float(np.percentile(lat, 99) * 1e3)
                if lat.size else 0.0,
                "service_p50_ms": service_p50,
                "service_p99_ms": service_p99,
                "queue_wait_p50_ms": wait_p50,
                "queue_wait_p99_ms": wait_p99,
                "elapsed_s": elapsed or 0.0,
                "requests_per_sec": (self._completed / elapsed
                                     if elapsed else 0.0),
            }
