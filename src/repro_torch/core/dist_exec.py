"""Distributed 2-D (tiles x lanes) execution with fault-tolerant retry.

The port of the reference's ``core/dist_exec.py`` onto the PyTorch engine.
Workers are placed over a ``launch.mesh.Mesh`` of torch devices (the CUDA
devices present, or the CPU for a CPU engine): worker ``i`` gets device
``i mod D``, and a tile dispatches on its worker's device through a
per-tile engine placed there (the tiled engine's own where the devices
agree, so on one card every worker shares it). Retry, worker loss, fail
limits, timeouts, the straggler watchdog and the grid-order fold through
``coord_ops.accumulate_coo`` are the reference's, so a result is
bit-identical to the port's ``TiledExpr`` for any worker count and
completion order. Tile partials wait on the host; a tile's working set
is on the device only while ``_DEVICE_LOCK`` is held, so the card holds
what one tile of the ``TiledExpr`` holds.

``TiledExpr`` (DESIGN.md §7) streams the ``plan_tiles`` coordinate grid
sequentially through one device; this module fans the SAME grid out over
a set of workers — the Stardust move: place independent units of work on
separate fabric resources and tolerate the fabric's failures. The two
parallel axes compose: each tile dispatch still runs its schedule's
parallel LANES (§4.4, one after another on the tile's device) inside the
per-tile engine, while independent TILES spread across workers — a 2-D
(tiles x lanes) machine.

* **Workers are simulated fabric slots.** ``worker_devices`` lays the
  logical workers over the host's devices (``launch.mesh.make_local_mesh``;
  the fan-out axis is the mesh's data-parallel group from
  ``distributed.sharding``). With fewer physical devices than workers —
  one GPU, or the CPU — workers share devices round-robin; with
  several GPUs each worker owns one and tile dispatches place onto it.
* **Pipelined overlap.** Per worker, a host-encode thread (operand
  slicing + flat padding) feeds a device-compute thread through a
  depth-bounded queue — the serving pipeline's discipline (DESIGN.md
  §9): while worker w computes tile t, its encoder prepares tile t+1.
  Every timestamp flows through an injectable ``clock``, so the chaos
  tests run on a ``FakeClock`` with no wall-clock sleeps. Overlap
  defaults to ``"auto"``: threads spawn only when the live workers own
  more than one distinct physical device. When every worker shares one
  device (the plain-CPU case), ``_DEVICE_LOCK`` serializes all compute
  anyway, so 2x-workers threads add scheduler contention and GIL churn
  without overlapping anything — at 4 workers on one CPU that showed up
  as ~1.8x WORSE wall than 1 worker. ``overlap=True`` still forces the
  threaded scheduler (the chaos tests exercise it on shared devices);
  ``overlap=False`` forces inline.
* **Deterministic merge.** Completed tile partials are held per tile
  index and folded through ``coord_ops.accumulate_coo`` in tile-grid
  order AFTER the fan-out completes — the exact left-fold the
  single-device ``TiledExpr`` performs — so the result bytes are
  identical to sequential execution no matter which worker finished
  first (``merge_partials``).
* **Fault tolerance for real.** A failed tile dispatch (raised, injected
  via ``InjectedFault``, or over ``tile_timeout_s`` on the injected
  clock) is retried on a surviving worker; a worker that dies (injected
  ``kill``) or keeps failing (``worker_fail_limit``) is dropped and the
  run re-plans onto the shrunken worker set, shrinking the device mesh
  through ``distributed.elastic.shrink_mesh``. Per-tile durations feed a
  ``distributed.fault_tolerance.StragglerPolicy`` watchdog. Failures
  carry machine-readable reasons mirroring ``AdmissionError.reason``
  (``failure_log``; terminal ``DistributedError.reason`` is
  ``"retries-exhausted"`` or ``"no-workers"``). DESIGN.md §10 draws the
  state machine.

>>> import numpy as np
>>> from repro_torch.core.schedule import Format, Schedule
>>> dist = dist_compile("x(i) = B(i,j) * c(j)",
...                     Format({"B": "cc", "c": "c"}),
...                     Schedule(loop_order=("i", "j"), tile={"j": 2}),
...                     {"i": 2, "j": 4}, workers=2, device="cpu")
>>> B = np.array([[1., 0., 2., 0.], [0., 3., 0., 1.]])
>>> dist({"B": B, "c": np.ones(4)}).to_dense()
array([3., 4.])
>>> dist.stats["tiles"], dist.stats["workers"]
(2, 2)
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import coord_ops as co
from . import tiling
from .fibertree import FiberTree
from .torch_backend import TiledExpr, _placed, compile_expr
from ..distributed import elastic
from ..distributed.fault_tolerance import StragglerPolicy
from ..distributed.sharding import data_axes
from ..launch.mesh import make_local_mesh

__all__ = ["DistTiledExpr", "DistributedError", "FaultInjector",
           "InjectedFault", "dist_compile", "worker_devices"]


# tile dispatches from many workers serialize device entry (one physical
# host); the encode stages overlap freely around it
_DEVICE_LOCK = threading.Lock()


class DistributedError(RuntimeError):
    """A distributed tile run failed in a way retry + re-plan could not
    absorb. ``reason`` is machine-readable, mirroring
    ``serving.AdmissionError.reason``:

    * ``"retries-exhausted"`` — one tile failed ``max_attempts`` times
      across (surviving) workers;
    * ``"no-workers"`` — every worker died before the grid completed.
    """

    def __init__(self, message: str, *, reason: str):
        super().__init__(message)
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class InjectedFault:
    """Deterministic chaos hook: fires when tile ``tile`` (its flat
    ``tiling.tile_grid`` index) is dispatched to worker ``worker`` on
    attempt ``attempt`` (0 = the first dispatch of that tile).

    ``kind``:

    * ``"fail"`` — that one dispatch raises; the tile retries on a
      surviving worker (reason ``"injected-fail"``);
    * ``"kill"`` — the dispatch raises AND the worker dies mid-run: its
      in-flight tiles re-assign and the worker set shrinks (the elastic
      re-plan; reason ``"injected-kill"``);
    * ``"slow"`` — the dispatch completes but takes ``dt`` extra seconds
      on the injected clock (a straggler; over ``tile_timeout_s`` it is
      detected as a timeout failure, reason ``"tile-timeout"``).
    """

    tile: int
    worker: int
    attempt: int = 0
    kind: str = "fail"          # "fail" | "kill" | "slow"
    dt: float = 0.0

    def __post_init__(self):
        if self.kind not in ("fail", "kill", "slow"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultInjector:
    """Lookup table of ``InjectedFault`` keyed on (tile, worker, attempt);
    ``fired`` records every fault that actually triggered."""

    def __init__(self, faults: Sequence[InjectedFault] = ()):
        self.faults = {(f.tile, f.worker, f.attempt): f for f in faults}
        self.fired: List[InjectedFault] = []
        self._lock = threading.Lock()

    def check(self, tile: int, worker: int,
              attempt: int) -> Optional[InjectedFault]:
        f = self.faults.get((tile, worker, attempt))
        if f is not None:
            with self._lock:
                self.fired.append(f)
        return f


class _TileFailure(Exception):
    """Internal: one tile dispatch failed. ``reason`` is the
    machine-readable cause; ``kill`` marks the worker dead too."""

    def __init__(self, message: str, *, reason: str, kill: bool = False):
        super().__init__(message)
        self.reason = reason
        self.kill = kill


@dataclasses.dataclass
class _Worker:
    wid: int
    device: Any
    alive: bool = True
    failures: int = 0
    tiles_done: int = 0


def worker_devices(n: int, device=None):
    """Place ``n`` logical workers over the host mesh of ``device``'s
    kind (``make_local_mesh``: every CUDA device by default, the CPU for
    ``"cpu"``): worker ``i`` gets device ``i mod D`` of the mesh's device
    list (simulated workers share devices when ``n`` exceeds the device
    count). Returns ``(mesh, [device per worker])``; the fan-out axis is
    the mesh's data-parallel group (``distributed.sharding.data_axes``)."""
    mesh = make_local_mesh(device=device)
    devs = list(np.asarray(mesh.devices).reshape(-1))
    return mesh, [devs[i % len(devs)] for i in range(n)]


class DistTiledExpr:
    """Distributed driver around one ``TiledExpr``: the tile grid fans
    out over ``workers`` simulated workers with per-worker encode/compute
    pipelining, fault-tolerant retry, and a deterministic grid-order
    merge (module docstring; DESIGN.md §10).

    Quacks like ``TiledExpr`` for the serving paths (``__call__`` /
    ``execute`` / ``execute_batch`` / ``execute_many`` / ``stats``), so
    ``SamServer`` and ``launch/serve.py --workers N`` route over-budget
    tiled requests through it unchanged.
    """

    def __init__(self, tiled: TiledExpr, *, workers: int = 2,
                 clock: Optional[Callable[[], float]] = None,
                 max_attempts: int = 3, worker_fail_limit: int = 2,
                 faults: Any = None, overlap: Any = "auto",
                 pipeline_depth: int = 2,
                 tile_timeout_s: Optional[float] = None,
                 straggler: Optional[StragglerPolicy] = None):
        if not isinstance(tiled, TiledExpr):
            raise TypeError(
                "DistTiledExpr drives a TiledExpr — compile with a "
                "Schedule.tile or a mem_budget that forces one "
                "(dist_compile does both steps)")
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if max_attempts < 1 or worker_fail_limit < 0 or pipeline_depth < 1:
            raise ValueError("max_attempts/pipeline_depth must be >= 1 "
                             "and worker_fail_limit >= 0")
        self.tiled = tiled
        self.engine = tiled.engine
        # the per-tile engine on each worker device (compiled on first
        # use where a worker's device is not the tiled engine's)
        self._engines = {_placed(tiled.device): tiled.engine}
        self._clock = clock or time.monotonic
        self.max_attempts = max_attempts
        self.worker_fail_limit = worker_fail_limit
        self.overlap = overlap
        self.pipeline_depth = pipeline_depth
        self.tile_timeout_s = tile_timeout_s
        self.faults = (faults if isinstance(faults, FaultInjector)
                       else FaultInjector(faults or ()))
        self.straggler = straggler or StragglerPolicy()
        self.mesh, devices = worker_devices(workers, tiled.device.type)
        self.tile_axes = data_axes(self.mesh)    # the fan-out mesh group
        self.workers = [_Worker(i, devices[i]) for i in range(workers)]
        self._lock = threading.Lock()
        self.failure_log: List[Dict[str, Any]] = []
        self.stats: Dict[str, Any] = {
            "calls": 0, "tiles": tiled.n_tiles, "tile_calls": 0,
            "retries": 0, "failures": 0, "workers": workers,
            "workers_lost": 0, "replans": 0, "stragglers": 0,
            "timeouts": 0, "batch_calls": 0,
        }

    # -- facets the serving paths read ----------------------------------
    @property
    def tile_of(self):
        return self.tiled.tile_of

    @property
    def n_tiles(self) -> int:
        return self.tiled.n_tiles

    @property
    def tile_bytes(self) -> int:
        return self.tiled.tile_bytes

    @property
    def assign(self):
        return self.tiled.assign

    @property
    def dims(self):
        return self.tiled.dims

    @property
    def low(self):
        return self.tiled.low

    @property
    def par_n(self) -> int:
        return self.tiled.par_n

    @property
    def device(self) -> torch.device:
        return self.tiled.device

    @property
    def live_workers(self) -> List[int]:
        return [w.wid for w in self.workers if w.alive]

    def revive(self) -> None:
        """Restore every worker (fresh fabric after a chaotic run); the
        device mesh is rebuilt to full size."""
        self.mesh, devices = worker_devices(len(self.workers),
                                            self.tiled.device.type)
        for w, dev in zip(self.workers, devices):
            w.alive, w.failures, w.device = True, 0, dev

    # -- per-tile stages -------------------------------------------------
    def _engine_on(self, device):
        """The per-tile engine placed on ``device``: the tiled engine's
        own, or the same expression, schedule and extents compiled there
        (process-wide cached, so every call reuses its plans)."""
        dev = _placed(device)
        with self._lock:
            eng = self._engines.get(dev)
            if eng is None:
                e = self.engine
                eng = compile_expr(e.assign, e.fmt, e.schedule, e.dims,
                                   use_kernels=self.tiled.use_kernels,
                                   device=dev)
                self._engines[dev] = eng
        return eng

    def _encode_tile(self, arrays: Dict[str, np.ndarray],
                     tids: Dict[str, int], worker: _Worker):
        """Host stage: slice the operands to one tile and pad the flats
        to the shared input signature (no device work)."""
        t = self.tiled
        sliced = tiling.slice_operands(t.assign, arrays, t.dims,
                                       t.tile_of, tids)
        eng = self._engine_on(worker.device)
        return eng._pad_flat(eng._raw_flat(sliced), t._hints)

    def _compute_tile(self, flat, sig, idx: int, tids: Dict[str, int],
                      worker: _Worker, attempt: int):
        """Device stage: dispatch one encoded tile on the worker's
        device, firing any injected fault for (tile, worker, attempt).
        Returns the partial — (global int64 keys, vals), or a float for
        scalar expressions."""
        t0 = self._clock()
        f = self.faults.check(idx, worker.wid, attempt)
        if f is not None and f.kind in ("fail", "kill"):
            raise _TileFailure(
                f"injected {f.kind}: tile {idx} on worker {worker.wid} "
                f"attempt {attempt}", reason=f"injected-{f.kind}",
                kill=f.kind == "kill")
        if f is not None and f.kind == "slow" and hasattr(self._clock,
                                                          "advance"):
            self._clock.advance(f.dt)     # injected straggling time
        # the tile runs on the worker's device (its per-tile engine is
        # placed there), entered as the thread's current CUDA device
        eng = self._engine_on(worker.device)
        with _DEVICE_LOCK:
            if eng.device.type == "cuda":
                with torch.cuda.device(eng.device):
                    out = eng._dispatch_out(flat, sig)
            else:
                out = eng._dispatch_out(flat, sig)
        dt = self._clock() - t0
        with self._lock:
            if self.straggler.observe(idx, dt):
                self.stats["stragglers"] += 1
        if self.tile_timeout_s is not None and dt > self.tile_timeout_s:
            with self._lock:
                self.stats["timeouts"] += 1
            raise _TileFailure(
                f"tile {idx} took {dt:.3f}s on worker {worker.wid} "
                f"(> timeout {self.tile_timeout_s}s)",
                reason="tile-timeout")
        if "scalar" in out:
            return float(out["scalar"])
        coords, vals = eng._live_coords(out)
        return self.tiled._global_keys(coords, tids), np.asarray(vals)

    # -- the retry / re-plan state machine (DESIGN.md §10) ---------------
    def _lose_worker(self, worker: _Worker) -> None:
        """Drop a dead worker and re-plan onto the survivors: the device
        mesh shrinks (``elastic.shrink_mesh``) and surviving workers
        re-place over it. Caller holds ``self._lock``."""
        worker.alive = False
        self.stats["workers_lost"] += 1
        self.stats["replans"] += 1
        live = [w for w in self.workers if w.alive]
        if not live:
            return
        new_mesh, _ = elastic.shrink_mesh(self.mesh, failed_hosts=1,
                                          devices_per_host=1)
        if new_mesh is not None:
            self.mesh = new_mesh
            self.tile_axes = data_axes(new_mesh)
            devs = list(np.asarray(new_mesh.devices).reshape(-1))
            for i, w in enumerate(live):
                w.device = devs[i % len(devs)]

    def _handle_failure(self, err: _TileFailure, idx: int, attempt: int,
                        worker: _Worker) -> int:
        """Account one failed dispatch; returns the attempt number to
        requeue the tile with, or raises ``DistributedError`` when retry
        cannot continue."""
        with self._lock:
            self.stats["failures"] += 1
            worker.failures += 1
            kill = err.kill or worker.failures > self.worker_fail_limit
            self.failure_log.append({
                "tile": idx, "worker": worker.wid, "attempt": attempt,
                "reason": err.reason, "worker_lost": bool(kill),
            })
            if kill and worker.alive:
                self._lose_worker(worker)
            any_alive = any(w.alive for w in self.workers)
        if not any_alive:
            raise DistributedError(
                f"all {len(self.workers)} workers lost (last failure: "
                f"tile {idx}: {err.reason})", reason="no-workers") from err
        if attempt + 1 >= self.max_attempts:
            raise DistributedError(
                f"tile {idx} failed {attempt + 1} attempt(s), last on "
                f"worker {worker.wid}: {err.reason}",
                reason="retries-exhausted") from err
        with self._lock:
            self.stats["retries"] += 1
        return attempt + 1

    # -- schedulers ------------------------------------------------------
    def _run_inline(self, arrays, tiles) -> Dict[int, Any]:
        """Deterministic single-threaded fan-out: tile (idx, attempt)
        dispatches to live worker ``(idx + attempt) % len(live)`` — a
        retry always lands on a DIFFERENT surviving worker when one
        exists."""
        results: Dict[int, Any] = {}
        pending = deque((idx, tids, 0) for idx, tids in tiles)
        while pending:
            idx, tids, attempt = pending.popleft()
            live = [w for w in self.workers if w.alive]
            if not live:
                raise DistributedError("no live workers",
                                       reason="no-workers")
            worker = live[(idx + attempt) % len(live)]
            try:
                flat, sig = self._encode_tile(arrays, tids, worker)
                with self._lock:
                    self.stats["tile_calls"] += 1
                results[idx] = self._compute_tile(flat, sig, idx, tids,
                                                  worker, attempt)
            except _TileFailure as e:
                pending.appendleft(
                    (idx, tids, self._handle_failure(e, idx, attempt,
                                                     worker)))
                continue
            worker.tiles_done += 1
        return results

    def _run_threaded(self, arrays, tiles) -> Dict[int, Any]:
        """Overlapped fan-out: per worker an encode thread feeds a
        compute thread through a depth-bounded queue (the serving
        pipeline discipline); the scheduler keeps at most
        ``pipeline_depth + 1`` tiles in flight per worker and handles
        completions/failures from a single merge point."""
        done_q: "queue.Queue" = queue.Queue()
        in_qs = {w.wid: queue.Queue() for w in self.workers}
        run_qs = {w.wid: queue.Queue(self.pipeline_depth)
                  for w in self.workers}

        def encoder(w: _Worker):
            while True:
                item = in_qs[w.wid].get()
                if item is None:
                    run_qs[w.wid].put(None)
                    return
                idx, tids, attempt = item
                if not w.alive:
                    done_q.put(("orphan", idx, tids, attempt, w.wid, None))
                    continue
                try:
                    enc = self._encode_tile(arrays, tids, w)
                except Exception as e:  # noqa: BLE001 — becomes a retry
                    done_q.put(("fail", idx, tids, attempt, w.wid,
                                _TileFailure(str(e),
                                             reason="encode-failed")))
                    continue
                run_qs[w.wid].put((idx, tids, attempt, enc))

        def computer(w: _Worker):
            while True:
                item = run_qs[w.wid].get()
                if item is None:
                    return
                idx, tids, attempt, (flat, sig) = item
                if not w.alive:
                    done_q.put(("orphan", idx, tids, attempt, w.wid, None))
                    continue
                with self._lock:
                    self.stats["tile_calls"] += 1
                try:
                    part = self._compute_tile(flat, sig, idx, tids, w,
                                              attempt)
                except _TileFailure as e:
                    done_q.put(("fail", idx, tids, attempt, w.wid, e))
                    continue
                except Exception as e:  # noqa: BLE001 — becomes a retry
                    done_q.put(("fail", idx, tids, attempt, w.wid,
                                _TileFailure(str(e),
                                             reason="tile-failed")))
                    continue
                done_q.put(("ok", idx, tids, attempt, w.wid, part))

        threads: List[threading.Thread] = []
        for w in self.workers:
            if not w.alive:
                continue
            for name, fn in ((f"dist-encode-w{w.wid}", encoder),
                             (f"dist-compute-w{w.wid}", computer)):
                t = threading.Thread(target=fn, args=(w,), name=name,
                                     daemon=True)
                t.start()
                threads.append(t)

        pending = deque((idx, tids, 0) for idx, tids in tiles)
        inflight: Dict[int, Tuple[int, int]] = {}   # idx -> (wid, attempt)
        in_per_w = {w.wid: 0 for w in self.workers}
        cap = self.pipeline_depth + 1

        def feed():
            progress = True
            while pending and progress:
                progress = False
                for w in self.workers:
                    if not pending:
                        break
                    if not w.alive or in_per_w[w.wid] >= cap:
                        continue
                    idx, tids, attempt = pending.popleft()
                    inflight[idx] = (w.wid, attempt)
                    in_per_w[w.wid] += 1
                    in_qs[w.wid].put((idx, tids, attempt))
                    progress = True

        results: Dict[int, Any] = {}
        try:
            feed()
            while len(results) < len(tiles):
                kind, idx, tids, attempt, wid, payload = done_q.get()
                if inflight.get(idx) != (wid, attempt):
                    continue    # stale echo from a worker killed mid-run
                del inflight[idx]
                in_per_w[wid] -= 1
                w = self.workers[wid]
                if kind == "ok":
                    results[idx] = payload
                    w.tiles_done += 1
                elif kind == "orphan":     # queued on a worker that died
                    pending.appendleft((idx, tids, attempt))
                else:
                    pending.appendleft(
                        (idx, tids,
                         self._handle_failure(payload, idx, attempt, w)))
                feed()
        finally:
            for w in self.workers:
                in_qs[w.wid].put(None)
            for t in threads:
                t.join(timeout=600)
        return results

    # -- execution -------------------------------------------------------
    def tile_partials(self, arrays: Dict[str, np.ndarray]
                      ) -> Dict[int, Any]:
        """Fan the tile grid out over the workers and return every tile's
        partial keyed by its flat grid index (arrival order is NOT
        recorded — the merge is order-blind by construction)."""
        self.tiled._measure_hints(arrays)
        tiles = list(enumerate(tiling.tile_grid(self.tiled.tile_of)))
        live_n = sum(w.alive for w in self.workers)
        if live_n == 0:
            raise DistributedError(
                "no live workers (revive() or rebuild)", reason="no-workers")
        if self._overlap_effective() and live_n > 1:
            return self._run_threaded(arrays, tiles)
        return self._run_inline(arrays, tiles)

    def _overlap_effective(self) -> bool:
        """Resolve the ``overlap`` policy: ``"auto"`` enables the
        threaded scheduler only when live workers own more than one
        distinct physical device — on a shared device ``_DEVICE_LOCK``
        serializes compute and threads cost more than they overlap
        (module docstring)."""
        if self.overlap != "auto":
            return bool(self.overlap)
        return len({str(w.device) for w in self.workers if w.alive}) > 1

    def merge_partials(self, partials: Dict[int, Any]) -> FiberTree:
        """Fold tile partials in TILE-GRID order — the exact left-fold
        the single-device ``TiledExpr`` performs — so the result bytes
        never depend on completion/arrival order."""
        total = 0.0
        acc_k = np.zeros(0, np.int64)
        acc_v = np.zeros(0, np.float32)
        for idx in range(self.tiled.n_tiles):
            p = partials[idx]
            if isinstance(p, float):            # scalar partial
                total += p
                continue
            keys, vals = p
            acc_k, acc_v = co.accumulate_coo(
                acc_k, acc_v, keys, vals, key_bound=self.tiled._key_bound,
                union_reduce_impl=self.tiled._union_reduce,
                device=self.tiled.device)
        return self.tiled._finalize(acc_k, acc_v, total)

    def __call__(self, arrays: Dict[str, np.ndarray]) -> FiberTree:
        """Execute one operand set distributed; the result ``FiberTree``
        is bit-identical to ``TiledExpr`` (and so to the untiled
        engine) by the grid-order merge."""
        with self._lock:
            self.stats["calls"] += 1
        return self.merge_partials(self.tile_partials(arrays))

    def execute(self, arrays: Dict[str, np.ndarray]) -> FiberTree:
        """Alias of ``__call__`` (API parity with ``CompiledExpr``)."""
        return self(arrays)

    def execute_batch(self, arrays_list: Sequence[Dict[str, np.ndarray]]
                      ) -> List[FiberTree]:
        """Requests execute one after another; within each request the
        tile grid fans out over the workers."""
        with self._lock:
            self.stats["batch_calls"] += 1
        return [self(a) for a in arrays_list]

    execute_many = execute_batch


def dist_compile(expr, fmt, schedule, dims, *, workers: int = 2,
                 use_kernels: bool = True, mem_budget=None,
                 densities=None, device=None, **kw) -> DistTiledExpr:
    """Compile an expression out-of-core and wrap it in the distributed
    driver. The schedule must carry ``tile`` (or ``mem_budget`` must
    force one): distribution fans out the tile grid. ``device`` places
    the tiled engine (CUDA by default, ``"cpu"`` for the plain PyTorch
    versions). Keyword args beyond the compile set forward to
    ``DistTiledExpr`` (clock, faults, max_attempts, overlap, ...)."""
    eng = compile_expr(expr, fmt, schedule, dims, use_kernels=use_kernels,
                       mem_budget=mem_budget, sparsity=densities,
                       device=device)
    if not isinstance(eng, TiledExpr):
        raise ValueError(
            "expression resolved untiled — distributed execution fans "
            "out the tile grid; give a Schedule.tile or a mem_budget "
            "that forces one")
    return DistTiledExpr(eng, workers=workers, **kw)
