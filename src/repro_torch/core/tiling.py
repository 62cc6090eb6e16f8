"""Coordinate-space tiling under a memory budget (out-of-core execution).

SAM's central claim is that one streaming abstraction scales from
scheduled tensor algebra down to hardware with *bounded* buffers — but a
compiled engine call allocates every operand level, every intermediate
stream capacity, and the result COO on the device at once, so the
largest executable expression is capped by device memory. This module
supplies the missing piece (the split-and-stream move of Stardust's
fixed-size RDA tiling and FuseFlow's sparse-DL tiling, see PAPERS.md):

* ``estimate_call_bytes`` — a deterministic estimate of the peak device
  allocation of ONE untiled compiled call (operand coordinate arrays
  with dense-level densification, per-term scan-stream expansions, the
  result COO), mirroring what the reference's ``CompiledExpr``
  (``repro.core.jax_backend``) materializes; the copy keeps its numbers,
  so the port's tile plans equal the reference's.
* ``plan_tiles`` — given a byte budget, pick ``{var: n_tiles}`` so one
  tile's estimate fits: deterministically double the tile count of the
  variable with the largest remaining per-tile extent until the
  estimate fits (or raise ``MemoryBudgetExceeded`` when even
  1-extent tiles cannot).
* ``tile_extents`` / ``tile_grid`` / ``slice_operands`` — the coordinate
  partition itself: per-tile index extents (``ceil(d/n)``), the tile-id
  grid, and zero-padded numpy slices of the operands for one tile.

The execution engine that streams the tiles through one plan-cached
per-tile engine and accumulates the partial COOs is
``torch_backend.TiledExpr``; the cycle model lives in
``simulator.simulate_expr`` (``Schedule.tile``); the schedule-search
integration is ``autoschedule.search(mem_budget=...)``. Docs:
docs/TILING.md; design notes: DESIGN.md §7.

>>> from repro_torch.core.einsum import parse
>>> from repro_torch.core.schedule import Format, Schedule
>>> a = parse("X(i,j) = B(i,k) * C(k,j)")
>>> sch = Schedule(loop_order=("i", "k", "j"))
>>> dims = {"i": 1024, "j": 1024, "k": 1024}
>>> big = estimate_call_bytes(a, Format({"B": "cc", "C": "dd"}), sch, dims,
...                           densities={"B": 0.01, "C": 1.0})
>>> plan = plan_tiles(a, Format({"B": "cc", "C": "dd"}), sch, dims,
...                   budget=big // 3, densities={"B": 0.01, "C": 1.0})
>>> n_tiles(plan) > 1
True
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import re
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from .einsum import Assignment, parse
from .schedule import Format, Schedule

# estimated bytes per element of one expanded scan stream: crd + ref +
# parent int32 plus the validity mask and value-stream amortization
_STREAM_ELEM_BYTES = 16
# result COO element: int64 key + f32 value + validity
_COO_ELEM_BYTES = 13


class MemoryBudgetExceeded(RuntimeError):
    """An execution (or a tile of one) cannot fit the memory budget."""

    def __init__(self, message: str, *, estimate: int, budget: int):
        super().__init__(message)
        self.estimate = int(estimate)
        self.budget = int(budget)


def parse_budget(text) -> int:
    """Parse a byte budget: an int, or a string like ``"64MB"``/``"1.5G"``.

    >>> parse_budget("64MB"), parse_budget("1.5K"), parse_budget(4096)
    (67108864, 1536, 4096)
    """
    if isinstance(text, (int, float)):
        return int(text)
    m = re.fullmatch(r"\s*([0-9]+(?:\.[0-9]+)?)\s*([KMGT]?)I?B?\s*",
                     str(text), re.IGNORECASE)
    if not m:
        raise ValueError(f"cannot parse memory budget {text!r} "
                         f"(expected e.g. 67108864, '64MB', '1.5G')")
    scale = {"": 1, "K": 1 << 10, "M": 1 << 20, "G": 1 << 30,
             "T": 1 << 40}[m.group(2).upper()]
    return int(float(m.group(1)) * scale)


def format_bytes(n: int) -> str:
    """Human-readable byte count (for logs).

    >>> format_bytes(3 * (1 << 20))
    '3.0MB'
    """
    for unit, width in (("GB", 1 << 30), ("MB", 1 << 20), ("KB", 1 << 10)):
        if n >= width:
            return f"{n / width:.1f}{unit}"
    return f"{n}B"


def _densities(assign: Assignment, densities) -> Dict[str, float]:
    # ONE density-defaulting rule repo-wide (autoschedule's), so the
    # budget gate and the cost model always agree about expected sizes;
    # imported lazily — autoschedule imports this module the same way
    from .autoschedule import resolve_densities
    return resolve_densities(assign, densities)


def _level_fills(assign: Assignment, fmt: Format,
                 densities: Dict[str, float]) -> Dict[str, float]:
    """Per-level fill of each tensor: a tensor of density ``p`` with ``m``
    sparse (compressed/bitvector/singleton/hashed/bitmap) levels
    contributes ``p**(1/m)`` per such level (the same
    uniform-independence model as ``autoschedule.analytic_cost``, so the
    budget gate and the cost model agree about sizes; s/h/m storage
    canonicalizes to ``c`` on engine ingest, so compressed estimates are
    the right device-side sizes for them too)."""
    fills = {}
    for term in assign.terms:
        for acc in term.factors:
            if acc.tensor in fills:
                continue
            s = fmt.of(acc.tensor, len(acc.vars))
            m = sum(1 for ch in s if ch in "cbshm")
            p = densities[acc.tensor]
            fills[acc.tensor] = p ** (1.0 / m) if m else 1.0
    return fills


def estimate_call_bytes(assign, fmt: Format, schedule: Schedule,
                        dims: Dict[str, int], *,
                        densities: Optional[Dict[str, float]] = None) -> int:
    """Estimated peak device bytes of one UNTILED compiled call.

    Mirrors what ``CompiledExpr`` materializes for one execution — all
    three live at once inside the jitted core:

    * operand level arrays as ``JTensor.from_fibertree`` builds them
      (a ``d`` level *densifies*: ``num_parents * dim`` int32
      coordinates, which is exactly the allocation that makes large
      dense-formatted operands un-executable untiled);
    * per-term scan-stream expansions at every loop level (crd/ref/
      parent/valid per element, expected lengths from the density
      model);
    * the result COO (int64 keys + f32 values).

    This is an *estimate* (expected sizes under uniform independence,
    before power-of-two bucketing), meant as a budget gate with
    order-of-magnitude fidelity, not an allocator.

    >>> from repro_torch.core.einsum import parse
    >>> a = parse("x(i) = B(i,j) * c(j)")
    >>> small = estimate_call_bytes(a, Format({"B": "cc", "c": "c"}),
    ...     Schedule(loop_order=("i", "j")), {"i": 8, "j": 8})
    >>> big = estimate_call_bytes(a, Format({"B": "cc", "c": "c"}),
    ...     Schedule(loop_order=("i", "j")), {"i": 8192, "j": 8192})
    >>> small < big
    True
    """
    assign = parse(assign) if isinstance(assign, str) else assign
    dens = _densities(assign, densities)
    fills = _level_fills(assign, fmt, dens)
    pos = {v: i for i, v in enumerate(schedule.loop_order)}
    total = 0.0

    # -- operand storage (levels + values) --------------------------------
    seen = set()
    for term in assign.terms:
        for acc in term.factors:
            if acc.tensor in seen:
                continue
            seen.add(acc.tensor)
            path = tuple(sorted(acc.vars, key=lambda v: pos.get(v, 0)))
            s = fmt.of(acc.tensor, len(acc.vars))
            cnt, fill = 1.0, fills[acc.tensor]
            for v, ch in zip(path, s):
                total += 4 * (cnt + 1)                      # seg (int32)
                cnt *= dims[v] * (fill if ch in "cbshm" else 1.0)
                cnt = max(cnt, 1.0)
                total += 4 * cnt                            # crd (int32)
            total += 4 * cnt                                # vals (f32)

    # -- per-term scan-stream expansions ----------------------------------
    result_vars = set(assign.lhs.vars)
    result_est = 0.0
    for term in assign.terms:
        scope = [v for v in schedule.loop_order
                 if v in term.vars or v in result_vars]
        count = 1.0
        for v in scope:
            flens, fprob = [], 1.0
            for f in term.factors:
                if v not in f.vars:
                    continue
                s = fmt.of(f.tensor, len(f.vars))
                path = tuple(sorted(f.vars, key=lambda w: pos.get(w, 0)))
                ch = s[path.index(v)] if path.index(v) < len(s) else "c"
                fill = fills[f.tensor] if ch in "cbshm" else 1.0
                flens.append(max(dims[v] * fill, 1.0))
                fprob *= fill
            if flens:
                total += _STREAM_ELEM_BYTES * count * sum(flens)
                count *= max(dims[v] * fprob, 1e-9)
            else:                                           # broadcast var
                total += _STREAM_ELEM_BYTES * count * dims[v]
                count *= dims[v]
        result_est += count
    total += _COO_ELEM_BYTES * result_est                   # result COO
    return int(math.ceil(total))


# ---------------------------------------------------------------------------
# the coordinate partition
# ---------------------------------------------------------------------------

def legal_tile_vars(assign) -> Tuple[str, ...]:
    """Variables a coordinate tiling may ride on.

    Result variables always qualify (each term broadcasts into every
    tile's disjoint chunk). A CONTRACTION variable qualifies only when
    every term contains it: a term missing a tiled contraction variable
    computes the same value in every tile, so the tile merge would
    re-add it once per tile.

    >>> from repro_torch.core.einsum import parse
    >>> legal_tile_vars(parse("x(i) = b(i) - C(i,j) * d(j)"))
    ('i',)
    >>> legal_tile_vars(parse("x(i) = B(i,j)*c(j) + D(i,j)*e(j)"))
    ('i', 'j')
    """
    assign = parse(assign) if isinstance(assign, str) else assign
    res = set(assign.lhs.vars)
    return tuple(v for v in assign.all_vars
                 if v in res or all(v in t.vars for t in assign.terms))


def normalize_tile(schedule: Schedule) -> Dict[str, int]:
    """A schedule's effective tile grid: int counts, 1-tiles dropped.

    >>> normalize_tile(Schedule(loop_order=("i",), tile={"i": 1}))
    {}
    """
    return {v: int(n) for v, n in schedule.tile.items() if int(n) > 1}


def check_tile(assign, tile: Dict[str, int],
               schedule: Optional[Schedule] = None) -> None:
    """Raise ``ValueError`` for a tiling an expression (or schedule)
    cannot carry. The ONE legality gate both executors call
    (``torch_backend.TiledExpr`` and ``simulator.simulate_expr``), so the
    engine and the simulator agree by construction; ``plan_tiles`` never
    proposes anything this would reject."""
    assign = parse(assign) if isinstance(assign, str) else assign
    legal = set(legal_tile_vars(assign))
    bad = sorted(v for v in tile if v not in legal)
    missing = [v for v in bad if v not in assign.all_vars]
    if missing:
        raise ValueError(f"tile variable(s) {missing} not in the "
                         f"expression's index variables")
    if bad:
        raise ValueError(
            f"cannot tile contraction variable(s) {bad}: at least one "
            f"term does not contain them, and a term missing a tiled "
            f"contraction variable would be re-added once per tile "
            f"(legal tile variables here: {sorted(legal)})")
    if schedule is not None:
        clash = sorted(set(tile) & (set(schedule.split)
                                    | set(schedule.parallelize)))
        if clash:
            raise ValueError(
                f"variable(s) {clash} are both tiled and split/"
                f"parallelized; tile one variable, split another")


def tile_extents(dims: Dict[str, int], tile: Dict[str, int]
                 ) -> Dict[str, int]:
    """Per-tile index extents: a tiled var spans one ``ceil(d/n)`` chunk.

    >>> tile_extents({"i": 10, "j": 7}, {"j": 2})
    {'i': 10, 'j': 4}
    """
    return {v: (-(-d // tile[v]) if v in tile else d)
            for v, d in dims.items()}


def n_tiles(tile: Dict[str, int]) -> int:
    """Total tile count of a tiling plan (the grid volume).

    >>> n_tiles({"j": 4, "k": 2}), n_tiles({})
    (8, 1)
    """
    n = 1
    for t in tile.values():
        n *= int(t)
    return n


def tile_grid(tile: Dict[str, int]) -> Iterator[Dict[str, int]]:
    """Iterate tile ids as ``{var: tid}`` dicts, row-major over the sorted
    variable order (deterministic).

    >>> [g for g in tile_grid({"j": 2})]
    [{'j': 0}, {'j': 1}]
    """
    vs = sorted(tile)
    for tids in itertools.product(*(range(int(tile[v])) for v in vs)):
        yield dict(zip(vs, tids))


def slice_operands(assign, arrays: Dict[str, np.ndarray],
                   dims: Dict[str, int], tile: Dict[str, int],
                   tids: Dict[str, int]) -> Dict[str, np.ndarray]:
    """One tile's operand slice: each tensor axis accessed by a tiled var
    keeps only coordinates ``[tid*csz, (tid+1)*csz)``, zero-padded to the
    full chunk size at the ragged tail (explicit zeros are never stored
    by ``FiberTree.from_dense``, so padding is free).

    >>> import numpy as np
    >>> a = parse("x(i) = b(i)")
    >>> out = slice_operands(a, {"b": np.arange(1., 6.)}, {"i": 5},
    ...                      {"i": 2}, {"i": 1})
    >>> out["b"].tolist()
    [4.0, 5.0, 0.0]
    """
    assign = parse(assign) if isinstance(assign, str) else assign
    out: Dict[str, np.ndarray] = {}
    for term in assign.terms:
        for acc in term.factors:
            if acc.tensor in out:
                continue
            arr = np.asarray(arrays[acc.tensor])
            for ax, v in enumerate(acc.vars):
                if v not in tile:
                    continue
                csz = -(-dims[v] // tile[v])
                lo = tids[v] * csz
                idx = (slice(None),) * ax + (slice(lo, lo + csz),)
                arr = arr[idx]
                if arr.shape[ax] < csz:                    # ragged tail
                    widths = [(0, 0)] * arr.ndim
                    widths[ax] = (0, csz - arr.shape[ax])
                    arr = np.pad(arr, widths)
            out[acc.tensor] = arr
    return out


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

def plan_tiles(assign, fmt: Format, schedule: Schedule,
               dims: Dict[str, int], budget: int, *,
               densities: Optional[Dict[str, float]] = None
               ) -> Dict[str, int]:
    """Pick ``{var: n_tiles}`` so ONE tile's estimated allocation fits
    ``budget`` — empty when the untiled call already fits.

    Deterministic greedy descent: while the per-tile estimate exceeds the
    budget, double the tile count of the variable with the largest
    remaining per-tile extent (ties broken by loop-order position). When
    every extent is already 1 and the estimate still exceeds the budget,
    raises ``MemoryBudgetExceeded`` — no coordinate partition can help.
    """
    assign = parse(assign) if isinstance(assign, str) else assign
    budget = parse_budget(budget)
    tile: Dict[str, int] = {}
    # a tile may not ride a variable the schedule already splits or
    # parallelizes (``check_tile`` rejects the combination), nor an illegal
    # contraction variable — see legal_tile_vars
    legal = (set(legal_tile_vars(assign))
             - set(schedule.split) - set(schedule.parallelize))
    order = [v for v in schedule.loop_order if v in legal]
    while True:
        ext = tile_extents(dims, tile)
        est = estimate_call_bytes(assign, fmt, schedule, ext,
                                  densities=densities)
        if est <= budget:
            # clamp each count to its EFFECTIVE grid (the doubling can
            # overshoot: 8 tiles of ceil(9/8)=2 cover 9 in 5 — the other
            # 3 would be all-padding dispatches)
            eff = {v: -(-dims[v] // ext[v]) for v in tile}
            return {v: n for v, n in eff.items() if n > 1}
        cands = [v for v in order if ext[v] > 1]
        if not cands:
            raise MemoryBudgetExceeded(
                f"one fully tiled call still needs "
                f"{format_bytes(est)} > budget {format_bytes(budget)}",
                estimate=est, budget=budget)
        v = max(cands, key=lambda w: (ext[w], -order.index(w)))
        tile[v] = min(2 * tile.get(v, 1), dims[v])


def require_budget(assign, fmt: Format, schedule: Schedule,
                   dims: Dict[str, int], budget, *,
                   densities: Optional[Dict[str, float]] = None) -> int:
    """Raise ``MemoryBudgetExceeded`` when one untiled call's estimate
    exceeds ``budget``; returns the estimate otherwise."""
    assign = parse(assign) if isinstance(assign, str) else assign
    budget = parse_budget(budget)
    est = estimate_call_bytes(assign, fmt, schedule, dims,
                              densities=densities)
    if est > budget:
        raise MemoryBudgetExceeded(
            f"untiled call needs ~{format_bytes(est)} > memory budget "
            f"{format_bytes(budget)}; tile it (Schedule.tile, or "
            f"compile_expr(..., mem_budget=...) to auto-plan)",
            estimate=est, budget=budget)
    return est


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """A resolved tiling decision: the plan, both estimates, the budget."""

    tile: Dict[str, int]
    untiled_bytes: int
    tile_bytes: int
    budget: int

    @property
    def tiles(self) -> int:
        return n_tiles(self.tile)


def resolve_plan(assign, fmt: Format, schedule: Schedule,
                 dims: Dict[str, int], budget, *,
                 densities: Optional[Dict[str, float]] = None) -> TilePlan:
    """Full budget decision for one expression: untiled estimate, the
    tiling plan (empty when untiled fits), and the per-tile estimate."""
    assign = parse(assign) if isinstance(assign, str) else assign
    budget = parse_budget(budget)
    untiled = estimate_call_bytes(assign, fmt, schedule, dims,
                                  densities=densities)
    tile = ({} if untiled <= budget else
            plan_tiles(assign, fmt, schedule, dims, budget,
                       densities=densities))
    per_tile = estimate_call_bytes(assign, fmt, schedule,
                                   tile_extents(dims, tile),
                                   densities=densities)
    return TilePlan(tile=tile, untiled_bytes=untiled, tile_bytes=per_tile,
                    budget=budget)
