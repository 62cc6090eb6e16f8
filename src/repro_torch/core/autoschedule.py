"""Autoscheduler: cost-model-driven schedule search + persistent cache.

SAM dataflow graphs span "arbitrary iteration orderings and many
hardware-specific optimizations" (paper §1) — and the fig12 reproduction
shows a >=10x cycle gap between loop orders of the SAME expression. This
module turns that schedule space from something a user guesses into
something the system searches:

1. **Enumerate** the legal schedule space (``enumerate_space``): loop
   orders consistent with the expression (permutations of its index
   variables), iteration-split factors over power-of-two candidates
   (§4.1), §4.4 lane counts up to the device count riding on the split
   variable, and — when ``format_choices`` is given — per-tensor level
   formats drawn from the pluggable level interface
   (``fibertree.LEVEL_SPECS``; only formats whose capability flags
   support iteration are legal candidates).
2. **Prune** with a cheap analytic estimate (``analytic_cost``): expected
   stream lengths derived from formats + dims + a sparsity hint, combined
   with the simulator's steady-state law (cycles ≈ max per-block work).
3. **Rank** the survivors by running the existing cycle-approximate
   ``Simulator`` as the cost model on *downsampled* operands
   (``simulator.downsample_operands`` keeps the sample cheap while
   preserving relative order — fig12's ranking is stable down to ~48³).
4. **Remember**: ``ScheduleCache`` persists winners on disk keyed by the
   canonical expression key + dims bucket + sparsity bucket, so serving
   never re-searches a shape it has seen (see DESIGN.md §5).

A memory budget (``search(mem_budget=...)``) adds the out-of-core tile
size to the space as a LEGALITY bound: over-budget candidates grow the
minimal coordinate tiling that fits (plus one 2x-finer grid),
unfittable candidates are dropped, and budget-qualified winners persist
under their own cache entries (DESIGN.md §7, docs/TILING.md).

Entry points: ``resolve_schedule`` (cache-aware; what
``custard.lower(..., schedule="auto")``, ``torch_backend.compile_expr``
and ``program.resolve_stage_schedules`` call) and ``search`` (always
searches, returns the full ranked report).

This is the PyTorch port's copy of ``repro.core.autoschedule``: the
search, its cost model and its cache keys are the reference's, so for
the same ``device_count`` both rank the same candidates the same way.
Two things differ: the device count defaults to the CUDA devices
(``_device_count``), and the default cache file is the port's own
(``default_cache_path``), so the port never serves a pick the reference
cached.

>>> from repro_torch.core.einsum import parse
>>> specs = enumerate_space(parse("x(i) = B(i,j) * c(j)"), {"i": 8, "j": 8},
...                         device_count=1)
>>> sorted({s.order for s in specs if not s.split})
[('i', 'j'), ('j', 'i')]
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
import time
from itertools import islice, permutations
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .einsum import Assignment, parse
from .schedule import Format, Schedule, schedule_from_dict, schedule_to_dict
from .simulator import downsample_operands, simulate_expr

DEFAULT_SPARSITY = 0.1
SPLIT_FACTORS = (2, 4, 8)
MAX_ORDERS = 720          # full permutations up to 6 index variables
# per-level format chars the joint (format x schedule) search draws from
# when ``format_choices`` is requested but unspecified
FORMAT_CHOICES = ("c", "m", "h", "s")
MAX_FORMAT_COMBOS = 32    # cap on the per-tensor format cross product
# v3: the search space gained per-tensor level formats
# (``CandidateSpec.formats``) and the analytic model gained format terms
# (bitmap word streams, hashed sort stages, singleton tree conversion) —
# a v2 winner may no longer be the winner of the same key's search. The
# version rides the default cache FILENAME, so older stores are simply
# never read (or clobbered) by v3 tools; a shared $SAM_SCHEDULE_CACHE
# file is guarded by the version stamp INSIDE the file instead (see
# ``ScheduleCache._load``).
CACHE_VERSION = 3

SparsityHint = Union[None, float, Dict[str, float]]


# ---------------------------------------------------------------------------
# schedule-space enumeration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CandidateSpec:
    """One point of the schedule space, in ORIGINAL (unsplit) terms.

    ``order`` is a permutation of every index variable; ``split`` is at
    most one ``(var, factor)`` §4.1 split; ``lanes > 1`` parallelizes the
    split variable's outer half into that many §4.4 lanes. ``tile``
    carries the out-of-core coordinate partition a memory budget forced
    (``search(mem_budget=...)``; empty without a budget). ``formats``
    carries per-tensor level-format OVERRIDES of the caller's baseline
    ``Format`` — empty means "use the baseline unchanged", which keeps
    the format-less space byte-identical to the historical one.
    """

    order: Tuple[str, ...]
    split: Tuple[Tuple[str, int], ...] = ()
    lanes: int = 1
    tile: Tuple[Tuple[str, int], ...] = ()
    formats: Tuple[Tuple[str, str], ...] = ()   # (tensor, format string)

    def schedule(self) -> Schedule:
        split = dict(self.split)
        par: Dict[str, int] = {}
        if self.lanes > 1 and split:
            par = {next(iter(split)): self.lanes}
        return Schedule(loop_order=self.order, split=split, parallelize=par,
                        tile=dict(self.tile))

    def format(self, base: Format) -> Format:
        """The baseline ``Format`` with this spec's overrides applied."""
        if not self.formats:
            return base
        merged = dict(base.formats)
        merged.update(dict(self.formats))
        return Format(merged, default=base.default)

    def key(self) -> str:
        """Deterministic total-order tie-breaker (the separator keeps
        multi-character variable names collision-free)."""
        sp = ",".join(f"{v}:{f}" for v, f in self.split)
        ti = ",".join(f"{v}:{n}" for v, n in self.tile)
        fo = ",".join(f"{t}:{s}" for t, s in self.formats)
        return (f"{','.join(self.order)}|split={sp}|lanes={self.lanes}"
                + (f"|tile={ti}" if ti else "")
                + (f"|fmt={fo}" if fo else ""))


def _format_combos(assign: Assignment, fmt: Optional[Format],
                   format_choices: Sequence[str]
                   ) -> List[Tuple[Tuple[str, str], ...]]:
    """Per-tensor format override combinations, baseline (empty) first.

    Legality comes from the level-format capability flags: only formats
    that support streaming iteration (``spec_of(ch).iterate``) can feed a
    level scanner, so only those enumerate. The cross product over input
    tensors is capped at ``MAX_FORMAT_COMBOS`` (deterministic prefix).
    """
    from itertools import product

    from .fibertree import spec_of

    fmt = fmt or Format()
    tensors: List[Tuple[str, int]] = []
    for term in assign.terms:
        for acc in term.factors:
            if acc.tensor not in dict(tensors):
                tensors.append((acc.tensor, len(acc.vars)))
    per_tensor: List[List[Tuple[str, str]]] = []
    for t, rank in sorted(tensors):
        base = fmt.of(t, rank)
        opts = [base]
        for ch in format_choices:
            s = ch * rank if rank else ""
            if s not in opts and spec_of(ch).iterate:
                opts.append(s)
        per_tensor.append([(t, s) for s in opts])
    combos: List[Tuple[Tuple[str, str], ...]] = []
    for combo in islice(product(*per_tensor), MAX_FORMAT_COMBOS):
        # keep only the entries that differ from the baseline, so the
        # all-baseline combo is the empty tuple (spec key stability)
        combos.append(tuple((t, s) for (t, s), (bt, rank) in
                            zip(combo, sorted(tensors))
                            if s != fmt.of(t, rank)))
    return combos


def enumerate_space(assign: Union[str, Assignment], dims: Dict[str, int], *,
                    device_count: Optional[int] = None,
                    split_factors: Sequence[int] = SPLIT_FACTORS,
                    max_orders: int = MAX_ORDERS,
                    fmt: Optional[Format] = None,
                    format_choices: Optional[Sequence[str]] = None
                    ) -> List[CandidateSpec]:
    """Enumerate the legal schedule space for an expression.

    Legality invariants (pinned by ``tests/test_autoschedule.py``):

    * every ``order`` is a permutation of ``assign.all_vars`` — no
      variable is ever dropped;
    * split factors are powers of two, ``2 <= factor <= dims[var]``, so
      the factor always divides the zero-padded extent
      ``factor * ceil(dim/factor)``;
    * variables whose §4.1 rename ``(vo, vi)`` would collide with an
      existing variable are never split;
    * lane counts are powers of two, ``lanes <= device_count`` and
      ``lanes <= factor`` (a lane per coordinate chunk at most);
    * format candidates (``format_choices``, e.g. ``("c", "m", "h",
      "s")``; ``None`` keeps the historical format-less space) are
      uniform per-tensor level strings restricted to formats whose
      ``fibertree.LevelSpec.iterate`` capability is set, crossed with
      every schedule point and capped at ``MAX_FORMAT_COMBOS``.
    """
    assign = parse(assign) if isinstance(assign, str) else assign
    vars_ = list(assign.all_vars)
    if not vars_:
        return [CandidateSpec(order=())]
    if device_count is None:
        device_count = _device_count()
    lane_counts = [n for n in (2, 4, 8, 16, 32, 64, 128)
                   if n <= device_count]
    # lanes ride a split factor >= the lane count, so the factor
    # candidates extend to cover every enumerable lane count — a
    # 16-device mesh must be able to see a 16-lane schedule
    factors = sorted(set(split_factors) | set(lane_counts))
    taken = set(vars_)
    specs: List[CandidateSpec] = []
    for order in islice(permutations(vars_), max_orders):
        specs.append(CandidateSpec(order=order))
        for v in order:
            if f"{v}o" in taken or f"{v}i" in taken:
                continue                      # §4.1 rename would capture
            for f in factors:
                if f < 2 or (f & (f - 1)) or f > dims.get(v, 0):
                    continue                  # power-of-two, fits the dim
                specs.append(CandidateSpec(order=order, split=((v, f),)))
                for n in lane_counts:
                    if n <= f:
                        specs.append(CandidateSpec(
                            order=order, split=((v, f),), lanes=n))
    if format_choices:
        combos = _format_combos(assign, fmt, format_choices)
        specs = [dataclasses.replace(s, formats=c)
                 for c in combos for s in specs]
    return specs


def _device_count() -> int:
    """The devices a search ranks lanes for: the CUDA devices, 1 where
    there are none (the reference counts JAX devices)."""
    import torch
    return max(torch.cuda.device_count(), 1)


# ---------------------------------------------------------------------------
# analytic pruning cost: expected stream lengths from formats + dims + nnz
# ---------------------------------------------------------------------------

def resolve_densities(assign: Assignment, sparsity: SparsityHint = None,
                      arrays: Optional[Dict[str, np.ndarray]] = None
                      ) -> Dict[str, float]:
    """Per-tensor density: an explicit per-tensor dict entry wins (so
    pre-measured densities are never re-measured), then measurement from
    ``arrays``, then a scalar ``sparsity`` hint, then
    ``DEFAULT_SPARSITY``."""
    dens: Dict[str, float] = {}
    for term in assign.terms:
        for acc in term.factors:
            t = acc.tensor
            if t in dens:
                continue
            if isinstance(sparsity, dict) and t in sparsity:
                p = float(sparsity[t])
            elif arrays is not None and t in arrays:
                a = np.asarray(arrays[t])
                p = float(np.count_nonzero(a)) / max(a.size, 1)
            elif sparsity is not None and not isinstance(sparsity, dict):
                p = float(sparsity)
            else:
                p = DEFAULT_SPARSITY
            dens[t] = min(max(p, 1e-6), 1.0)
    return dens


def analytic_cost(assign: Assignment, fmt: Format, dims: Dict[str, int],
                  spec: CandidateSpec, densities: Dict[str, float]) -> float:
    """Cheap schedule estimate mirroring the simulator's cost law.

    Walks each term's scope outer->inner tracking the expected number of
    live iterations (stream length): a compressed level of a tensor with
    density ``p`` and ``m`` compressed levels contributes per-level fill
    ``p**(1/m)``; intersections multiply fills (uniform-independence) and
    cost the sum of merged fiber lengths (two-finger pointer advances).
    The estimate is ``max`` over per-block works (the simulator's
    steady-state term) plus a small total-work tie-breaker. Parallel
    lanes divide the works at and below the split variable; the lane
    merge costs the estimated result nnz. A tiled spec costs one tile's
    estimate times the tile-grid volume (tiles stream sequentially) with
    a small overhead factor, so untiled schedules win whenever they fit
    the budget.

    Format terms (``spec.formats`` overrides the baseline ``fmt``):
    a variable whose scanned sources are ALL bitmap (``m``) streams one
    token per packed word — ``ceil(dim/64)`` per fiber instead of
    ``dim * fill`` (the §4.3 win the simulator models); each hashed
    (``h``) source adds an in-stream sort stage of ``~2x`` its token
    count; a tensor with singleton (``s``) levels adds a one-time
    tree-conversion stage of ``~2x`` its estimated nnz.
    """
    fmt = spec.format(fmt)
    if spec.tile:
        from .tiling import n_tiles, tile_extents
        ext = tile_extents(dims, dict(spec.tile))
        per = analytic_cost(assign, fmt, ext,
                            dataclasses.replace(spec, tile=()), densities)
        return float(per * n_tiles(dict(spec.tile)) * 1.05)
    pos = {v: i for i, v in enumerate(spec.order)}
    result_vars = set(assign.lhs.vars)
    fills: Dict[str, float] = {}
    stages: List[float] = []
    for term in assign.terms:
        for acc in term.factors:
            if acc.tensor in fills:
                continue
            s = fmt.of(acc.tensor, len(acc.vars))
            m = sum(1 for ch in s if ch in "cbshm")
            p = densities.get(acc.tensor, DEFAULT_SPARSITY)
            fills[acc.tensor] = p ** (1.0 / m) if m else 1.0
            if "s" in s:
                # non-unique storage rebuilds canonically once, up front
                # (the op="tree" CONVERT node): ~2 tokens per entry
                size = 1.0
                for v in acc.vars:
                    size *= dims.get(v, 1)
                stages.append(2.0 * p * size + 1.0)

    par_var = spec.split[0][0] if (spec.lanes > 1 and spec.split) else None
    result_est = 0.0
    for term in assign.terms:
        scope = [v for v in spec.order
                 if v in term.vars or v in result_vars]
        count = 1.0
        laned = par_var is not None and par_var in term.vars
        for v in scope:
            srcs: List[Tuple[str, str]] = []
            for f in term.factors:
                if v not in f.vars:
                    continue
                s = fmt.of(f.tensor, len(f.vars))
                path = sorted(f.vars, key=lambda w: pos[w])
                ch = s[path.index(v)] if path.index(v) < len(s) else "c"
                srcs.append((f.tensor, ch))
            # all-bitmap co-iteration streams packed words (§4.3)
            all_m = bool(srcs) and all(ch == "m" for _, ch in srcs)
            flens: List[float] = []
            fprob = 1.0
            sort_extra = 0.0
            for t, ch in srcs:
                fill = fills[t] if ch in "cbshm" else 1.0
                flen = (max(dims[v] / 64.0, 1.0) if all_m
                        else max(dims[v] * fill, 1e-9))
                flens.append(flen)
                if ch == "h":
                    sort_extra += 2.0 * flen   # in-stream sort conversion
                fprob *= fill
            lanes = (spec.lanes
                     if laned and pos.get(par_var, -1) <= pos[v] else 1)
            if flens:
                work = count * sum(flens)      # scan + merge advances
                matches = dims[v] * fprob      # expected intersection hits
            else:
                work = count * dims[v]         # broadcast result var
                matches = dims[v]
            stages.append(work / lanes)
            if sort_extra:
                stages.append(count * sort_extra / lanes)
            count *= max(matches, 1e-9)
        stages.append(count / (spec.lanes if laned else 1))  # values/reduce
        result_est += count
    merge = result_est if (spec.lanes > 1 or len(assign.terms) > 1) else 0.0
    steady = max(stages) if stages else 1.0
    cost = max(steady, merge) + 1e-3 * sum(stages)
    if spec.split and spec.lanes == 1:
        cost *= 1.02    # a split alone adds a level; prefer unsplit on ties
    return float(cost)


# ---------------------------------------------------------------------------
# search: analytic prune, then the Simulator on downsampled operands
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Candidate:
    spec: CandidateSpec
    schedule: Schedule
    analytic: float
    cycles: Optional[int] = None    # sampled-simulator cycles (the ranker)


@dataclasses.dataclass
class SearchReport:
    expr: str
    candidates: List[Candidate]     # simulated survivors, best first
    enumerated: int                 # size of the (possibly capped) space
    simulated: int                  # candidates actually run on the sampler
    sample_dims: Dict[str, int]
    elapsed_s: float
    # True when the loop-order space exceeded max_orders and was capped —
    # the search covered a lexicographic prefix, not every permutation
    orders_truncated: bool = False

    @property
    def best(self) -> Candidate:
        return self.candidates[0]


def _sampled_candidate_cycles(assign, fmt, spec: CandidateSpec,
                              sch: Schedule, s_arrays, s_dims) -> int:
    """Cost one candidate on the downsampled sample. Tiled specs clamp
    their tile grid to at most 8 cells on the sample (the sample extents
    are tiny) and scale the simulated cycles back up by the true/sampled
    grid-volume ratio — per-tile steady states add, so cycles grow
    linearly in the tile count."""
    if not spec.tile:
        return simulate_expr(assign, fmt, sch, s_arrays, s_dims).cycles
    from .tiling import n_tiles
    s_tile: Dict[str, int] = {}
    vol = 1
    for v, n in sorted(spec.tile):
        m = min(int(n), int(s_dims.get(v, 1)), max(1, 8 // vol))
        if m > 1:
            s_tile[v] = m
            vol *= m
    sch_s = dataclasses.replace(sch, tile=s_tile)
    cycles = simulate_expr(assign, fmt, sch_s, s_arrays, s_dims).cycles
    return int(cycles * n_tiles(dict(spec.tile)) / max(n_tiles(s_tile), 1))


def _expr_text(assign: Assignment) -> str:
    terms = []
    for t in assign.terms:
        txt = " * ".join(repr(f) for f in t.factors)
        terms.append(("- " if t.sign < 0 else ("+ " if terms else "")) + txt)
    return f"{assign.lhs!r} = " + " ".join(terms)


def random_operand(shape: Tuple[int, ...], density: float,
                   rng: np.random.Generator) -> np.ndarray:
    """The repo's one random sparse-operand generator (shared by the
    sampler, ``serve_sam``'s request synthesis, and the benchmark
    helpers, so the cost model's inputs match what serving runs): small
    positive integers at ``density``, or a scalar for an empty shape."""
    if not shape:
        return np.asarray(float(rng.integers(1, 5)))
    return ((rng.random(shape) < density)
            * rng.integers(1, 9, shape)).astype(float)


def synthetic_operands(assign: Assignment, dims: Dict[str, int],
                       densities: Dict[str, float], seed: int = 0,
                       only: Optional[set] = None
                       ) -> Dict[str, np.ndarray]:
    """Deterministic synthetic operands matching a sparsity hint — the
    sampler inputs for tensors the caller provided no concrete array for.
    ``only`` restricts generation to those tensor names."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for term in assign.terms:
        for acc in term.factors:
            if acc.tensor in out or (only is not None
                                     and acc.tensor not in only):
                continue
            shape = tuple(dims[v] for v in acc.vars)
            out[acc.tensor] = random_operand(
                shape, densities.get(acc.tensor, DEFAULT_SPARSITY), rng)
    return out


def search(expr: Union[str, Assignment], fmt: Format, dims: Dict[str, int], *,
           arrays: Optional[Dict[str, np.ndarray]] = None,
           sparsity: SparsityHint = None, top_k: int = 8, max_dim: int = 48,
           device_count: Optional[int] = None,
           split_factors: Sequence[int] = SPLIT_FACTORS,
           max_orders: int = MAX_ORDERS,
           mem_budget: Optional[int] = None,
           format_choices: Optional[Sequence[str]] = None) -> SearchReport:
    """Search the schedule space; return candidates ranked best-first.

    ``format_choices`` (e.g. ``autoschedule.FORMAT_CHOICES``) joins
    per-tensor level formats into the space: every schedule point is
    crossed with legal format overrides and ranked under them — both the
    analytic prune and the sampled simulation run with the candidate's
    ``spec.format(fmt)``. The winning overrides ride the report
    (``report.best.spec.formats``); ``None`` keeps the historical
    format-less space.

    Deterministic: the analytic prune sorts on (cost, spec key), the
    sampler inputs are either the caller's operands downsampled or seeded
    synthetic data, and the final ranking sorts on (sampled cycles,
    analytic cost, spec key) — two invocations with equal inputs return
    identical rankings.

    ``mem_budget`` (bytes) bounds schedule legality by estimated peak
    device allocation (``tiling.estimate_call_bytes``): every candidate
    whose untiled estimate exceeds the budget grows the minimal
    coordinate tiling that fits (``tiling.plan_tiles``) plus one
    2x-finer grid as a tile-size alternative; candidates that cannot fit
    even fully tiled are dropped. Without a budget the space is exactly
    the historical one.
    """
    assign = parse(expr) if isinstance(expr, str) else expr
    t0 = time.perf_counter()
    densities = resolve_densities(assign, sparsity, arrays)
    specs = enumerate_space(assign, dims, device_count=device_count,
                            split_factors=split_factors,
                            max_orders=max_orders, fmt=fmt,
                            format_choices=format_choices)
    scored = sorted(
        (analytic_cost(assign, fmt, dims, s, densities), s.key(), s)
        for s in specs)

    if mem_budget is not None:
        from . import tiling
        budget = tiling.parse_budget(mem_budget)
        expanded = []
        tightest: Optional[tiling.MemoryBudgetExceeded] = None
        for _, _, spec in scored:
            try:
                plan = tiling.plan_tiles(assign, fmt, spec.schedule(), dims,
                                         budget, densities=densities)
            except tiling.MemoryBudgetExceeded as e:
                if tightest is None or e.estimate < tightest.estimate:
                    tightest = e       # cannot fit even fully tiled
                continue
            variants = [plan]
            if plan:                   # tile-size search: minimal + finer
                finer = {}
                for v, n in plan.items():
                    f = min(2 * n, dims[v])
                    chunk = -(-dims[v] // f)
                    finer[v] = -(-dims[v] // chunk)   # effective grid only
                if finer != plan:
                    variants.append(finer)
            for t in variants:
                sp = dataclasses.replace(spec,
                                         tile=tuple(sorted(t.items())))
                expanded.append((analytic_cost(assign, fmt, dims, sp,
                                               densities), sp.key(), sp))
        if not expanded and tightest is not None:
            raise tiling.MemoryBudgetExceeded(
                f"no schedule in the enumerated space fits mem_budget="
                f"{tiling.format_bytes(budget)}, even fully tiled "
                f"(tightest candidate still needs "
                f"~{tiling.format_bytes(tightest.estimate)})",
                estimate=tightest.estimate, budget=budget)
        scored = sorted(expanded)

    # sampler inputs: provided operands downsampled; tensors without a
    # concrete array fall back to synthetic data at the hinted density
    s_arrays, s_dims = downsample_operands(assign, arrays or {}, dims,
                                           max_dim)
    missing = {acc.tensor for term in assign.terms
               for acc in term.factors} - set(s_arrays)
    if missing:
        s_arrays.update(synthetic_operands(assign, s_dims, densities,
                                           only=missing))

    candidates: List[Candidate] = []
    simulated = 0
    for cost, _, spec in scored:
        if len(candidates) >= top_k:
            break
        sch = spec.schedule()
        simulated += 1
        try:
            cycles = _sampled_candidate_cycles(assign, spec.format(fmt),
                                               spec, sch, s_arrays, s_dims)
        except Exception:              # noqa: BLE001 - schedule can't lower:
            continue                   # drop it, keep searching the ranking
        candidates.append(Candidate(spec=spec, schedule=sch,
                                    analytic=cost, cycles=cycles))
    if not candidates:
        raise ValueError(
            f"no schedule in the enumerated space lowers for {assign}")
    candidates.sort(key=lambda c: (c.cycles, c.analytic, c.spec.key()))
    return SearchReport(expr=_expr_text(assign), candidates=candidates,
                        enumerated=len(specs), simulated=simulated,
                        sample_dims=s_dims,
                        elapsed_s=time.perf_counter() - t0,
                        orders_truncated=(
                            math.factorial(len(assign.all_vars))
                            > max_orders))


# ---------------------------------------------------------------------------
# persistent schedule cache (DESIGN.md §5)
# ---------------------------------------------------------------------------

def default_cache_path() -> str:
    """$SAM_SCHEDULE_CACHE, else
    ~/.cache/sam-repro/schedules-torch-v<N>.json.

    The cache version is part of the default FILENAME so tools on
    different versions never share (and can never clobber) each other's
    stores — ``store()`` rewrites the whole file, and merging only
    recognizes same-version entries. The port's default file is its own
    (the reference's is ``schedules-v<N>.json``): a port search that
    diverged from the reference's must show, not be answered from the
    reference's picks. An explicit ``$SAM_SCHEDULE_CACHE`` override
    shares one file at the operator's discretion."""
    env = os.environ.get("SAM_SCHEDULE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "sam-repro",
                        f"schedules-torch-v{CACHE_VERSION}.json")


def dims_bucket(dims: Dict[str, int]) -> Dict[str, int]:
    """Power-of-two bucket per extent: shapes inside one bucket share a
    cache entry (the jit engine buckets capacities the same way)."""
    return {v: 1 if d <= 1 else 1 << (int(d) - 1).bit_length()
            for v, d in dims.items()}


def sparsity_bucket(p: float) -> float:
    """Nearest power-of-two density bucket in [2^-20, 1]."""
    p = min(max(float(p), 2.0 ** -20), 1.0)
    return 2.0 ** round(math.log2(p))


def auto_cache_key(assign: Union[str, Assignment], fmt: Format,
                   dims: Dict[str, int], densities: Dict[str, float],
                   device_count: Optional[int] = None) -> str:
    """Cache key of a search: canonical expression+format key (via
    ``custard.expr_cache_key`` over a fixed placeholder order, so the
    schedule itself is NOT part of the key) + dims bucket + per-tensor
    sparsity bucket + device count + cache version.

    The device count is part of the key because it bounds the enumerated
    lane counts: a schedule tuned on one device must not be served to a
    4-device caller (and vice versa)."""
    from .custard import expr_cache_key   # deferred: custard imports us lazily

    assign = parse(assign) if isinstance(assign, str) else assign
    if device_count is None:
        device_count = _device_count()
    placeholder = Schedule(loop_order=tuple(assign.all_vars))
    base = expr_cache_key(assign, fmt, placeholder, dims_bucket(dims))
    dpart = ",".join(f"{t}:{sparsity_bucket(p):g}"
                     for t, p in sorted(densities.items()))
    return (f"v{CACHE_VERSION}|{base}|density={dpart}"
            f"|devices={device_count}")


class ScheduleCache:
    """On-disk JSON store of search winners (format: DESIGN.md §5).

    Reads are lazy and tolerate a missing/corrupt/version-mismatched file
    (treated as empty); writes re-read, merge, and replace via an atomic
    rename, so concurrent processes can never observe a torn file. The
    read-merge-write is NOT locked: two processes storing at once can
    lose the other's newest entry — acceptable by design, since a lost
    entry only ever costs that shape a redundant re-search.
    """

    def __init__(self, path: Optional[os.PathLike] = None):
        self.path = str(path) if path is not None else default_cache_path()

    # -- io ------------------------------------------------------------
    def _load(self) -> Dict[str, dict]:
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return {}
        if not isinstance(data, dict) or data.get("version") != CACHE_VERSION:
            return {}                     # wrong shape/version: empty cache
        entries = data.get("entries")
        return entries if isinstance(entries, dict) else {}

    def _write(self, entries: Dict[str, dict]) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self.path) or ".",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"version": CACHE_VERSION, "entries": entries},
                          f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- api -----------------------------------------------------------
    def lookup(self, key: str) -> Optional[Schedule]:
        entry = self._load().get(key)
        if not isinstance(entry, dict):
            return None
        try:
            return schedule_from_dict(entry["schedule"])
        except (KeyError, TypeError, ValueError):
            return None                   # malformed entry == no entry

    def store(self, key: str, schedule: Schedule,
              meta: Optional[dict] = None) -> None:
        entries = self._load()
        entries[key] = {"schedule": schedule_to_dict(schedule),
                        "meta": dict(meta or {}),
                        "created": time.time()}
        self._write(entries)
        _RESOLVED[(self.path, key)] = (_file_stamp(self.path), schedule)

    def entries(self) -> Dict[str, dict]:
        return self._load()

    def clear(self) -> None:
        if os.path.exists(self.path):
            os.unlink(self.path)
        for k in [k for k in _RESOLVED if k[0] == self.path]:
            del _RESOLVED[k]


# ---------------------------------------------------------------------------
# the cache-aware entry point
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AutoResult:
    schedule: Schedule
    cache_hit: bool
    key: str
    report: Optional[SearchReport]   # None on a cache hit: no search ran


# in-process memo over the on-disk store: repeat resolutions of a hot key
# (every serving request re-resolving "auto") skip the file read + parse.
# Entries carry the cache file's (mtime_ns, size) stamp and are only
# honored while it still matches, so out-of-band edits or an operator's
# `rm` of the file are picked up at the cost of one stat() per resolve.
_Stamp = Optional[Tuple[int, int]]
_RESOLVED: Dict[Tuple[str, str], Tuple[_Stamp, Schedule]] = {}


def _file_stamp(path: str) -> _Stamp:
    try:
        st = os.stat(path)
        return (st.st_mtime_ns, st.st_size)
    except OSError:
        return None


def clear_resolution_memo() -> None:
    _RESOLVED.clear()


def resolve_schedule(expr: Union[str, Assignment], fmt: Format,
                     dims: Dict[str, int], *,
                     arrays: Optional[Dict[str, np.ndarray]] = None,
                     sparsity: SparsityHint = None,
                     cache: Union[None, bool, ScheduleCache] = None,
                     device_count: Optional[int] = None,
                     **search_kw) -> AutoResult:
    """Resolve ``schedule="auto"``: consult the persistent cache, search on
    a miss, persist the winner.

    ``cache``: None uses the default on-disk cache (``$SAM_SCHEDULE_CACHE``
    or ``~/.cache/sam-repro/schedules-torch-v<N>.json``); ``False`` disables
    persistence (always search); a ``ScheduleCache`` uses that store.
    """
    assign = parse(expr) if isinstance(expr, str) else expr
    densities = resolve_densities(assign, sparsity, arrays)
    if device_count is None:
        device_count = _device_count()
    if search_kw.get("mem_budget") is not None:
        # normalize "64MB"-style budgets so the cache key is stable
        from .tiling import parse_budget
        search_kw["mem_budget"] = parse_budget(search_kw["mem_budget"])
    key = auto_cache_key(assign, fmt, dims, densities, device_count)
    # a non-default search space (split_factors, max_orders, top_k,
    # max_dim, ...) explores different candidates, so its winners live
    # under their own cache entries; the default space keeps the bare key
    if search_kw:
        key += "|search=" + ",".join(
            f"{k}:{v}" for k, v in sorted(search_kw.items()))
    store: Optional[ScheduleCache]
    if cache is False:
        store = None
    elif cache is None or cache is True:
        store = ScheduleCache()
    else:
        store = cache
    if store is not None:
        memo_key = (store.path, key)
        stamp = _file_stamp(store.path)
        memo = _RESOLVED.get(memo_key)
        hit: Optional[Schedule] = None
        if memo is not None and stamp is not None and memo[0] == stamp:
            hit = memo[1]
        elif stamp is not None:
            hit = store.lookup(key)
        if hit is not None:
            _RESOLVED[memo_key] = (stamp, hit)
            return AutoResult(schedule=hit, cache_hit=True, key=key,
                              report=None)
    rep = search(assign, fmt, dims, arrays=arrays, sparsity=densities,
                 device_count=device_count, **search_kw)
    best = rep.best
    if store is not None:
        store.store(key, best.schedule,
                    {"expr": rep.expr, "cycles": best.cycles,
                     "analytic": best.analytic,
                     "sample_dims": rep.sample_dims,
                     "enumerated": rep.enumerated})   # also memoizes
    return AutoResult(schedule=best.schedule, cache_hit=False, key=key,
                      report=rep)
