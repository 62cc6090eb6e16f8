"""Multi-expression SAM programs with producer→consumer fusion.

The paper's §6 case studies compose whole kernels as ONE streaming graph
(SDDMM feeding SpMM); FuseFlow (PAPERS.md) shows that fusing sparse
producer→consumer expressions — never materializing the sparse
intermediate — is where streaming dataflow wins. This module adds that
program layer on top of the single-assignment compiler:

* ``parse_program`` parses a sequence of named assignments separated by
  ``;`` or newlines (``T(i,j) = B(i,k) * C(k,j); A(i,j) = T(i,k) * E(k,j)``)
  into a ``Program`` with its inter-expression dependency DAG.
* ``lower_program`` lowers every stage through ``custard.lower`` and
  decides, per intermediate tensor, whether the consumer can splice the
  producer's value/coordinate streams directly into its SAM graph
  (``FusionDecision``); illegal fusions fall back to materialization.
* ``simulate_program`` executes the stitched graphs: a fused consumer's
  level scanners of the intermediate are replaced by the producer's
  writer streams (``Simulator(inject=...)`` — a wire splice, paper §6
  style), and the steady-state cycle law extends across the fused
  pipeline: ``cycles = max(block works of all fused stages) + fill``.

Fusion legality (checked structurally on the lowered graphs; the full
rules live in DESIGN.md §6): the intermediate has exactly one consumer
stage, both stages are serial (no split/parallelize) single-term
lowerings, the intermediate is stored all-compressed and is not
locate/bitvector-accessed, the consumer iterates the intermediate's modes
in the producer's storage order, and the consumer's scanners of the
intermediate form a root-driven chain (its iteration of the intermediate
IS the producer's emission order). Everything else materializes — same
results, two pipelines instead of one.

The PyTorch counterpart (one plan-cached callable per fused chain,
intermediates living as on-device ``(seg, crd)`` tensors via the
``coo_to_levels`` dispatch entry) is ``torch_backend.compile_program``.

>>> prog = parse_program("T(i,k) = B(i,j) * C(j,k); x(i) = T(i,k) * d(k)")
>>> [a.lhs.tensor for a in prog.assigns], prog.inputs, prog.intermediates
(['T', 'x'], ('B', 'C', 'd'), ('T',))
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import graph as g
from . import streams as st
from .einsum import Assignment, Term, parse
from .fibertree import FiberTree
from .schedule import Format, Schedule, build_inputs


# ---------------------------------------------------------------------------
# parsing + the dependency DAG
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Program:
    """An ordered sequence of assignments forming a dependency DAG.

    Stage ``i`` may consume tensors defined by stages ``< i`` (the
    *intermediates*) and free *input* tensors. Each tensor is defined at
    most once (SSA over tensor names).
    """

    assigns: Tuple[Assignment, ...]

    def __post_init__(self):
        defined: Dict[str, int] = {}
        for i, a in enumerate(self.assigns):
            name = a.lhs.tensor
            if name in defined:
                raise ValueError(f"tensor {name!r} defined twice "
                                 f"(stages {defined[name]} and {i})")
            for t in a.input_tensors:
                if t == name:
                    raise ValueError(
                        f"stage {i} ({name}) reads its own output")
            defined[name] = i
        # a USE of a later-defined tensor would silently read the free
        # input instead of the stage output; reject it
        for i, a in enumerate(self.assigns):
            for t in a.input_tensors:
                if t in defined and defined[t] > i:
                    raise ValueError(
                        f"stage {i} reads {t!r} before stage {defined[t]} "
                        f"defines it (reorder the program)")

    @property
    def names(self) -> List[str]:
        return [a.lhs.tensor for a in self.assigns]

    @property
    def inputs(self) -> Tuple[str, ...]:
        """Free tensors: consumed but never defined."""
        defined = set(self.names)
        seen: List[str] = []
        for a in self.assigns:
            for t in a.input_tensors:
                if t not in defined and t not in seen:
                    seen.append(t)
        return tuple(seen)

    @property
    def intermediates(self) -> Tuple[str, ...]:
        """Defined tensors consumed by a later stage."""
        return tuple(n for i, n in enumerate(self.names)
                     if self.consumers(n))

    @property
    def outputs(self) -> Tuple[str, ...]:
        """Defined tensors no later stage consumes (the program results)."""
        return tuple(n for n in self.names if not self.consumers(n))

    def producer_of(self, tensor: str) -> Optional[int]:
        for i, a in enumerate(self.assigns):
            if a.lhs.tensor == tensor:
                return i
        return None

    def consumers(self, tensor: str) -> List[int]:
        """Stage indices that read ``tensor`` (after its definition)."""
        p = self.producer_of(tensor)
        return [i for i, a in enumerate(self.assigns)
                if (p is None or i > p) and tensor in a.input_tensors]

    def dependencies(self, i: int) -> List[int]:
        """Producer stage indices stage ``i`` consumes from."""
        defined = {a.lhs.tensor: j for j, a in enumerate(self.assigns[:i])}
        return sorted({defined[t] for t in self.assigns[i].input_tensors
                       if t in defined})

    def uses_of(self, i: int, tensor: str) -> int:
        """How many factor slots of stage ``i`` read ``tensor``."""
        return sum(1 for t in self.assigns[i].terms
                   for f in t.factors if f.tensor == tensor)


def parse_program(text: Union[str, Program, Sequence]) -> Program:
    """Parse ``;``/newline-separated assignments into a ``Program``.

    Accepts a ``Program`` (returned as-is) or a sequence of assignment
    texts / parsed ``Assignment`` objects. ``#`` starts a comment.

    >>> p = parse_program('''
    ...     T(i,j) = B(i,k) * C(k,j)      # stage 0
    ...     A(i,j) = T(i,k) * E(k,j)      # stage 1 consumes stage 0
    ... ''')
    >>> p.intermediates, p.outputs
    (('T',), ('A',))
    """
    if isinstance(text, Program):
        return text
    if isinstance(text, str):
        stmts = []
        for line in text.replace(";", "\n").splitlines():
            s = line.split("#", 1)[0].strip()
            if s:
                stmts.append(s)
    else:
        stmts = list(text)
    if not stmts:
        raise ValueError("empty program")
    assigns = tuple(parse(s) if isinstance(s, str) else s for s in stmts)
    return Program(assigns=assigns)


def numpy_reference(program: Union[str, Program],
                    arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Dense numpy oracle: evaluate every stage with ``np.einsum``.

    Returns the environment of ALL tensors (inputs + every stage result).

    >>> out = numpy_reference("T(i,k) = B(i,j) * C(j,k)",
    ...                       {"B": np.eye(2), "C": 2 * np.eye(2)})
    >>> out["T"].tolist()
    [[2.0, 0.0], [0.0, 2.0]]
    """
    program = parse_program(program)
    env = {k: np.asarray(v, dtype=float) for k, v in arrays.items()}
    for assign in program.assigns:
        letters: Dict[str, str] = {}

        def sub(vs):
            return "".join(letters.setdefault(v, chr(ord("a") + len(letters)))
                           for v in vs)

        total = None
        for t in assign.terms:
            spec = (",".join(sub(f.vars) for f in t.factors)
                    + "->" + sub(assign.lhs.vars))
            out = np.einsum(spec, *[env[f.tensor] for f in t.factors])
            total = t.sign * out if total is None else total + t.sign * out
        env[assign.lhs.tensor] = total
    return env


# ---------------------------------------------------------------------------
# per-stage schedules
# ---------------------------------------------------------------------------

def stage_dims(assign: Assignment, dims: Dict[str, int]) -> Dict[str, int]:
    out = {}
    for v in assign.all_vars:
        if v not in dims:
            raise ValueError(f"no extent for index variable {v!r} "
                             f"(stage {assign.lhs.tensor})")
        out[v] = dims[v]
    return out


def resolve_stage_schedules(program: Program, fmt: Format, schedules,
                            dims: Dict[str, int], *,
                            sparsity=None) -> List[Schedule]:
    """Normalize the ``schedules`` argument to one ``Schedule`` per stage.

    Accepts ``"auto"`` (every stage resolved through the autoscheduler and
    its persistent cache), a dict keyed by stage lhs tensor (missing
    stages default to the program-order loop order; values may be
    ``"auto"``), or a sequence aligned with the stages.
    """
    n = len(program.assigns)
    if isinstance(schedules, Schedule):
        if n != 1:
            raise ValueError("a single Schedule is ambiguous for a "
                             "multi-stage program; pass a dict/list/'auto'")
        per = [schedules]
    elif isinstance(schedules, str):
        if schedules != "auto":
            raise ValueError(f"schedules must be Schedule(s), a dict, or "
                             f"'auto', got {schedules!r}")
        per = ["auto"] * n
    elif isinstance(schedules, dict):
        per = [schedules.get(a.lhs.tensor,
                             Schedule(loop_order=tuple(a.all_vars)))
               for a in program.assigns]
    else:
        per = list(schedules)
        if len(per) != n:
            raise ValueError(f"{len(per)} schedules for {n} stages")
    out: List[Schedule] = []
    for assign, sch in zip(program.assigns, per):
        if isinstance(sch, str):
            if sch != "auto":
                raise ValueError(f"bad schedule {sch!r}")
            from .autoschedule import resolve_schedule
            # a program's stages run their lanes on one device, so the
            # search ranks for one, as compile_expr's does without
            # shard_lanes
            sch = resolve_schedule(assign, fmt, stage_dims(assign, dims),
                                   sparsity=sparsity,
                                   device_count=1).schedule
        out.append(sch)
    return out


# ---------------------------------------------------------------------------
# fusion legality
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FusionDecision:
    """Whether intermediate ``tensor`` (stage ``producer``) splices into
    stage ``consumer``; ``reason`` explains a fallback to materialization."""

    tensor: str
    producer: int
    consumer: int
    fused: bool
    reason: str = ""


def _dense_isect_passthrough(graph_: g.Graph, isect: g.Node, port: str,
                             prev: g.Node, fmt: Optional[Format]) -> bool:
    """True when ``isect`` forwards ``prev``'s stream unfiltered: the
    same-side crd/ref inputs come from ``prev`` and the other side is a
    dense, non-bitvector level scan. A dense level emits every
    coordinate of its range, so intersecting against it keeps the tensor
    side intact — splicing the producer's full emission through such an
    intersecter is semantics-preserving (the per-expert MoE dispatch
    chain hits exactly this shape: the expert index is co-iterated with
    a dense weight level at the intermediate's outer mode)."""
    if fmt is None or isect.kind != g.INTERSECT or isect.params.get("bv"):
        return False
    side = port[-1:]
    if port not in ("ref0", "ref1"):
        return False
    other = "1" if side == "0" else "0"
    ins = {e.dst_port: e for e in graph_.in_edges(isect)}
    same_crd, same_ref = ins.get(f"crd{side}"), ins.get(f"ref{side}")
    if (same_ref is None or same_ref.src != prev.id
            or same_ref.src_port != "ref"
            or same_crd is None or same_crd.src != prev.id
            or same_crd.src_port != "crd"):
        return False
    oc = ins.get(f"crd{other}")
    if oc is None:
        return False
    osrc = graph_.nodes[oc.src]
    if (osrc.kind != g.LEVEL_SCAN or osrc.params.get("bv")
            or oc.src_port != "crd"):
        return False
    t, m = osrc.params.get("tensor"), osrc.params.get("mode")
    if t is None or m is None:
        return False
    rank = 1 + max(n.params["mode"] for n in graph_.of_kind(g.LEVEL_SCAN)
                   if n.params.get("tensor") == t)
    return fmt.of(t, rank)[m] == "d"


def _scan_chain(graph_: g.Graph, tensor: str,
                fmt: Optional[Format] = None) -> Optional[List[g.Node]]:
    """The consumer's scanners of ``tensor`` as a root-driven chain, or
    None when the chain is broken (a scan driven by an intersect/repeat/
    locate output re-orders or filters the stream — splicing the
    producer's full emission there would change semantics).

    With ``fmt`` given, a scan reference that flows through an
    intersecter whose other input is a dense level scan still counts as
    chained: dense co-iteration never drops coordinates, so the stream
    reaching the scan is exactly the previous scan's emission (see
    ``_dense_isect_passthrough``)."""
    scans = sorted((n for n in graph_.of_kind(g.LEVEL_SCAN)
                    if n.params.get("tensor") == tensor),
                   key=lambda n: n.params["mode"])
    if any(n.params.get("tensor") == tensor
           for n in graph_.of_kind(g.LOCATE)):
        return None
    for i, node in enumerate(scans):
        if node.params["mode"] != i or node.params.get("bv"):
            return None
        refs = [e for e in graph_.in_edges(node) if e.dst_port == "ref"]
        if len(refs) != 1:
            return None
        src = graph_.nodes[refs[0].src]
        if i == 0:
            if src.kind != g.ROOT:
                return None
        elif src.id != scans[i - 1].id or refs[0].src_port != "ref":
            if not _dense_isect_passthrough(graph_, src, refs[0].src_port,
                                            scans[i - 1], fmt):
                return None
    return scans


def fusion_legality(program: Program, loweds: List["Lowered"],
                    fmt: Format, tensor: str) -> FusionDecision:
    """Decide fusion for one intermediate. Rules in DESIGN.md §6."""
    pi = program.producer_of(tensor)
    cons = program.consumers(tensor)
    ci = cons[0] if cons else -1

    def no(reason: str) -> FusionDecision:
        return FusionDecision(tensor, pi, ci, False, reason)

    if len(cons) != 1:
        return no(f"{len(cons)} consumer stages (need exactly 1)")
    plow, clow = loweds[pi], loweds[ci]
    for which, low in (("producer", plow), ("consumer", clow)):
        if low.split_of or low.par_n > 1:
            return no(f"{which} schedule splits/parallelizes")
        if len(low.assign.terms) != 1:
            return no(f"{which} is multi-term")
        if low.graph is None:
            return no(f"{which} has no combined graph")
    if not plow.result_vars:
        return no("scalar intermediate")
    if program.uses_of(ci, tensor) != 1:
        return no("consumer reads the intermediate more than once")
    acc = next(f for t in clow.assign.terms for f in t.factors
               if f.tensor == tensor)
    if any(v in clow.schedule.bitvector for v in acc.vars):
        return no("consumer iterates the intermediate as bitvectors")
    out_fmt = fmt.of(tensor, len(plow.result_vars))
    if set(out_fmt) != {"c"}:
        return no(f"intermediate format {out_fmt!r} is not all-compressed")
    # mode-order compatibility: the consumer must iterate the
    # intermediate's storage levels in the producer's emission order
    writer = next(n for n in plow.graph.of_kind(g.LEVEL_WRITE)
                  if n.params.get("var") == "vals")
    prod_modes = list(writer.params.get("mode_order", ()))
    cons_path = clow.schedule.tensor_path(acc.vars)
    cons_modes = [acc.vars.index(v) for v in cons_path]
    if cons_modes != prod_modes:
        return no(f"consumer iterates modes {cons_modes}, producer "
                  f"emits {prod_modes}")
    if _scan_chain(clow.graph, tensor, fmt) is None:
        return no("consumer's scanners of the intermediate are not a "
                  "root-driven chain")
    return FusionDecision(tensor, pi, ci, True)


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LoweredStage:
    assign: Assignment
    schedule: Schedule
    dims: Dict[str, int]
    lowered: Any                       # custard.Lowered
    fused_inputs: Tuple[str, ...]      # intermediates spliced into this stage
    fused_output: bool                 # lhs consumed via a splice (never
    #                                    materialized)

    @property
    def name(self) -> str:
        return self.assign.lhs.tensor


@dataclasses.dataclass
class LoweredProgram:
    program: Program
    fmt: Format
    dims: Dict[str, int]
    stages: List[LoweredStage]
    decisions: List[FusionDecision]    # one per intermediate, program order

    @property
    def fused_tensors(self) -> Tuple[str, ...]:
        return tuple(d.tensor for d in self.decisions if d.fused)

    def components(self) -> List[List[int]]:
        """Stage indices grouped into fused pipelines (singletons when a
        stage fuses with nothing), ordered by sink stage.

        Sink order is the correct execution order: a component's
        materialized inputs always come from another component's SINK
        (fused tensors never leave their component), and that producing
        sink precedes the consuming stage in program order.
        """
        parent = list(range(len(self.stages)))

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        for d in self.decisions:
            if d.fused:
                parent[find(d.consumer)] = find(d.producer)
        groups: Dict[int, List[int]] = {}
        for i in range(len(self.stages)):
            groups.setdefault(find(i), []).append(i)
        return [groups[k] for k in sorted(groups, key=lambda k: max(groups[k]))]


def _validate_intermediate_shapes(program: Program,
                                  dims: Dict[str, int]) -> None:
    for name in program.intermediates:
        pi = program.producer_of(name)
        pvars = program.assigns[pi].lhs.vars
        for ci in program.consumers(name):
            for t in program.assigns[ci].terms:
                for f in t.factors:
                    if f.tensor != name:
                        continue
                    if len(f.vars) != len(pvars) or any(
                            dims[a] != dims[p]
                            for a, p in zip(f.vars, pvars)):
                        raise ValueError(
                            f"stage {ci} accesses {name}({','.join(f.vars)})"
                            f" but stage {pi} defines "
                            f"{name}({','.join(pvars)}) with different "
                            f"extents")


def lower_program(program, fmt: Format, schedules, dims: Dict[str, int], *,
                  sparsity=None, fuse: bool = True) -> LoweredProgram:
    """Lower every stage and decide producer→consumer fusion.

    Args:
        program: program text, a ``Program``, or a sequence of assignments.
        fmt: per-tensor formats (intermediates included — the producer
            writes and the consumer reads the same format).
        schedules: ``"auto"``, a dict keyed by stage lhs tensor, or a
            sequence aligned with the stages (entries may be ``"auto"``).
        dims: extent of every index variable used by any stage.
        sparsity: density hint forwarded to the autoscheduler.
        fuse: set False to force materialization everywhere (the
            comparison baseline used by benchmarks and golden tests).

    Returns:
        A ``LoweredProgram``: per-stage ``custard.Lowered`` objects plus
        one ``FusionDecision`` per intermediate tensor.
    """
    from .custard import lower

    program = parse_program(program)
    for a in program.assigns:          # friendly error before any dims[...]
        stage_dims(a, dims)
    _validate_intermediate_shapes(program, dims)
    per = resolve_stage_schedules(program, fmt, schedules, dims,
                                  sparsity=sparsity)
    loweds = [lower(a, fmt, s, stage_dims(a, dims))
              for a, s in zip(program.assigns, per)]
    decisions: List[FusionDecision] = []
    for name in program.intermediates:
        if fuse:
            decisions.append(fusion_legality(program, loweds, fmt, name))
        else:
            decisions.append(FusionDecision(
                name, program.producer_of(name),
                program.consumers(name)[0], False, "fusion disabled"))
    fused_into: Dict[int, List[str]] = {}
    fused_out = set()
    for d in decisions:
        if d.fused:
            fused_into.setdefault(d.consumer, []).append(d.tensor)
            fused_out.add(d.producer)
    stages = [LoweredStage(assign=a, schedule=s,
                           dims=stage_dims(a, dims), lowered=lo,
                           fused_inputs=tuple(fused_into.get(i, ())),
                           fused_output=i in fused_out)
              for i, (a, s, lo) in enumerate(zip(program.assigns, per,
                                                 loweds))]
    return LoweredProgram(program=program, fmt=fmt, dims=dict(dims),
                          stages=stages, decisions=decisions)


def program_cache_key(lp: LoweredProgram) -> str:
    """Canonical key of a lowered program: the per-stage expression keys
    joined with the fusion plan (a fused and an unfused lowering of the
    same stages compile to different executables, so the decision is part
    of the key — DESIGN.md §6)."""
    from .custard import expr_cache_key

    parts = [expr_cache_key(s.assign, lp.fmt, s.schedule, s.dims)
             for s in lp.stages]
    plan = ",".join(f"{d.tensor}:{int(d.fused)}" for d in lp.decisions)
    return "||".join(parts) + f"||fuse={plan}"


# ---------------------------------------------------------------------------
# the stream splice (shared by simulator execution and the golden tests)
# ---------------------------------------------------------------------------

def writer_streams(simres, tensor: str, result_vars: Sequence[str]):
    """(crd streams per level, val stream) a stage's writers received."""
    env, graph_ = simres.edge_streams, simres.graph

    def port(name, p):
        for n in graph_.of_kind(g.LEVEL_WRITE):
            if n.name == name:
                return env[(n.id, p)]
        raise KeyError(name)

    crds = [port(f"{tensor}_{v}", "crd") for v in result_vars]
    return crds, port(f"{tensor}_vals", "val")


def _positional(stream, counter: List[int]):
    """Same-shaped stream whose leaves are the running flat position —
    exactly the child references a level scanner of the materialized
    fibertree would emit."""
    if isinstance(stream, list):
        return [_positional(c, counter) for c in stream]
    counter[0] += 1
    return counter[0] - 1


def splice_injection(consumer_graph: g.Graph, tensor: str,
                     crd_streams, val_stream, sign: int,
                     fmt: Optional[Format] = None
                     ) -> Tuple[Dict[Tuple[int, str], Any], FiberTree]:
    """Build the ``Simulator(inject=...)`` map that replaces the
    consumer's scanners of ``tensor`` with the producer's writer streams,
    plus the stub FiberTree carrying the (signed) flattened values for
    the consumer's array-load block."""
    scans = _scan_chain(consumer_graph, tensor, fmt)
    if scans is None or len(scans) != len(crd_streams):
        raise ValueError(f"stage does not splice {tensor!r}")
    inject: Dict[Tuple[int, str], Any] = {}
    for node, crd in zip(scans, crd_streams):
        inject[(node.id, "crd")] = crd
        inject[(node.id, "ref")] = _positional(crd, [0])
    flat = [0.0 if v is None else sign * float(v)
            for v in st.flatten(val_stream)]
    stub = FiberTree(shape=(), levels=[],
                     vals=np.asarray(flat, dtype=np.float64))
    return inject, stub


# ---------------------------------------------------------------------------
# program simulation with fused steady-state accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StageSim:
    name: str
    fused_inputs: Tuple[str, ...]
    fused_output: bool
    dense: np.ndarray
    result: Any            # SimResult (fused-consumer) or ExprSimResult
    work: Dict[int, int]   # adjusted per-block work (splices cost 1)
    depth: int
    cycles_standalone: int

    @property
    def sim_result(self):
        """The underlying serial ``SimResult`` (wire-level access)."""
        from .simulator import SimResult
        if isinstance(self.result, SimResult):
            return self.result
        return self.result.lanes[0].result


@dataclasses.dataclass
class ProgramSimResult:
    """End-to-end program simulation.

    ``cycles`` models fused pipelines with the same steady-state law as
    one graph: within a fused component every block of every stage runs
    concurrently (the intermediate's writers/scanners are spliced wires
    costing nothing), so the component takes
    ``max(block works) + sum(stage fills)``; components execute
    sequentially (a materialization is a barrier).
    """

    dense: Dict[str, np.ndarray]       # every stage's result (+ inputs)
    cycles: int
    component_cycles: List[int]
    stages: List[StageSim]
    decisions: List[FusionDecision]
    lowered: LoweredProgram

    def stage(self, name: str) -> StageSim:
        for s in self.stages:
            if s.name == name:
                return s
        raise KeyError(name)


def simulate_program(program, fmt: Format, schedules, dims: Dict[str, int],
                     arrays: Dict[str, np.ndarray], *,
                     fuse: bool = True) -> ProgramSimResult:
    """Simulate a program end-to-end; see ``ProgramSimResult``.

    Fused consumers run with the producer's writer streams spliced over
    their intermediate scanners; everything else runs ``simulate_expr``
    on materialized operands.

    >>> res = simulate_program(
    ...     "T(i,k) = B(i,j) * C(j,k); x(i) = T(i,k) * d(k)",
    ...     Format(default="c"),
    ...     {"T": Schedule(loop_order=("i", "j", "k")),
    ...      "x": Schedule(loop_order=("i", "k"))},
    ...     {"i": 2, "j": 2, "k": 2},
    ...     {"B": np.eye(2), "C": np.eye(2), "d": np.ones(2)})
    >>> res.dense["x"].tolist(), [d.fused for d in res.decisions]
    ([1.0, 1.0], [True])
    """
    from .simulator import Simulator, simulate_expr

    lp = lower_program(program, fmt, schedules, dims, fuse=fuse)
    env: Dict[str, np.ndarray] = {k: np.asarray(v, dtype=float)
                                  for k, v in arrays.items()}
    sims: List[StageSim] = []
    for i, stg in enumerate(lp.stages):
        low = stg.lowered
        if stg.fused_inputs:
            # build operand fibertrees for the non-spliced factors only
            ext = tuple(f for t in low.assign.terms for f in t.factors
                        if f.tensor not in stg.fused_inputs)
            sub = Assignment(lhs=low.assign.lhs, terms=(Term(1, ext),))
            tensors = build_inputs(sub, low.fmt, low.schedule,
                                   {a.tensor: env[a.tensor] for a in ext})
            inject: Dict[Tuple[int, str], Any] = {}
            for name in stg.fused_inputs:
                prod = sims[lp.program.producer_of(name)]
                crds, vals = writer_streams(
                    prod.sim_result, name,
                    lp.stages[lp.program.producer_of(name)]
                    .lowered.result_vars)
                inj, stub = splice_injection(
                    low.graph, name, crds, vals,
                    lp.stages[lp.program.producer_of(name)]
                    .lowered.terms[0].sign, fmt)
                inject.update(inj)
                tensors[name] = stub
            res = Simulator(low.graph, tensors, inject=inject).run()
            sign = low.terms[0].sign
            dense = sign * res.outputs[stg.name].to_dense()
            work = dict(res.work)
            depth = low.graph.depth()
            standalone = res.cycles
        else:
            res = simulate_expr(low.orig_assign, fmt, stg.schedule,
                                {t: env[t]
                                 for t in low.orig_assign.input_tensors},
                                stg.dims)
            dense = res.dense
            work = {nid: w for ls in res.lanes
                    for nid, w in ls.result.work.items()}
            depth = max((ls.result.graph.depth() for ls in res.lanes),
                        default=0)
            standalone = res.cycles
        if stg.fused_output:
            # the intermediate's writers become wires into the consumer
            for n in low.graph.of_kind(g.LEVEL_WRITE):
                work[n.id] = 1
        env[stg.name] = dense
        sims.append(StageSim(name=stg.name, fused_inputs=stg.fused_inputs,
                             fused_output=stg.fused_output, dense=dense,
                             result=res, work=work, depth=depth,
                             cycles_standalone=standalone))

    comp_cycles: List[int] = []
    for comp in lp.components():
        if len(comp) == 1 and not lp.stages[comp[0]].fused_output:
            comp_cycles.append(sims[comp[0]].cycles_standalone)
            continue
        steady = max(max(sims[i].work.values(), default=1) for i in comp)
        fill = sum(sims[i].depth for i in comp)
        comp_cycles.append(steady + fill)
    return ProgramSimResult(dense=env, cycles=sum(comp_cycles),
                            component_cycles=comp_cycles, stages=sims,
                            decisions=lp.decisions, lowered=lp)
