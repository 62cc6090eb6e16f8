"""Custard: compile tensor index notation + formats + schedule to SAM (§5).

Lowering algorithm (paper Fig. 10, plus the dropper/reducer placement rules
derived from §3.6-3.7 and validated against every row of Table 1):

1. Parse to sum-of-products; each product term is lowered over its scope
   ``vars(term) ∪ result_vars`` in the scheduled loop order.
2. Tensor iteration & merging: walk index variables outer→inner. Per term,
   a tensor with the variable gets a level scanner chained off its current
   reference stream (or a locator, §4.2); with ≥2 in-term sources an m-ary
   intersecter merges them. Result variables of multi-term expressions are
   then merged across terms with an m-ary unioner. Tensors without the
   variable get a repeater fed by the final (merged) coordinate stream.
3. Computation: per term, value arrays load each tensor's final references;
   an ALU tree multiplies them. Reductions are applied innermost-first; the
   reducer dimension n = #result vars strictly below the reduced variable
   (scalar/vector/matrix reducers of Def 3.7).
4. Coordinate droppers:
   * single-term: after each reduction stage, a dropper cleans the nearest
     result variable above it, then the drop *cascades* to every result
     variable further out; intersections below a result variable with no
     reduction in between likewise trigger a dropper + cascade.
   * multi-term: per-term droppers would delete union coordinates another
     term still needs, so a single value-dropper chain cleans the final
     result bottom-up (this reproduces Residual/MatTransMul's counts).
5. Tensor construction: per result variable a level writer (+ one value
   writer) stores the cleaned streams.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from . import graph as g
from . import streams as st
from .einsum import Access, Assignment, Term, parse
from .fibertree import spec_of
from .schedule import (Format, Schedule, build_inputs, split_assignment,
                       split_dims, split_format, split_schedule,
                       unsplit_result)

Port = Tuple[g.Node, str]


@dataclasses.dataclass
class _TermState:
    term: Term
    scope: Tuple[str, ...]                       # loop vars this term iterates
    cur_ref: Dict[int, Port]                     # factor idx -> ref producer
    crd: Dict[str, Port] = dataclasses.field(default_factory=dict)
    val: Optional[Port] = None                   # combined value stream
    # crd streams of result vars as currently cleaned (updated by reduce/drop)
    out_crd: Dict[str, Port] = dataclasses.field(default_factory=dict)
    # static nesting depth of each result var's crd stream (declared on
    # reduce/drop nodes so degenerate all-empty streams — routine under
    # §4.4 lane chunking — cannot lose their structure)
    crd_depth: Dict[str, int] = dataclasses.field(default_factory=dict)


class Custard:
    def __init__(self, assign: Assignment, fmt: Format, schedule: Schedule,
                 dims: Dict[str, int]):
        if schedule.split:
            raise ValueError(
                "Custard lowers split-free schedules; use custard.lower(), "
                "which applies Schedule.split first")
        self.a = assign
        self.fmt = fmt
        self.s = schedule
        self.dims = dims
        self.graph = g.Graph(name=assign.lhs.tensor)
        self.pos = {v: i for i, v in enumerate(schedule.loop_order)}
        missing = [v for v in assign.all_vars if v not in self.pos]
        if missing:
            raise ValueError(f"loop order missing vars {missing}")
        self.result_vars = [v for v in schedule.loop_order
                            if v in assign.result_vars]
        # §4.4 parallelization: scanners of the parallelized variable are
        # marked with the lane count; execution supplies the lane id.
        par = {v: n for v, n in schedule.parallelize.items() if n > 1}
        if len(par) > 1:
            raise NotImplementedError(
                "parallelize supports one variable per schedule")
        self.par_var, self.par_n = next(iter(par.items()), (None, 1))
        if self.par_var is not None and self.par_var not in self.pos:
            raise ValueError(
                f"parallelize var {self.par_var!r} not in loop order")

    # ------------------------------------------------------------------
    def compile(self) -> g.Graph:
        G = self.graph
        root = G.add(g.ROOT, "root")
        terms: List[_TermState] = []
        for t in self.a.terms:
            scope = tuple(v for v in self.s.loop_order
                          if v in t.vars or v in self.a.result_vars)
            st_ = _TermState(term=t, scope=scope,
                             cur_ref={i: (root, "ref")
                                      for i in range(len(t.factors))})
            terms.append(st_)

        # non-unique (COO/singleton) tensors: a tree-conversion node sits
        # between the root and the tensor's scanners — the stored tree is
        # rebuilt into canonical unique levels once, in-stream, before any
        # scanner reads it (graph.py CONVERT, op="tree"); the node also
        # exposes the converted top-level coordinate fiber on its "crd"
        # port for wire-level observability
        tree_cvt: Dict[str, g.Node] = {}
        for ts_ in terms:
            for i, f in enumerate(ts_.term.factors):
                fstr = self.fmt.of(f.tensor, len(f.vars)) or ""
                if all(spec_of(ch).unique for ch in fstr):
                    continue
                node = tree_cvt.get(f.tensor)
                if node is None:
                    node = G.add(
                        g.CONVERT, f"{f.tensor}_cvt", tensor=f.tensor,
                        op="tree", from_format=fstr,
                        to_format="".join(
                            ch if spec_of(ch).unique else "c"
                            for ch in fstr))
                    G.connect(root, "ref", node, "ref", st.REF)
                    tree_cvt[f.tensor] = node
                ts_.cur_ref[i] = (node, "ref")

        multi = len(terms) > 1
        union_crd: Dict[str, Port] = {}

        # -- 2. iteration & merging, variable by variable ------------------
        for v in self.s.loop_order:
            per_term_bundle: List[Tuple[_TermState, Port, List[Tuple[int, Port]]]] = []
            for ts in terms:
                if v not in ts.scope:
                    continue
                sources = [i for i, f in enumerate(ts.term.factors)
                           if v in f.vars and (f.tensor, v) not in self.s.locate]
                located = [i for i, f in enumerate(ts.term.factors)
                           if v in f.vars and (f.tensor, v) in self.s.locate]
                if not sources and not located:
                    # broadcast-only var for this term: crd provided by the
                    # union across terms (handled after union)
                    per_term_bundle.append((ts, None, []))
                    continue
                # word-packed co-iteration: explicit schedule opt-in, or
                # automatic when EVERY scanned source stores this level as
                # a bitmap ('m') — the §4.3 b-bits-per-cycle win without a
                # schedule annotation
                src_chars = [self._level_char(ts.term.factors[i], v)
                             for i in sources]
                use_bv = (v in self.s.bitvector
                          or (bool(src_chars)
                              and all(ch == "m" for ch in src_chars)))
                scanned: List[Tuple[int, Port, Port]] = []  # (idx, crd, ref)
                for i in sources:
                    f = ts.term.factors[i]
                    mode = self.s.tensor_path(f.vars).index(v)
                    node = G.add(
                        g.LEVEL_SCAN, f"{f.tensor}_{v}",
                        tensor=f.tensor, mode=mode,
                        var=v, bv=use_bv, **self._chunk(v))
                    src, port = ts.cur_ref[i]
                    G.connect(src, port, node, "ref", st.REF)
                    crd_port = (node, "bv" if use_bv else "crd")
                    ref_port: Port = (node, "ref")
                    if not use_bv and not spec_of(
                            self._level_char(f, v)).ordered:
                        # unordered (hashed) level: an in-stream sort
                        # conversion restores ascending coordinate order
                        # before any downstream merge (op="sort")
                        cvt = G.add(g.CONVERT, f"{f.tensor}_{v}_cvt",
                                    tensor=f.tensor, var=v, mode=mode,
                                    op="sort")
                        G.connect(node, "crd", cvt, "crd", st.CRD)
                        G.connect(node, "ref", cvt, "ref", st.REF)
                        crd_port, ref_port = (cvt, "crd"), (cvt, "ref")
                    scanned.append((i, crd_port, ref_port))
                if len(scanned) >= 2:
                    inter = G.add(
                        g.INTERSECT, f"{v}_isect",
                        arity=len(scanned), var=v,
                        skip=(v in self.s.skip), bv=use_bv)
                    for k, (i, crd_p, ref_p) in enumerate(scanned):
                        G.connect(crd_p[0], crd_p[1], inter,
                                  f"bv{k}" if use_bv else f"crd{k}",
                                  st.BV if use_bv else st.CRD)
                        G.connect(ref_p[0], ref_p[1], inter, f"ref{k}", st.REF)
                    term_crd: Port = (inter, "crd")
                    refs = [(i, (inter, f"ref{k}"))
                            for k, (i, _, _) in enumerate(scanned)]
                elif scanned:
                    i, crd_p, ref_p = scanned[0]
                    term_crd = crd_p
                    refs = [(i, ref_p)]
                    if use_bv and not located:
                        # lone bitvector stream: recover crd/refs via a
                        # 1-ary intersect (popcount reference recovery)
                        inter = G.add(g.INTERSECT, f"{v}_bvrecover",
                                      arity=1, var=v, bv=True)
                        G.connect(crd_p[0], crd_p[1], inter, "bv0", st.BV)
                        G.connect(ref_p[0], ref_p[1], inter, "ref0", st.REF)
                        term_crd = (inter, "crd")
                        refs = [(i, (inter, "ref0"))]
                else:
                    term_crd = None
                    refs = []
                # locators probe with the merged coordinate stream
                for i in located:
                    f = ts.term.factors[i]
                    loc = G.add(g.LOCATE, f"{f.tensor}_{v}_loc",
                                tensor=f.tensor,
                                mode=self.s.tensor_path(f.vars).index(v),
                                var=v)
                    if term_crd is None:
                        raise ValueError(
                            f"locate({f.tensor},{v}) needs a co-iterated "
                            f"source stream")
                    G.connect(term_crd[0], term_crd[1], loc, "crd", st.CRD)
                    src, port = ts.cur_ref[i]
                    G.connect(src, port, loc, "ref", st.REF)
                    refs.append((i, (loc, "ref")))
                per_term_bundle.append((ts, term_crd, refs))

            if not per_term_bundle:
                continue

            # cross-term union at result variables
            is_result = v in self.a.result_vars
            active = [b for b in per_term_bundle if b[1] is not None]
            if multi and is_result and len(active) > 1:
                uni = G.add(g.UNION, f"{v}_union", arity=len(active), var=v)
                for k, (ts, crd_p, refs) in enumerate(active):
                    G.connect(crd_p[0], crd_p[1], uni, f"crd{k}", st.CRD)
                    for j, (i, ref_p) in enumerate(refs):
                        G.connect(ref_p[0], ref_p[1], uni, f"ref{k}_{j}", st.REF)
                merged: Port = (uni, "crd")
                union_crd[v] = merged
                for k, (ts, crd_p, refs) in enumerate(active):
                    ts.crd[v] = merged
                    for j, (i, _) in enumerate(refs):
                        ts.cur_ref[i] = (uni, f"ref{k}_{j}")
            else:
                for ts, crd_p, refs in per_term_bundle:
                    crd_final = crd_p if crd_p is not None else union_crd.get(v)
                    if crd_final is None:
                        raise NotImplementedError(
                            f"no coordinate source for {v} in term {ts.term}")
                    ts.crd[v] = crd_final
                    for i, ref_p in refs:
                        ts.cur_ref[i] = ref_p

            # repeaters for tensors missing v (fed by the final crd stream)
            for ts, _, _ in per_term_bundle:
                crd_src = ts.crd[v]
                if v in self.a.result_vars:
                    ts.out_crd[v] = crd_src
                    ts.crd_depth[v] = ts.scope.index(v) + 1
                for i, f in enumerate(ts.term.factors):
                    if v in f.vars:
                        continue
                    rep = G.add(g.REPEAT, f"{f.tensor}_rep_{v}",
                                tensor=f.tensor, var=v)
                    src, port = ts.cur_ref[i]
                    G.connect(src, port, rep, "ref", st.REF)
                    G.connect(crd_src[0], crd_src[1], rep, "crd", st.CRD)
                    ts.cur_ref[i] = (rep, "ref")

        # -- 3. computation -------------------------------------------------
        for ts in terms:
            vals: List[Port] = []
            for i, f in enumerate(ts.term.factors):
                arr = G.add(g.ARRAY, f"{f.tensor}_vals", tensor=f.tensor)
                src, port = ts.cur_ref[i]
                G.connect(src, port, arr, "ref", st.REF)
                vals.append((arr, "val"))
            cur = vals[0]
            for nxt in vals[1:]:
                alu = G.add(g.ALU, "mul", op="mul")
                G.connect(cur[0], cur[1], alu, "a", st.VAL)
                G.connect(nxt[0], nxt[1], alu, "b", st.VAL)
                cur = (alu, "val")
            ts.val = cur

            # reductions, innermost first; each stage eagerly cleans the
            # nearest result variable above it (paper §3.7; this eager
            # per-stage placement is what produces e.g. MTTKRP's 3 droppers)
            red_vars = [v for v in reversed(ts.scope)
                        if v not in self.a.result_vars]
            stage_drops: List[str] = []
            val_depth = len(ts.scope)
            for u in red_vars:
                below = [w for w in self.result_vars
                         if self.pos[w] > self.pos[u] and w in ts.scope]
                n = len(below)
                empty = self.s.reduce_empty or ("zero" if (n == 0) else "remove")
                if multi and n == 0:
                    empty = "zero"   # alignment across unioned terms
                red = G.add(g.REDUCE, f"red_{u}", n=n, var=u, empty=empty,
                            depth=val_depth)
                G.connect(ts.val[0], ts.val[1], red, "val", st.VAL)
                for k, w in enumerate(below):
                    cp = ts.out_crd[w]
                    G.connect(cp[0], cp[1], red, f"crd{k}", st.CRD)
                    ts.out_crd[w] = (red, f"crd{k}")
                    ts.crd_depth[w] = (val_depth - n - 1) + k + 1
                ts.val = (red, "val")
                val_depth -= 1
                if not multi:
                    above = [w for w in self.result_vars
                             if self.pos[w] < self.pos[u]]
                    if above:
                        w = above[-1]
                        stage_drops.append(w)
                        oc, val = self._drop_chain(
                            {v: ts.out_crd[v] for v in self.result_vars},
                            ts.val, [w], ts.crd_depth)
                        ts.out_crd.update(oc)
                        ts.val = val

            if not multi:
                self._place_cascade_droppers(ts, stage_drops)

        # -- combine terms ----------------------------------------------------
        if multi:
            cur = terms[0].val
            if terms[0].term.sign < 0:
                raise NotImplementedError("leading negative term")
            for ts in terms[1:]:
                alu = G.add(g.ALU, "addsub",
                            op="sub" if ts.term.sign < 0 else "add")
                G.connect(cur[0], cur[1], alu, "a", st.VAL)
                G.connect(ts.val[0], ts.val[1], alu, "b", st.VAL)
                cur = (alu, "val")
            final_val = cur
            out_crd = {v: union_crd.get(v, terms[0].out_crd.get(v))
                       for v in self.result_vars}
            # final value-dropper chain (bottom-up) if anything can vanish
            needs_drop = any(
                n.kind in (g.INTERSECT, g.REDUCE, g.LOCATE)
                for n in G.nodes.values())
            if needs_drop and self.result_vars:
                out_crd, final_val = self._drop_chain(
                    out_crd, final_val, [self.result_vars[-1]],
                    terms[0].crd_depth)
        else:
            final_val = terms[0].val
            out_crd = dict(terms[0].out_crd)

        # -- 5. construction ---------------------------------------------------
        shape = tuple(self.dims[v] for v in self.result_vars)
        out_fmt = self.fmt.of(self.a.lhs.tensor, len(self.result_vars))
        # storage order follows the dataflow order; record the mode
        # permutation so the result can be read back in lhs orientation
        out_mode_order = tuple(self.a.lhs.vars.index(v)
                               for v in self.result_vars)
        val_writer = G.add(g.LEVEL_WRITE, f"{self.a.lhs.tensor}_vals",
                           tensor=self.a.lhs.tensor, var="vals",
                           shape=shape, format=out_fmt,
                           mode_order=out_mode_order)
        G.connect(final_val[0], final_val[1], val_writer, "val", st.VAL)
        for k, v in enumerate(self.result_vars):
            w = G.add(g.LEVEL_WRITE, f"{self.a.lhs.tensor}_{v}",
                      tensor=self.a.lhs.tensor, var=v, pos=k,
                      format=out_fmt)
            cp = out_crd[v]
            G.connect(cp[0], cp[1], w, "crd", st.CRD)

        G.validate()
        return G

    # ------------------------------------------------------------------
    def _chunk(self, v: str) -> Dict[str, int]:
        """Scanner params for §4.4 lane duplication: the parallelized
        variable's coordinate space partitions into ``chunk_n`` contiguous
        chunks; a scanner so marked emits only its lane's chunk when the
        executor supplies a lane id (and the full space otherwise)."""
        if v == self.par_var:
            return {"chunk_n": self.par_n}
        return {}

    def _level_char(self, f: Access, v: str) -> str:
        """Storage-format letter of factor ``f``'s level at variable ``v``."""
        fstr = self.fmt.of(f.tensor, len(f.vars)) or ""
        k = self.s.tensor_path(f.vars).index(v)
        return fstr[k] if k < len(fstr) else "c"

    def _place_cascade_droppers(self, ts: _TermState,
                                stage_drops: List[str]) -> None:
        """Cascade cleanup above the stage drops (+ rule C when none)."""
        drops: List[str] = []
        if stage_drops:
            outermost = min(stage_drops, key=lambda v: self.pos[v])
            for w in reversed(self.result_vars):
                if self.pos[w] < self.pos[outermost]:
                    drops.append(w)
        else:
            # rule C: an intersection below a result var (pure elementwise
            # expressions with no reduction) still empties outer fibers
            isect_levels = [n.params["var"] for n in self.graph.nodes.values()
                            if n.kind in (g.INTERSECT, g.LOCATE)]
            if isect_levels:
                deepest = max(self.pos[v] for v in isect_levels)
                above = [w for w in self.result_vars if self.pos[w] < deepest]
                if above:
                    drops = [w for w in reversed(self.result_vars)
                             if self.pos[w] <= self.pos[above[-1]]]
        if not drops:
            return
        drops.sort(key=lambda v: -self.pos[v])  # innermost-first
        out_crd, val = self._drop_chain(
            {v: ts.out_crd[v] for v in self.result_vars}, ts.val, drops,
            ts.crd_depth)
        ts.out_crd.update(out_crd)
        ts.val = val

    def _drop_chain(self, out_crd: Dict[str, Port], val: Port,
                    drops: List[str], crd_depth: Dict[str, int]
                    ) -> Tuple[Dict[str, Port], Port]:
        """Insert droppers for ``drops`` (innermost-first), cascading the
        cleaned streams. Inner stream = next result level's crd stream, or
        the value stream for the innermost result var."""
        G = self.graph
        out_crd = dict(out_crd)
        for v in drops:
            deeper = [w for w in self.result_vars if self.pos[w] > self.pos[v]]
            inner_is_val = not deeper
            node = G.add(g.CRD_DROP, f"drop_{v}", var=v,
                         inner="vals" if inner_is_val else deeper[0],
                         outer_depth=crd_depth.get(v))
            cp = out_crd[v]
            G.connect(cp[0], cp[1], node, "outer", st.CRD)
            if inner_is_val:
                G.connect(val[0], val[1], node, "inner", st.VAL)
                val = (node, "inner")
            else:
                ip = out_crd[deeper[0]]
                G.connect(ip[0], ip[1], node, "inner", st.CRD)
                out_crd[deeper[0]] = (node, "inner")
                # passengers: deeper crd streams + values
                for pi, w in enumerate(deeper[1:]):
                    pp = out_crd[w]
                    G.connect(pp[0], pp[1], node, f"pass{pi}", st.CRD)
                    out_crd[w] = (node, f"pass{pi}")
                G.connect(val[0], val[1], node, f"pass{len(deeper) - 1}",
                          st.VAL)
                val = (node, f"pass{len(deeper) - 1}")
            out_crd[v] = (node, "outer")
        return out_crd, val


def compile_expr(expr: str, fmt: Format, schedule, dims: Dict[str, int]
                 ) -> g.Graph:
    """Lower an expression to its combined SAM dataflow graph.

    Args:
        expr: tensor index notation (or a parsed ``Assignment``), e.g.
            ``"x(i) = B(i,j) * c(j)"``.
        fmt: per-tensor level formats (``schedule.Format``).
        schedule: a ``Schedule`` (its ``split`` is applied internally), or
            the string ``"auto"`` to search for one (see ``lower``).
        dims: extent of every index variable.

    Returns:
        The validated ``graph.Graph`` ready for ``simulator.simulate`` or
        ``torch_backend.execute_graph``.

    >>> from repro_torch.core.schedule import Format, Schedule
    >>> G = compile_expr("x(i) = B(i,j) * c(j)", Format({"B": "cc", "c": "c"}),
    ...                  Schedule(loop_order=("i", "j")), {"i": 4, "j": 3})
    >>> G.primitive_counts()["intersect"]
    1
    """
    low = lower(expr, fmt, schedule, dims)
    if low.graph is None:
        raise low.graph_error
    return low.graph


# ---------------------------------------------------------------------------
# canonical form + lowering cache (the compiled-engine front half)
# ---------------------------------------------------------------------------

def expr_cache_key(assign: Assignment, fmt: Format, schedule: Schedule,
                   dims: Dict[str, int]) -> str:
    """Canonical key of (expression, formats, schedule, dims).

    Two invocations with the same key lower to identical SAM graphs, so the
    key memoizes both the Custard lowering and (together with the capacity
    bucket) the jitted executable in the JAX backend.
    """
    orders: Dict[str, int] = {assign.lhs.tensor: len(assign.lhs.vars)}
    for t in assign.terms:
        for f in t.factors:
            orders.setdefault(f.tensor, len(f.vars))
    parts = [
        "fmtdef=" + fmt.default,
        "lhs=" + repr(assign.lhs),
        "terms=" + ";".join(
            f"{t.sign:+d}:" + "*".join(repr(f) for f in t.factors)
            for t in assign.terms),
        "fmt=" + ",".join(f"{t}:{fmt.of(t, o)}"
                          for t, o in sorted(orders.items())),
        "order=" + ",".join(schedule.loop_order),
        "locate=" + ",".join(f"{t}.{v}" for t, v in sorted(schedule.locate)),
        "skip=" + ",".join(sorted(schedule.skip)),
        "bv=" + ",".join(sorted(schedule.bitvector)),
        "split=" + ",".join(f"{k}:{v}"
                            for k, v in sorted(schedule.split.items())),
        "par=" + ",".join(f"{k}:{v}"
                          for k, v in sorted(schedule.parallelize.items())),
        "empty=" + str(schedule.reduce_empty),
        "tile=" + ",".join(f"{k}:{v}"
                           for k, v in sorted(schedule.tile.items())),
        "dims=" + ",".join(f"{k}:{v}" for k, v in sorted(dims.items())),
    ]
    return "|".join(parts)


# ---------------------------------------------------------------------------
# full lowering: split expansion + parallel lane duplication (§4.1, §4.4)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TermLowering:
    """One product term's single-term SAM graph + its §4.4 lane count.

    ``lane_n > 1`` means the graph's scanners of the parallelized variable
    are ``chunk_n``-marked: executing the SAME graph once per lane id
    (each lane restricted to its coordinate chunk) partitions the term's
    iteration space, and summing the lane outputs reconstructs the term.
    Terms that do not iterate the parallelized variable run as one lane.
    ``graph`` is None when the term cannot lower stand-alone (it relies on
    a cross-term union for a coordinate source); ``Lowered.term_error``
    carries the reason.
    """

    sign: int
    graph: Optional[g.Graph]
    lane_n: int = 1


@dataclasses.dataclass
class Lowered:
    """A fully lowered expression: split applied, lanes duplicated.

    Holds both coordinate spaces: the ORIGINAL one the caller's arrays and
    results live in, and the post-split one the SAM graphs iterate.
    """

    orig_assign: Assignment
    orig_dims: Dict[str, int]
    orig_fmt: Format
    assign: Assignment               # post-split
    fmt: Format                      # post-split (formats expanded)
    schedule: Schedule               # post-split (split={}, par renamed)
    dims: Dict[str, int]             # post-split extents
    split_of: Dict[str, int]         # original var -> split factor
    par_var: Optional[str]           # post-split name (e.g. "ko"), or None
    par_n: int                       # lane count (1 = serial)
    # combined (multi-term) SAM graph; None when only the per-term
    # factoring lowers (e.g. a leading negative term)
    graph: Optional[g.Graph]
    graph_error: Optional[Exception]
    terms: List[TermLowering]
    term_error: Optional[Exception]  # why per-term lowering failed, if it did

    @property
    def result_vars(self) -> List[str]:
        return [v for v in self.schedule.loop_order
                if v in self.assign.result_vars]

    @property
    def orig_result_vars(self) -> List[str]:
        return [v for v in self.orig_assign.lhs.vars]

    @property
    def merge_kind(self) -> str:
        """Lane-merge topology: parallelizing a result variable yields
        disjoint lane outputs (``concat``); a contraction variable yields
        overlapping partial sums (``reduce``). Both are served by one
        keyed sum-merge over the lane outputs."""
        if self.par_n <= 1:
            return "none"
        return ("concat" if self.par_var in self.assign.result_vars
                else "reduce")

    def build_inputs(self, arrays) -> Dict[str, "FiberTree"]:
        return build_inputs(self.assign, self.fmt, self.schedule, arrays,
                            split_of=self.split_of)

    def unsplit(self, dense):
        """Map a dense result from post-split axes (lhs order) back to the
        original coordinate space, trimming split padding."""
        if not self.split_of:
            return dense
        return unsplit_result(dense, self.orig_assign.lhs.vars,
                              self.split_of, self.orig_dims)

    def require_terms(self) -> List[TermLowering]:
        if self.term_error is not None:
            raise self.term_error
        return self.terms


_LOWERED_CACHE: Dict[str, Lowered] = {}


def lower(expr, fmt: Format, schedule, dims: Dict[str, int]) -> Lowered:
    """Lower an expression with its FULL schedule, memoized.

    Args:
        expr: tensor index notation text or a parsed ``Assignment``.
        fmt: per-tensor level formats.
        schedule: a ``Schedule``, or the string ``"auto"`` to let the
            autoscheduler pick one — the schedule space (loop orders,
            split factors, lane counts) is searched with the simulator as
            cost model and the winner is remembered in the persistent
            on-disk schedule cache (``autoschedule.resolve_schedule``,
            DESIGN.md §5), so a shape is only ever searched once.
        dims: extent of every index variable.

    Returns:
        A ``Lowered``: the combined multi-term SAM graph (when it exists),
        the per-term graphs + §4.4 lane counts, and both coordinate
        spaces (original and post-split).

    ``Schedule.split`` expands each split variable into split-level
    scanners: the variable's coordinate space is partitioned into
    ``factor`` chunks by rewriting ``v -> (vo, vi)`` across the expression,
    formats, dims and schedule (§4.1). ``Schedule.parallelize`` then
    duplicates each affected term's subgraph into ``n`` lanes whose
    par-var scanners are restricted to one coordinate chunk each (§4.4);
    the lanes re-join through a keyed sum-merge (see ``merge_kind``).

    >>> from repro_torch.core.schedule import Format, Schedule
    >>> low = lower("x(i) = B(i,j) * c(j)", Format({"B": "cc", "c": "c"}),
    ...             Schedule(loop_order=("i", "j"), split={"j": 2}),
    ...             {"i": 4, "j": 6})
    >>> low.schedule.loop_order, low.dims["jo"], low.dims["ji"]
    (('i', 'jo', 'ji'), 2, 3)
    >>> low.result_vars
    ['i']
    """
    if isinstance(schedule, str):
        if schedule != "auto":
            raise ValueError(
                f"schedule must be a Schedule or 'auto', got {schedule!r}")
        from .autoschedule import resolve_schedule
        # the port runs a lowering's lanes on one device, so the search
        # ranks for one, as compile_expr's does without shard_lanes
        schedule = resolve_schedule(expr, fmt, dims,
                                    device_count=1).schedule
    if schedule.tile:
        raise ValueError(
            "Custard lowers one tile at a time: a tiled schedule "
            f"(tile={schedule.tile}) executes through the out-of-core "
            "engine — torch_backend.compile_expr routes it to TiledExpr, "
            "simulator.simulate_expr models the tile stream (docs/"
            "TILING.md); strip `tile` to lower a single tile's graph")
    assign = parse(expr) if isinstance(expr, str) else expr
    key = expr_cache_key(assign, fmt, schedule, dims)
    hit = _LOWERED_CACHE.get(key)
    if hit is not None:
        return hit
    split_of = dict(schedule.split)
    # the (vo, vi) renaming must not capture existing names: a genuine
    # variable "io" next to split={"i": n} would be indistinguishable from
    # the split-outer level downstream
    clash = sorted(w for v in split_of for w in (f"{v}o", f"{v}i")
                   if w in assign.all_vars or w in schedule.loop_order)
    if clash:
        raise ValueError(
            f"split renames collide with existing variable(s) {clash}; "
            f"rename them before splitting")
    fmt2 = split_format(assign, fmt, schedule)
    assign2 = split_assignment(assign, split_of)
    sch2 = split_schedule(schedule)
    dims2 = split_dims(dims, split_of)
    cc = Custard(assign2, fmt2, sch2, dims2)
    combined: Optional[g.Graph] = None
    combined_error: Optional[Exception] = None
    try:
        combined = cc.compile()
    except NotImplementedError as e:   # e.g. leading negative term: the
        combined_error = e             # per-term factoring still lowers
    terms: List[TermLowering] = []
    term_error: Optional[Exception] = None
    for term in assign2.terms:
        if len(assign2.terms) == 1:
            # single-term: the combined graph IS the term graph (the sign
            # is applied outside the graph on every execution path)
            G = combined
            if G is None:
                terms.append(TermLowering(term.sign, None))
                term_error = combined_error
                continue
        else:
            sub = Assignment(lhs=assign2.lhs, terms=(Term(1, term.factors),))
            try:
                G = Custard(sub, fmt2, sch2, dims2).compile()
            except (NotImplementedError, ValueError) as e:  # needs x-term crd
                terms.append(TermLowering(term.sign, None))
                term_error = term_error or NotImplementedError(
                    f"term {term} cannot lower stand-alone: {e}")
                continue
        lane_n = cc.par_n if any(
            "chunk_n" in n.params for n in G.nodes.values()) else 1
        terms.append(TermLowering(term.sign, G, lane_n))
    if cc.par_n > 1 and term_error is not None:
        raise term_error
    if combined is None and term_error is not None:
        raise term_error               # no lowering strategy works at all
    low = Lowered(orig_assign=assign, orig_dims=dict(dims), orig_fmt=fmt,
                  assign=assign2, fmt=fmt2, schedule=sch2, dims=dims2,
                  split_of=split_of, par_var=cc.par_var, par_n=cc.par_n,
                  graph=combined, graph_error=combined_error, terms=terms,
                  term_error=term_error)
    _LOWERED_CACHE[key] = low
    return low


def lower_single_terms(assign: Assignment, fmt: Format, schedule: Schedule,
                       dims: Dict[str, int]) -> List[Tuple[int, g.Graph]]:
    """Back-compat wrapper: (sign, graph) per term, memoized via ``lower``."""
    low = lower(assign, fmt, schedule, dims)
    return [(t.sign, t.graph) for t in low.require_terms()]


def lower_program(program, fmt: Format, schedules, dims: Dict[str, int], *,
                  sparsity=None, fuse: bool = True):
    """Lower a multi-assignment program: per-stage ``Lowered`` objects
    plus the producer→consumer fusion plan (``program.lower_program``).

    ``schedules`` is ``"auto"``, a dict keyed by stage lhs tensor, or a
    sequence aligned with the stages; fused stages share scanners — the
    consumer's scanners of a fused intermediate are spliced wires carrying
    the producer's writer streams (DESIGN.md §6).

    >>> from repro_torch.core.schedule import Format
    >>> lp = lower_program(
    ...     "T(i,j) = B(i,k) * C(k,j); A(i,j) = T(i,k) * E(k,j)",
    ...     Format({"B": "cc", "C": "cc", "E": "cc", "T": "cc"}),
    ...     {"T": Schedule(loop_order=("i", "k", "j")),
    ...      "A": Schedule(loop_order=("i", "k", "j"))},
    ...     {"i": 4, "j": 4, "k": 4})
    >>> [d.fused for d in lp.decisions]
    [True]
    """
    from .program import lower_program as _lower_program
    return _lower_program(program, fmt, schedules, dims,
                          sparsity=sparsity, fuse=fuse)


def clear_lowering_cache() -> None:
    """Drop every in-process lowering memo.

    Also clears the autoscheduler's in-process resolution memo: a caller
    clearing lowerings expects ``schedule="auto"`` to re-resolve, and a
    stale memo entry would otherwise keep serving the old schedule even
    after the on-disk schedule cache changed underneath it.
    """
    _LOWERED_CACHE.clear()
    from .autoschedule import clear_resolution_memo
    clear_resolution_memo()
