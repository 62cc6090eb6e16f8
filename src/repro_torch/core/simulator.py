"""Cycle-approximate functional simulator for SAM graphs (paper §6).

Functional semantics: each block is evaluated as a pure function from its
input streams (nested-list view, ``streams.py``) to its output streams, in
topological order. This reproduces the paper's block definitions 3.1-3.9 and
4.1-4.2 exactly.

Timing model: the paper models SAM graphs as *fully pipelined* — every
primitive produces one token per cycle, with infinite queues and 1-cycle
memories. In steady state the makespan of such a pipeline is governed by
the block that must process the most tokens, plus the pipeline fill
latency. We therefore report::

    cycles  =  max_b ( work_b / lanes_b )  +  graph_depth

where ``work_b`` counts the tokens block *b* processes/emits (per-block
definitions below) and ``lanes_b`` models §4.4 vectorization. This is the
same steady-state number a per-cycle event simulation with infinite queues
converges to, at a tiny fraction of the cost; per-block work is also
reported so bottlenecks can be inspected (used by Figs. 11-13).

Work accounting (tokens processed, incl. control tokens):
  level_scan  : input refs + output tokens (one crd/ref pair per cycle)
  intersect   : two-finger merge pointer advances (``skip=True`` => gallop
                probes, modeling §4.2 coordinate skipping as 1-cycle
                pipelined probes, like ExTensor's skip hardware)
  union       : total input tokens
  repeat      : output tokens
  array       : input refs
  alu         : max input tokens
  reduce      : input tokens + output tokens
  crd_drop    : inner + outer input tokens
  locate      : one probe per input coordinate
  bitvector   : one token per packed word (the §4.3 b-bits-per-cycle win)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from . import graph as g
from . import streams as st
from .fibertree import BV_WIDTH, COMPRESSED, DENSE, BITVECTOR, FiberTree, Level


@dataclasses.dataclass(frozen=True)
class HardwareConfig:
    """Hardware attributes of the modeled SAM machine (the TeAAL move:
    the cycle law becomes a function of the hardware point, turning the
    simulator into a design-space explorer).

    The defaults model the paper's idealized machine — one PE per block
    pipeline, infinite-depth inter-block queues, infinite memory
    bandwidth — under which every term below is inert and the law reduces
    EXACTLY to the historical ``max(block work) + graph depth`` form
    (pinned by tests/test_format_conformance.py's cycle-law regressions).

    * ``pes``           — processing elements executing block work. With
      fewer PEs than busy blocks the machine time-multiplexes them, so
      the steady term is floored by ``ceil(total work / pes)`` (Brent's
      bound ``max(T_inf, T_1/p)``). 0 = unbounded.
    * ``buffer_depth``  — tokens per inter-block queue. Finite queues
      back-pressure the pipeline once per ``buffer_depth`` tokens of the
      bottleneck block (one refill bubble each), adding
      ``steady // buffer_depth`` cycles. 0 = unbounded.
    * ``mem_bandwidth`` — memory tokens per cycle sustained by the
      tensor-storage side. Memory traffic is the work of the blocks that
      touch stored tensors (level scanners + value arrays); the steady
      term is floored by ``ceil(traffic / mem_bandwidth)``. 0 = unbounded.
    """

    pes: int = 0
    buffer_depth: int = 0
    mem_bandwidth: float = 0.0
    name: str = "paper"


HW_PRESETS = {
    "paper": HardwareConfig(),
    "pe8": HardwareConfig(pes=8, name="pe8"),
    "pe16": HardwareConfig(pes=16, name="pe16"),
    "bw4": HardwareConfig(mem_bandwidth=4.0, name="bw4"),
    "bw16": HardwareConfig(mem_bandwidth=16.0, name="bw16"),
    "edge": HardwareConfig(pes=4, mem_bandwidth=2.0, buffer_depth=64,
                           name="edge"),
}


def _hw_steady(hw: HardwareConfig, steady: int, total: int, mem: int) -> int:
    """Apply the hardware floors to a pipeline's steady-state term."""
    s = int(steady)
    if hw.pes > 0:
        s = max(s, -(-int(total) // hw.pes))
    if hw.mem_bandwidth > 0:
        s = max(s, int(np.ceil(mem / hw.mem_bandwidth)))
    return s


def _hw_stall(hw: HardwareConfig, steady: int) -> int:
    """Back-pressure bubbles of finite inter-block queues."""
    return int(steady) // hw.buffer_depth if hw.buffer_depth > 0 else 0


def _sim_mem_tokens(res: "SimResult") -> int:
    """Memory traffic of one simulated graph: tokens moved by the blocks
    that read stored tensors (level scanners + value arrays)."""
    return sum(w for nid, w in res.work.items()
               if res.graph.nodes[nid].kind in (g.ARRAY, g.LEVEL_SCAN))


@dataclasses.dataclass
class SimResult:
    outputs: Dict[str, FiberTree]
    work: Dict[int, int]                  # node id -> tokens of work
    cycles: int
    edge_streams: Dict[Tuple[int, str], Any]   # (node, port) -> nested stream
    graph: g.Graph

    def bottleneck(self) -> g.Node:
        nid = max(self.work, key=lambda i: self.work[i])
        return self.graph.nodes[nid]

    def edge_tokens(self, node_name: str, port: str) -> list:
        for n in self.graph.nodes.values():
            if n.name == node_name:
                return st.nested_to_tokens(self.edge_streams[(n.id, port)])
        raise KeyError(node_name)


# ---------------------------------------------------------------------------
# fiber-level primitives
# ---------------------------------------------------------------------------

def _merge_intersect(fibers: List[list], refs: List[list],
                     skip: bool = False) -> Tuple[list, List[list], int]:
    """m-ary sorted intersection of coordinate fibers. Returns work."""
    m = len(fibers)
    ptr = [0] * m
    out_crd: list = []
    out_ref: List[list] = [[] for _ in range(m)]
    work = 0
    while all(ptr[i] < len(fibers[i]) for i in range(m)):
        cur = [fibers[i][ptr[i]] for i in range(m)]
        hi = max(cur)
        if all(c == hi for c in cur):
            out_crd.append(hi)
            for i in range(m):
                out_ref[i].append(refs[i][ptr[i]])
                ptr[i] += 1
            work += 1
        elif skip:
            # galloping: every lagging finger jumps via one pipelined probe
            for i in range(m):
                if cur[i] < hi:
                    lo = ptr[i]
                    f = fibers[i]
                    j = lo
                    while j < len(f) and f[j] < hi:
                        j += 1  # functional jump; costed as one probe
                    ptr[i] = j
                    work += 1
        else:
            # two-finger: advance each lagging pointer one step per cycle
            for i in range(m):
                if cur[i] < hi:
                    ptr[i] += 1
                    work += 1
    return out_crd, out_ref, max(work, 1)


def _merge_union(fibers: List[list], refs: List[list]) -> Tuple[list, List[list], int]:
    m = len(fibers)
    all_crds = sorted({c for f in fibers for c in f})
    out_ref: List[list] = [[] for _ in range(m)]
    lookup = [dict(zip(f, r)) for f, r in zip(fibers, refs)]
    for c in all_crds:
        for i in range(m):
            out_ref[i].append(lookup[i].get(c))
    work = sum(len(f) + 1 for f in fibers)
    return all_crds, out_ref, work


def _effectual_val(x) -> bool:
    """Does a value subtree contain any nonzero?"""
    if isinstance(x, list):
        return any(_effectual_val(c) for c in x)
    return x is not None and x != 0.0


def _effectual_crd(x) -> bool:
    """Does a coordinate subtree contain any coordinate (0 is a coord!)?"""
    if isinstance(x, list):
        return any(_effectual_crd(c) for c in x)
    return x is not None


# ---------------------------------------------------------------------------
# the evaluator
# ---------------------------------------------------------------------------

class Simulator:
    """Evaluates one SAM graph; ``lane`` selects a §4.4 parallel lane.

    Scanners carrying a ``chunk_n`` param (emitted by Custard for the
    parallelized variable) restrict their coordinate space to contiguous
    chunk ``lane`` of ``chunk_n`` when a lane is given; with ``lane=None``
    chunk marks are inert and the graph computes the full iteration space.

    ``inject`` pre-seeds output ports of selected nodes with streams
    produced elsewhere — the wire-splice mechanism of producer→consumer
    program fusion (``program.simulate_program``): a consumer's level
    scanners of a fused intermediate are never evaluated; their output
    wires carry the producer's writer streams directly. An injected
    node's work is 1 (it is a wire, not a block).
    """

    def __init__(self, graph_: g.Graph, tensors: Dict[str, FiberTree],
                 lane: Optional[int] = None,
                 inject: Optional[Dict[Tuple[int, str], Any]] = None,
                 hw: Optional[HardwareConfig] = None):
        self.g = graph_
        # copied: tree-conversion nodes rebind their tensor in-run
        self.tensors = dict(tensors)
        self.lane = lane
        self.inject = dict(inject or {})
        self.hw = hw or HardwareConfig()
        self.env: Dict[Tuple[int, str], Any] = {}
        self.work: Dict[int, int] = {}

    # -- helpers ---------------------------------------------------------------
    def _map_leaves(self, stream, fn):
        if isinstance(stream, list):
            return [self._map_leaves(c, fn) for c in stream]
        return fn(stream)

    def _inputs(self, node: g.Node) -> Dict[str, Any]:
        vals = {}
        for e in self.g.in_edges(node):
            vals[e.dst_port] = self.env[(e.src, e.src_port)]
        return vals

    def _level(self, node: g.Node) -> Level:
        t = self.tensors[node.params["tensor"]]
        return t.levels[node.params["mode"]]

    # -- block semantics ---------------------------------------------------------
    def _eval_root(self, node, ins):
        return {"ref": 0}, 1

    def _eval_level_scan(self, node, ins):
        level = self._level(node)
        use_bv = node.params.get("bv", False)
        work = [0]
        # §4.4 split-level scanning: restrict to this lane's coordinate chunk
        chunk_n = node.params.get("chunk_n")
        if chunk_n and self.lane is not None:
            csz = -(-level.dim // chunk_n)
            lo, hi = self.lane * csz, min((self.lane + 1) * csz, level.dim)
        else:
            lo, hi = 0, level.dim

        def scan(ref):
            if ref is None:
                return []
            if use_bv:
                # bitvector scanner: one token per packed word (§4.3);
                # chunked lanes only process their chunk's words
                crds, refs = level.fiber(int(ref))
                keep = [(c, r) for c, r in zip(crds, refs) if lo <= c < hi]
                nwords = -(-level.dim // BV_WIDTH)
                chunk_words = -(-(hi - lo) // BV_WIDTH) if hi > lo else 0
                work[0] += (chunk_words if (lo, hi) != (0, level.dim)
                            else nwords) + 1
                words = [0] * nwords
                for c, _ in keep:
                    words[int(c) // BV_WIDTH] |= 1 << (int(c) % BV_WIDTH)
                base = int(keep[0][1]) if keep else 0
                return ([(w, None) for w in words],
                        ([c for c, _ in keep], [r for _, r in keep], base))
            crds, refs = level.fiber(int(ref))
            keep = [(int(c), int(r)) for c, r in zip(crds, refs)
                    if lo <= c < hi]
            work[0] += len(keep) + 2  # + stop + input ref
            return [c for c, _ in keep], [r for _, r in keep]

        if use_bv:
            # emit (bv words, per-fiber ref info) pairs
            both = self._map_leaves(ins["ref"], scan)

            def first(x):
                if isinstance(x, tuple):
                    return x[0]
                return [first(c) for c in x]

            def second(x):
                if isinstance(x, tuple):
                    return x[1]
                return [second(c) for c in x]

            return {"bv": first(both), "ref": second(both)}, work[0]

        both = self._map_leaves(ins["ref"], scan)

        def part(x, idx):
            if isinstance(x, tuple):
                return x[idx]
            return [part(c, idx) for c in x]

        return {"crd": part(both, 0), "ref": part(both, 1)}, work[0]

    def _eval_intersect(self, node, ins):
        m = node.params.get("arity", 2)
        skip = node.params.get("skip", False)
        if node.params.get("bv", False):
            return self._eval_bv_intersect(node, ins, m)
        crds = [ins[f"crd{i}"] for i in range(m)]
        refs = [ins[f"ref{i}"] for i in range(m)]
        depth = st.nested_depth(crds[0]) - 1
        total = [0]

        def fib(*args):
            f, r = list(args[:m]), list(args[m:])
            oc, orf, w = _merge_intersect(f, r, skip=skip)
            total[0] += w
            return (oc, orf)

        merged = st.map_fibers(fib, *(crds + refs), depth=depth)

        def pick(x, which, i=None):
            if isinstance(x, tuple):
                return x[0] if which == "crd" else x[1][i]
            return [pick(c, which, i) for c in x]

        out = {"crd": pick(merged, "crd")}
        for i in range(m):
            out[f"ref{i}"] = pick(merged, "ref", i)
        return out, total[0]

    def _eval_bv_intersect(self, node, ins, m):
        """AND of bitvector streams; refs recovered via popcount bases."""
        bvs = [ins[f"bv{i}"] for i in range(m)]
        infos = [ins[f"ref{i}"] for i in range(m)]
        depth = st.nested_depth(bvs[0]) - 1
        total = [0]

        def fib(*args):
            words_lists = args[:m]
            inf = args[m:]
            out_words = []
            nw = max(len(w) for w in words_lists)
            for wi in range(nw):
                w = ~0
                for i in range(m):
                    wl = words_lists[i]
                    w &= wl[wi][0] if wi < len(wl) else 0
                out_words.append(w)
            total[0] += nw
            # per-input refs for surviving bits
            out_crd, out_ref = [], [[] for _ in range(m)]
            for wi, w in enumerate(out_words):
                b = 0
                while w >> b:
                    if (w >> b) & 1:
                        c = wi * BV_WIDTH + b
                        out_crd.append(c)
                        for i in range(m):
                            crds_i, refs_i, base_i = inf[i]
                            k = int(np.searchsorted(crds_i, c))
                            out_ref[i].append(int(refs_i[k]))
                    b += 1
            return (out_crd, out_ref)

        merged = st.map_fibers(fib, *(bvs + infos), depth=depth)

        def pick(x, which, i=None):
            if isinstance(x, tuple):
                return x[0] if which == "crd" else x[1][i]
            return [pick(c, which, i) for c in x]

        out = {"crd": pick(merged, "crd")}
        for i in range(m):
            out[f"ref{i}"] = pick(merged, "ref", i)
        return out, total[0]

    def _eval_union(self, node, ins):
        """m-ary union. Ref ports are grouped per input slot: ``ref{i}_{j}``
        (a slot may carry several tensors' refs, e.g. a whole product term);
        presence/holes are decided by the slot's crd stream."""
        m = node.params.get("arity", 2)
        crds = [ins[f"crd{i}"] for i in range(m)]
        ref_ports = sorted(k for k in ins if k.startswith("ref"))
        slot_of = {p: int(p[3:].split("_")[0]) for p in ref_ports}
        refs = [ins[p] for p in ref_ports]
        depth = st.nested_depth(crds[0]) - 1
        total = [0]
        R = len(ref_ports)

        def fib(*args):
            cf = list(args[:m])
            rf = list(args[m:])
            all_crds = sorted({c for f in cf for c in f})
            pos = [dict((c, k) for k, c in enumerate(f)) for f in cf]
            out_ref = [[] for _ in range(R)]
            for c in all_crds:
                for r in range(R):
                    slot = slot_of[ref_ports[r]]
                    k = pos[slot].get(c)
                    out_ref[r].append(None if k is None else rf[r][k])
            total[0] += sum(len(f) + 1 for f in cf)
            return (all_crds, out_ref)

        merged = st.map_fibers(fib, *(crds + refs), depth=depth)

        def pick(x, i=None):
            if isinstance(x, tuple):
                return x[0] if i is None else x[1][i]
            return [pick(c, i) for c in x]

        out = {"crd": pick(merged)}
        for r, p in enumerate(ref_ports):
            out[p] = pick(merged, r)
        return out, total[0]

    def _eval_repeat(self, node, ins):
        refs, crds = ins["ref"], ins["crd"]
        rdepth = st.nested_depth(refs)
        total = [0]

        # refs at depth d (leaves align with depth-(d+1) fibers of crds)
        def rec(r, c):
            if not isinstance(r, list):
                total[0] += len(c) + 1
                return [r] * len(c)
            return [rec(ri, ci) for ri, ci in zip(r, c)]

        if rdepth == 0:
            # scalar ref stream repeated over every fiber of the crd stream
            cdepth = st.nested_depth(crds)

            def rep_scalar(c, d):
                if d == 1:
                    total[0] += len(c) + 1
                    return [refs] * len(c)
                return [rep_scalar(ci, d - 1) for ci in c]

            return {"ref": rep_scalar(crds, cdepth)}, total[0]
        return {"ref": rec(refs, crds)}, total[0]

    def _eval_array(self, node, ins):
        t = self.tensors[node.params["tensor"]]
        vals = t.vals
        total = [0]

        def load(ref):
            total[0] += 1
            if ref is None:
                return None
            return float(vals[int(ref)])

        return {"val": self._map_leaves(ins["ref"], load)}, total[0]

    def _eval_alu(self, node, ins):
        op = node.params["op"]
        a, b = ins["a"], ins["b"]
        total = [0]

        def f(x, y):
            total[0] += 1
            x = 0.0 if x is None else x
            y = 0.0 if y is None else y
            if op == "mul":
                return x * y
            if op == "add":
                return x + y
            if op == "sub":
                return x - y
            raise ValueError(op)

        def rec(x, y):
            if isinstance(x, list) and isinstance(y, list):
                return [rec(xi, yi) for xi, yi in zip(x, y)]
            if isinstance(x, list) or isinstance(y, list):
                raise ValueError("ALU operand structure mismatch")
            return f(x, y)

        return {"val": rec(a, b)}, total[0]

    def _eval_reduce(self, node, ins):
        n = int(node.params.get("n", 0))
        empty_mode = node.params.get("empty", "zero" if n == 0 else "remove")
        vals = ins["val"]
        # the lowering declares the input depth; all-empty streams (routine
        # under lane chunking) under-report their structural depth
        dv = node.params.get("depth") or st.nested_depth(vals)
        total = [0]

        if n == 0:
            def red(fiber):
                total[0] += len(fiber) + 2
                if not fiber and empty_mode == "zero":
                    return 0.0
                return float(sum(v for v in fiber if v is not None))

            if dv == 1:
                return {"val": red(vals)}, total[0]
            out = st.map_fibers(red, vals, depth=dv - 1)
            return {"val": out}, total[0]

        # n >= 1: accumulate an n-dim sub-tensor; group level = dv - n - 1
        crds = [ins[f"crd{k}"] for k in range(n)]

        def points(cs, v, prefix, acc):
            # cs: list of n nested crd structures (cs[0] is a fiber here)
            if len(cs) == 1:
                for c, val in zip(cs[0], v):
                    total[0] += 1
                    if val is not None:
                        acc[prefix + (c,)] = acc.get(prefix + (c,), 0.0) + val
                return
            for idx, c in enumerate(cs[0]):
                points([cc[idx] for cc in cs[1:]], v[idx], prefix + (c,), acc)

        def emit(acc, keys, n_left):
            # build nested sorted structure from accumulated points
            if n_left == 1:
                ks = sorted(keys)
                total[0] += len(ks) + 1
                return [k[-1] for k in ks], [acc[k] for k in ks]
            heads = sorted({k[0] for k in keys})
            crd_out, val_out = [], []
            subs = [[] for _ in range(n_left - 1)]
            for h in heads:
                sub = [k[1:] for k in keys if k[0] == h]
                sacc = {k[1:]: acc[k] for k in keys if k[0] == h}
                res = emit(sacc, list(sacc.keys()), n_left - 1)
                crd_out.append(h)
                for d in range(n_left - 1):
                    subs[d].append(res[d])
                val_out.append(res[-1])
            total[0] += len(heads) + 1
            return (crd_out, *subs, val_out) if n_left > 1 else (crd_out, val_out)

        def group(*args):
            # args: n crd structures + vals for one accumulation group
            cs, v = list(args[:n]), args[n]
            acc: dict = {}
            for idx in range(len(cs[0])):
                points([cs[0][idx]] if n == 1 else
                       [cs[0][idx]] + [c[idx] for c in cs[1:]],
                       v[idx], (), acc)
            if not acc:
                if empty_mode == "zero":
                    flat: Any = ([], [])
                    # empty structure at each level
                    res = tuple([[] for _ in range(n)] + [[]])
                    return res
                return tuple([[] for _ in range(n)] + [[]])
            keys = list(acc.keys())
            res = emit(acc, keys, n)
            if n == 1:
                return (res[0], res[1])
            return res

        gdepth = dv - n - 1
        merged = st.map_fibers(group, *(crds + [vals]), depth=gdepth)

        def pick(x, i):
            if isinstance(x, tuple):
                return x[i]
            return [pick(c, i) for c in x]

        out = {f"crd{k}": pick(merged, k) for k in range(n)}
        out["val"] = pick(merged, n)
        return out, total[0]

    def _eval_crd_drop(self, node, ins):
        """Drop outer coordinates whose aligned inner subtree is ineffectual
        (empty fiber / all zeros, Def 3.9). Passenger streams (deeper crd
        levels, values) are cleaned at the same positions to keep the
        result hierarchy aligned."""
        outer, inner = ins["outer"], ins["inner"]
        pass_ports = sorted(k for k in ins if k.startswith("pass"))
        passengers = [ins[p] for p in pass_ports]
        od = node.params.get("outer_depth") or st.nested_depth(outer)
        total = [0]
        # effectuality depends on the inner wire type (Def 3.9: empty
        # fibers for crd streams, zeros for value streams)
        inner_kind = st.CRD
        for e in self.g.in_edges(node):
            if e.dst_port == "inner":
                inner_kind = e.stream
        eff = _effectual_val if inner_kind == st.VAL else _effectual_crd

        def drop(of, inn, *pas):
            total[0] += len(of) + st.count_leaves(inn) + 1
            keep = [i for i in range(len(of)) if eff(inn[i])]
            return tuple([[x[i] for i in keep]
                          for x in (of, inn) + pas])

        merged = st.map_fibers(drop, outer, inner, *passengers, depth=od - 1)

        def pick(x, i):
            if isinstance(x, tuple):
                return x[i]
            return [pick(c, i) for c in x]

        out = {"outer": pick(merged, 0), "inner": pick(merged, 1)}
        for k, p in enumerate(pass_ports):
            out[p] = pick(merged, k + 2)
        return out, total[0]

    def _eval_locate(self, node, ins):
        level = self._level(node)
        total = [0]

        def rec(crd, ref):
            # crd: fiber; ref: parent reference of the located tensor fiber
            if isinstance(crd, list) and crd and isinstance(crd[0], list):
                return [rec(c, r) for c, r in zip(crd, ref)]
            out = []
            base = ref if not isinstance(ref, list) else 0
            for c in crd:
                total[0] += 1
                if base is None:
                    out.append(None)
                    continue
                if level.format == DENSE:
                    out.append(int(base) * level.dim + int(c))
                else:
                    # canonical sorted view: a hashed level probes its
                    # backing table, not its slot-iteration order
                    crds, refs = level.sorted_fiber(int(base))
                    k = int(np.searchsorted(crds, c))
                    if k < len(crds) and crds[k] == c:
                        out.append(int(refs[k]))
                    else:
                        out.append(None)
            return out

        crd, pref = ins["crd"], ins["ref"]
        cdepth = st.nested_depth(crd)

        def walk(c, r, d):
            if d == 1:
                return rec(c, r)
            return [walk(ci, r[i] if isinstance(r, list) else r, d - 1)
                    for i, ci in enumerate(c)]

        found = walk(crd, pref, cdepth)
        return {"crd": crd, "ref": found, "ref_in": pref}, total[0]

    def _eval_bv_convert(self, node, ins):
        total = [0]

        def conv(fiber):
            if fiber and isinstance(fiber[0], tuple):
                return fiber  # already bitvector
            nwords = -(-int(node.params.get("dim", BV_WIDTH)) // BV_WIDTH)
            words = [0] * max(nwords, (max(fiber) // BV_WIDTH + 1) if fiber else 1)
            for c in fiber:
                words[c // BV_WIDTH] |= 1 << (c % BV_WIDTH)
            total[0] += len(words)
            return [(w, None) for w in words]

        depth = st.nested_depth(ins["crd"]) - 1
        return {"bv": st.map_fibers(conv, ins["crd"], depth=depth)}, total[0]

    def _eval_convert(self, node, ins):
        """Format-conversion node (graph.py CONVERT).

        ``op="tree"``: rebuild a non-unique (COO/singleton) tensor into
        canonical unique levels before its scanners run — the node sits
        between the root and the tensor's first scanner, so by topological
        order the rebind below happens before any scan. Work models one
        read + one write of every stored entry. The converted top-level
        coordinate fiber is exposed on "crd" for wire observability.

        ``op="sort"``: re-order each (crd, ref) fiber of an unordered
        (hashed) level's scanner output into ascending-coordinate order.
        Work is input + output tokens of both streams.
        """
        if node.params.get("op") == "tree":
            t = node.params["tensor"]
            conv = self.tensors[t].convert(node.params["to_format"],
                                           merge_duplicates=True)
            self.tensors[t] = conv
            entries = conv.nnz + sum(lv.nnz for lv in conv.levels
                                     if lv.format != DENSE)
            if conv.levels:
                top, _ = conv.levels[0].fiber(0)
                top_crd = [int(c) for c in top]
            else:
                top_crd = []
            return ({"ref": ins["ref"], "crd": top_crd}, 2 * entries + 1)

        crds, refs = ins["crd"], ins["ref"]
        depth = st.nested_depth(crds) - 1
        total = [0]

        def srt(cf, rf):
            total[0] += 2 * (len(cf) + 1)
            order = sorted(range(len(cf)), key=lambda k: cf[k])
            return ([cf[k] for k in order], [rf[k] for k in order])

        merged = st.map_fibers(srt, crds, refs, depth=depth)

        def pick(x, i):
            if isinstance(x, tuple):
                return x[i]
            return [pick(c, i) for c in x]

        return {"crd": pick(merged, 0), "ref": pick(merged, 1)}, total[0]

    def _eval_level_write(self, node, ins):
        key = "val" if "val" in ins else "crd"
        stream = ins[key]
        return {key: stream}, st.count_tokens(stream)

    def _eval_parallelize(self, node, ins):
        return dict(ins), st.count_tokens(next(iter(ins.values())))

    def _eval_serialize(self, node, ins):
        return dict(ins), st.count_tokens(next(iter(ins.values())))

    # -- driver -----------------------------------------------------------------
    def run(self) -> SimResult:
        handlers: Dict[str, Callable] = {
            g.ROOT: self._eval_root, g.LEVEL_SCAN: self._eval_level_scan,
            g.INTERSECT: self._eval_intersect, g.UNION: self._eval_union,
            g.REPEAT: self._eval_repeat, g.ARRAY: self._eval_array,
            g.ALU: self._eval_alu, g.REDUCE: self._eval_reduce,
            g.CRD_DROP: self._eval_crd_drop, g.LOCATE: self._eval_locate,
            g.BV_CONVERT: self._eval_bv_convert,
            g.CONVERT: self._eval_convert,
            g.LEVEL_WRITE: self._eval_level_write,
            g.PARALLELIZE: self._eval_parallelize,
            g.SERIALIZE: self._eval_serialize,
        }
        injected = {nid for nid, _ in self.inject}
        for node in self.g.topo_order():
            if node.id in injected:
                # spliced wire (program fusion): outputs come from the
                # producer stage's streams, the block never runs
                for (nid, port), val in self.inject.items():
                    if nid == node.id:
                        self.env[(nid, port)] = val
                self.work[node.id] = 1
                continue
            ins = self._inputs(node)
            outs, work = handlers[node.kind](node, ins)
            self.work[node.id] = work
            for port, val in outs.items():
                self.env[(node.id, port)] = val

        # §4.2 coordinate skipping: the intersecter signals the trailing
        # level scanners, which skip ahead via a locator instead of
        # streaming every coordinate — their work collapses to the gallop
        # probe count (folded feedback edge; see module docstring).
        for node in self.g.of_kind(g.INTERSECT):
            if not node.params.get("skip"):
                continue
            for e in self.g.in_edges(node):
                src = self.g.nodes[e.src]
                if src.kind == g.LEVEL_SCAN:
                    self.work[src.id] = min(self.work[src.id],
                                            self.work[node.id] + 2)

        outputs = self._assemble_outputs()
        steady = max(self.work.values(), default=1)
        mem = sum(w for nid, w in self.work.items()
                  if self.g.nodes[nid].kind in (g.ARRAY, g.LEVEL_SCAN))
        steady = _hw_steady(self.hw, steady, sum(self.work.values()), mem)
        cycles = steady + self.g.depth() + _hw_stall(self.hw, steady)
        return SimResult(outputs=outputs, work=self.work, cycles=cycles,
                         edge_streams=self.env, graph=self.g)

    def _assemble_outputs(self) -> Dict[str, FiberTree]:
        """Collect level_write nodes per output tensor into FiberTrees."""
        writers: Dict[str, Dict[Any, Any]] = {}
        for n in self.g.of_kind(g.LEVEL_WRITE):
            t = n.params["tensor"]
            writers.setdefault(t, {})[n.params.get("var", "vals")] = n
        out: Dict[str, FiberTree] = {}
        for tname, ws in writers.items():
            vorder = [v for v in ws if v != "vals"]
            vorder.sort(key=lambda v: ws[v].params.get("pos", 0))
            val_node = ws["vals"]
            vals_stream = self.env[(val_node.id, "val")]
            shape = val_node.params.get("shape", ())
            if not vorder:  # scalar result
                v = vals_stream if not isinstance(vals_stream, list) else (
                    st.flatten(vals_stream)[0] if st.flatten(vals_stream) else 0.0)
                out[tname] = FiberTree.from_dense(np.asarray(float(v or 0.0)), "")
                continue
            crd_streams = [self.env[(ws[v].id, "crd")] for v in vorder]
            coords, values = [], []

            def walk(cs, v, prefix):
                if len(cs) == 1:
                    for c, val in zip(cs[0], v):
                        if val is None:
                            continue
                        coords.append(prefix + (c,))
                        values.append(val)
                    return
                for i, c in enumerate(cs[0]):
                    walk([cc[i] for cc in cs[1:]], v[i], prefix + (c,))

            walk(crd_streams, vals_stream, ())
            fmt = val_node.params.get("format", "c" * len(vorder))
            ft = FiberTree.from_coords(
                shape, np.asarray(coords, dtype=np.int64).reshape(-1, len(vorder)),
                np.asarray(values), fmt)
            mo = val_node.params.get("mode_order")
            if mo is not None:
                ft.mode_order = tuple(mo)
            out[tname] = ft
        return out


def simulate(graph_: g.Graph, tensors: Dict[str, FiberTree],
             lane: Optional[int] = None) -> SimResult:
    return Simulator(graph_, tensors, lane=lane).run()


# ---------------------------------------------------------------------------
# §4.4 parallel execution: per-lane simulation + merge stage
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LaneSim:
    sign: int
    term: int
    lane: Optional[int]          # None => unparallelized term
    result: SimResult


@dataclasses.dataclass
class ExprSimResult:
    """Simulation of a fully scheduled expression (split + parallel lanes
    + out-of-core tiles).

    ``dense`` is the merged result in the ORIGINAL coordinate space.
    ``cycles`` models the §4.4 parallel machine: all lanes run
    concurrently, so the steady-state term is the max over lanes' per-block
    work joined with the lane-merge stage's work, plus pipeline fill.
    Tiled schedules (``Schedule.tile``) stream their tiles back-to-back
    through one pipeline: per-tile steady-state terms ADD, the pipeline
    fills once, and the tile-merge stage runs concurrently downstream —
    ``cycles = max(sum of per-tile steady states, merge work) + fill`` —
    so modeled numbers stay comparable with the measured tiled engine
    (the reference's ``jax_backend.TiledExpr``). ``tiles`` is the
    tile-grid volume (1 = untiled).

    ``workers > 1`` models the distributed tile fan-out
    (``dist_exec.DistTiledExpr``): tiles round-robin over the workers
    (the driver's assignment), each worker streams ITS tiles
    back-to-back, and the workers run concurrently — so per-tile steady
    states add PER WORKER and the machine-wide steady term is the MAX
    over workers, not the sum. The grid-order merge stays one downstream
    fold and the per-worker pipelines fill concurrently:
    ``cycles = max(max over workers of its tiles' steady sum,
    merge work) + fill``.
    """

    dense: Any
    cycles: int
    lanes: List[LaneSim]
    merge_work: int
    tiles: int = 1
    workers: int = 1

    @property
    def lane_cycles(self) -> List[int]:
        return [ls.result.cycles for ls in self.lanes]


def downsample_operands(assign, arrays: Dict[str, "np.ndarray"],
                        dims: Dict[str, int], max_dim: int = 48
                        ) -> Tuple[Dict[str, "np.ndarray"], Dict[str, int]]:
    """Autoscheduler sampling hook: shrink every index extent to at most
    ``max_dim`` and slice the operands to match.

    Cost-model runs on the sample preserve relative schedule ranking
    (density is approximately preserved by corner slicing) at a tiny
    fraction of the full simulation cost. Returns ``(arrays, dims)`` in
    the downsampled coordinate space; deterministic by construction.
    Tensors absent from ``arrays`` are skipped (the autoscheduler fills
    them with synthetic operands from the sparsity hint).

    >>> import numpy as np
    >>> from repro_torch.core.einsum import parse
    >>> arrs, sdims = downsample_operands(
    ...     parse("x(i) = B(i,j) * c(j)"),
    ...     {"B": np.ones((100, 100)), "c": np.ones(100)},
    ...     {"i": 100, "j": 100}, max_dim=8)
    >>> arrs["B"].shape, sdims
    ((8, 8), {'i': 8, 'j': 8})
    """
    sdims = {v: min(int(d), int(max_dim)) for v, d in dims.items()}
    out: Dict[str, Any] = {}
    for term in assign.terms:
        for acc in term.factors:
            if acc.tensor in out or acc.tensor not in arrays:
                continue
            arr = np.asarray(arrays[acc.tensor])
            if acc.vars:
                arr = arr[tuple(slice(0, sdims[v]) for v in acc.vars)]
            out[acc.tensor] = arr
    return out, sdims


def sampled_cycles(expr, fmt, schedule, arrays, dims, *,
                   max_dim: int = 48) -> int:
    """One-shot cost probe for a single schedule: downsample + simulate,
    return the cycle count. (``autoschedule.search`` applies the same
    downsample-then-simulate combination, but downsamples once across its
    whole candidate set.)

    >>> import numpy as np
    >>> from repro_torch.core.schedule import Format, Schedule
    >>> B = np.eye(64)
    >>> sampled_cycles("x(i) = B(i,j) * c(j)", Format({"B": "cc"}),
    ...                Schedule(loop_order=("i", "j")),
    ...                {"B": B, "c": np.ones(64)}, {"i": 64, "j": 64},
    ...                max_dim=8) > 0
    True
    """
    from .einsum import parse

    assign = parse(expr) if isinstance(expr, str) else expr
    s_arrays, s_dims = downsample_operands(assign, arrays, dims, max_dim)
    return simulate_expr(assign, fmt, schedule, s_arrays, s_dims).cycles


def simulate_expr(expr, fmt, schedule, arrays, dims, *,
                  workers: int = 1,
                  hw: Optional[HardwareConfig] = None) -> ExprSimResult:
    """Lower (split + parallelize + tile) and simulate an expression
    end-to-end.

    ``hw`` selects a ``HardwareConfig`` point: finite PE counts, queue
    depths, and memory bandwidth floor/stretch the steady-state term as
    described on ``HardwareConfig``. The default point reproduces the
    paper's idealized machine — and therefore the historical cycle law —
    exactly.

    Serial schedules run the combined multi-term graph exactly as
    ``simulate`` always has. Parallel schedules run every (term, lane)
    subgraph independently — lane ``l`` of a parallelized term sees only
    chunk ``l`` of the parallelized variable's coordinate space — and a
    final merge stage sums the signed lane outputs at equal coordinates
    (the lane-join unioner/reducer of §4.4). Tiled schedules
    (``Schedule.tile``, the out-of-core knob, and with it ``workers``)
    raise ``NotImplementedError`` in the port until tiles are ported;
    untiled expressions are one unit of work, so ``workers`` does not
    change them.

    >>> import numpy as np
    >>> from repro_torch.core.schedule import Format, Schedule
    >>> B = np.array([[1., 0., 2.], [0., 3., 0.]])
    >>> res = simulate_expr("x(i) = B(i,j) * c(j)", Format({"B": "cc"}),
    ...                     Schedule(loop_order=("i", "j")),
    ...                     {"B": B, "c": np.ones(3)}, {"i": 2, "j": 3})
    >>> res.dense.tolist(), res.tiles
    ([3.0, 3.0], 1)
    >>> slow = simulate_expr("x(i) = B(i,j) * c(j)", Format({"B": "cc"}),
    ...                      Schedule(loop_order=("i", "j")),
    ...                      {"B": B, "c": np.ones(3)}, {"i": 2, "j": 3},
    ...                      hw=HardwareConfig(mem_bandwidth=0.25))
    >>> slow.dense.tolist() == res.dense.tolist(), slow.cycles > res.cycles
    (True, True)
    """
    from .custard import lower

    hw = hw or HardwareConfig()
    if getattr(schedule, "tile", None):
        return _simulate_tiled(expr, fmt, schedule, arrays, dims,
                               workers=workers, hw=hw)

    low = lower(expr, fmt, schedule, dims)
    tensors = low.build_inputs(arrays)
    out_name = low.assign.lhs.tensor

    if low.par_n <= 1 and low.graph is not None:
        res = Simulator(low.graph, tensors, hw=hw).run()
        # a single-term graph carries no sign (signs live outside the graph
        # on every execution path); multi-term graphs fold signs internally
        sign = low.terms[0].sign if len(low.terms) == 1 else 1
        dense = low.unsplit(sign * res.outputs[out_name].to_dense())
        return ExprSimResult(dense=dense, cycles=res.cycles,
                             lanes=[LaneSim(sign, 0, None, res)],
                             merge_work=0)

    # per-(term, lane) execution; also the path for expressions only the
    # per-term factoring lowers (e.g. a leading negative term)
    lanes: List[LaneSim] = []
    for ti, tl in enumerate(low.require_terms()):
        for lane in (range(tl.lane_n) if tl.lane_n > 1 else [None]):
            res = Simulator(tl.graph, tensors, lane=lane).run()
            lanes.append(LaneSim(tl.sign, ti, lane, res))

    # merge stage: signed sum of lane outputs at equal coordinates
    dense_split = None
    merge_work = 0
    for ls in lanes:
        d = ls.result.outputs[out_name].to_dense()
        merge_work += ls.result.outputs[out_name].nnz + 1
        dense_split = (ls.sign * d if dense_split is None
                       else dense_split + ls.sign * d)
    dense = low.unsplit(dense_split)

    steady = max((max(ls.result.work.values(), default=1) for ls in lanes),
                 default=1)
    steady = _hw_steady(
        hw, steady,
        sum(sum(ls.result.work.values()) for ls in lanes),
        sum(_sim_mem_tokens(ls.result) for ls in lanes))
    fill = max((ls.result.graph.depth() for ls in lanes), default=0) + 1
    cycles = max(steady, merge_work) + fill + _hw_stall(hw, steady)
    return ExprSimResult(dense=dense, cycles=cycles, lanes=lanes,
                         merge_work=merge_work)


# tiled schedules need ``core/tiling``, which the port has not copied yet
_TILES_SLICE = "ROADMAP.md, still to port #3: tiles"


def _simulate_tiled(expr, fmt, schedule, arrays, dims,
                    workers: int = 1,
                    hw: Optional[HardwareConfig] = None) -> ExprSimResult:
    """Simulate a ``Schedule.tile`` schedule (the reference's per-tile
    streaming law): not ported, so it raises."""
    raise NotImplementedError(
        f"tiled schedules are not ported yet ({_TILES_SLICE})")
