"""SAM dataflow graph IR (paper §3, §4).

Nodes are instances of the SAM dataflow blocks; edges are typed streams
(crd/ref/val/bv). The IR is the compilation target of Custard (§5) and the
input of both the cycle-approximate simulator and the JAX backend.

Block kinds (paper definition in parens):

core (§3):
  root           — emits the scalar root reference stream  (implicit in paper figs)
  level_scan     (3.1)  intersect (3.2)  union (3.3)  repeat (3.4)
  array          (3.5)  alu       (3.6)  reduce (3.7)
  level_write    (3.8)  crd_drop  (3.9)
optimization (§4):
  locate         (4.1)  bv_convert (4.2)  bv_scan (§4.3)
  parallelize / serialize (§4.4)

``primitive_counts`` reports the Table-1 row for a graph.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Any, Dict, List, Optional, Tuple

from . import streams as st

# canonical kind names
ROOT = "root"
LEVEL_SCAN = "level_scan"
INTERSECT = "intersect"
UNION = "union"
REPEAT = "repeat"
ARRAY = "array"
ALU = "alu"
REDUCE = "reduce"
LEVEL_WRITE = "level_write"
CRD_DROP = "crd_drop"
LOCATE = "locate"
BV_CONVERT = "bv_convert"
CONVERT = "convert"
PARALLELIZE = "parallelize"
SERIALIZE = "serialize"

ALL_KINDS = (ROOT, LEVEL_SCAN, INTERSECT, UNION, REPEAT, ARRAY, ALU, REDUCE,
             LEVEL_WRITE, CRD_DROP, LOCATE, BV_CONVERT, CONVERT, PARALLELIZE,
             SERIALIZE)

# Table-1 column order (paper §6.1)
TABLE1_COLUMNS = ("level_scan", "repeat", "intersect", "union", "alu",
                  "reduce", "crd_drop", "level_write", "array")


@dataclasses.dataclass
class Node:
    id: int
    kind: str
    name: str = ""
    # free-form block parameters:
    #  level_scan: tensor, mode(level index), var, format, skip(bool), bv(bool)
    #              chunk_n (§4.4: the var's coordinate space partitions into
    #              chunk_n lanes; the executor supplies the lane id)
    #  intersect/union: arity, vars
    #  repeat: tensor, var
    #  array: tensor ("vals" proxy), mode="vals"
    #  alu: op in {mul, add, sub}
    #  reduce: n (dimension of accumulation memory), var,
    #          depth (static input value-stream depth — declared because
    #          all-empty lane streams cannot reveal their own depth)
    #  level_write: tensor, var or "vals", format
    #  crd_drop: outer var, inner ("<var>"|"vals"), outer_depth (static)
    #  locate: tensor, var, format
    #  convert: tensor, op ("sort": re-order an unordered level's crd/ref
    #           streams into ascending-coordinate order; "tree": rebuild a
    #           non-unique tensor into canonical unique levels before its
    #           scanners run), var+mode (sort), from_format/to_format (tree)
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        p = ",".join(f"{k}={v}" for k, v in self.params.items())
        return f"{self.kind}#{self.id}[{self.name}]({p})"


@dataclasses.dataclass(frozen=True)
class Edge:
    src: int
    src_port: str
    dst: int
    dst_port: str
    stream: str          # st.CRD / st.REF / st.VAL / st.BV


class Graph:
    """A SAM dataflow graph (DAG; skip-feedback is folded into blocks)."""

    def __init__(self, name: str = "sam"):
        self.name = name
        self.nodes: Dict[int, Node] = {}
        self.edges: List[Edge] = []
        self._next = itertools.count()

    # -- construction --------------------------------------------------------
    def add(self, kind: str, name: str = "", **params) -> Node:
        if kind not in ALL_KINDS:
            raise ValueError(f"unknown block kind {kind!r}")
        n = Node(id=next(self._next), kind=kind, name=name, params=params)
        self.nodes[n.id] = n
        return n

    def connect(self, src: Node, src_port: str, dst: Node, dst_port: str,
                stream: str) -> Edge:
        if stream not in (st.CRD, st.REF, st.VAL, st.BV):
            raise ValueError(f"unknown stream type {stream!r}")
        e = Edge(src.id, src_port, dst.id, dst_port, stream)
        self.edges.append(e)
        return e

    # -- queries --------------------------------------------------------------
    def in_edges(self, node: Node) -> List[Edge]:
        return [e for e in self.edges if e.dst == node.id]

    def out_edges(self, node: Node) -> List[Edge]:
        return [e for e in self.edges if e.src == node.id]

    def of_kind(self, kind: str) -> List[Node]:
        return [n for n in self.nodes.values() if n.kind == kind]

    def topo_order(self) -> List[Node]:
        indeg = {i: 0 for i in self.nodes}
        for e in self.edges:
            indeg[e.dst] += 1
        ready = sorted(i for i, d in indeg.items() if d == 0)
        out: List[Node] = []
        while ready:
            i = ready.pop(0)
            out.append(self.nodes[i])
            for e in self.edges:
                if e.src == i:
                    indeg[e.dst] -= 1
                    if indeg[e.dst] == 0:
                        ready.append(e.dst)
        if len(out) != len(self.nodes):
            raise ValueError("SAM graph has a cycle")
        return out

    def depth(self) -> int:
        """Longest path length — the pipeline-fill latency term."""
        order = self.topo_order()
        dist = {n.id: 0 for n in order}
        for n in order:
            for e in self.edges:
                if e.src == n.id:
                    dist[e.dst] = max(dist[e.dst], dist[n.id] + 1)
        return max(dist.values(), default=0)

    def validate(self) -> None:
        """Structural checks: port discipline + acyclicity."""
        self.topo_order()
        for e in self.edges:
            if e.src not in self.nodes or e.dst not in self.nodes:
                raise ValueError(f"dangling edge {e}")
        # every non-root block must have at least one input
        for n in self.nodes.values():
            if n.kind != ROOT and not self.in_edges(n):
                raise ValueError(f"block {n} has no inputs")

    def canonical_form(self) -> str:
        """Deterministic textual serialization of the graph structure.

        Node ids are renumbered in topological order (ties broken by
        allocation order, which is deterministic for a given lowering), and
        params are emitted key-sorted, so repeated lowerings of the same
        input serialize identically. This is the basis of the
        compiled-engine jit cache key. Note this is NOT a graph-isomorphism
        canonical form: independently-built graphs that allocate nodes in a
        different order can serialize differently (cost: a spurious cache
        miss, never a wrong hit).
        """
        order = self.topo_order()
        renum = {n.id: i for i, n in enumerate(order)}
        lines = []
        for n in order:
            params = ",".join(f"{k}={n.params[k]!r}"
                              for k in sorted(n.params))
            lines.append(f"n{renum[n.id]}:{n.kind}({params})")
        for e in sorted(self.edges,
                        key=lambda e: (renum[e.src], e.src_port,
                                       renum[e.dst], e.dst_port)):
            lines.append(f"e:{renum[e.src]}.{e.src_port}->"
                         f"{renum[e.dst]}.{e.dst_port}:{e.stream}")
        return "\n".join(lines)

    def structural_hash(self) -> str:
        """Short stable digest of ``canonical_form`` (jit cache key part)."""
        return hashlib.sha256(
            self.canonical_form().encode()).hexdigest()[:16]

    # -- reporting -------------------------------------------------------------
    def primitive_counts(self) -> Dict[str, int]:
        counts = {k: 0 for k in TABLE1_COLUMNS}
        for n in self.nodes.values():
            if n.kind in counts:
                counts[n.kind] += 1
            elif n.kind == LOCATE:
                # Table 1 counts locate-optimized graphs under intersect
                counts[INTERSECT] += 1
        return counts

    def to_dot(self) -> str:
        lines = [f"digraph {self.name} {{", "  rankdir=LR;"]
        shape = {ROOT: "point", ARRAY: "box3d", ALU: "circle",
                 LEVEL_WRITE: "box", LEVEL_SCAN: "box"}
        for n in self.nodes.values():
            label = f"{n.kind}\\n{n.name}" if n.name else n.kind
            lines.append(
                f'  n{n.id} [label="{label}", shape={shape.get(n.kind, "ellipse")}];')
        style = {st.REF: "dashed", st.CRD: "solid", st.VAL: "bold", st.BV: "dotted"}
        for e in self.edges:
            lines.append(
                f'  n{e.src} -> n{e.dst} [style={style[e.stream]}, '
                f'label="{e.src_port}->{e.dst_port}"];')
        lines.append("}")
        return "\n".join(lines)
