"""PyTorch backend: binds SAM graphs to coordinate-array execution on a GPU.

The counterpart of ``repro.core.jax_backend``. A Custard-produced SAM
graph is walked in topological order, and each block lowers to a
data-parallel primitive from ``coord_ops``:

  level scanner  -> ragged fiber expansion (scan_level)
  intersecter    -> sorted-key searchsorted membership (predication mask)
  locator        -> a probe inside the parent's fiber
  repeater       -> a gather:  ref[child.parent]
  array/ALU      -> gathers / elementwise arithmetic
  reducer n=0    -> per-fiber segment_sum (zero-mode comes for free)
  reducer n>=1   -> ONE keyed reduce over the final result coordinates;
                    every remaining reduction collapses into it (sums
                    commute). On the GPU it runs on the hand-written
                    ``scatter_workspace`` / ``segment_reduce`` kernels
                    (``kernels/ops.py``).
  crd dropper    -> predication: ineffectual coordinates never reach the
                    output COO (masks instead of token removal).
  level writer   -> final compaction into an output FiberTree.

Streams carry a ``parent`` index tensor instead of stop tokens: element i
of a level belongs to the fiber of element ``parent[i]`` one level up.

Two execution modes share the block handlers:

* **Eager** (``execute_graph`` / ``execute_expr``): capacities are
  measured from the data per call. Kept as the reference path and as the
  capacity-recording pass of the compiled engine.
* **Compiled** (``compile_expr`` -> ``CompiledExpr``): operands are padded
  to power-of-two input buckets and every stream gets a fixed, bucketed
  capacity recorded once per input signature, so a plan's allocations do
  not depend on the data. PyTorch runs eagerly, so a plan is a Python
  closure over those capacities rather than a traced executable; every
  term runs and multi-term expressions fuse into one keyed union reduce.
  The result and the sizes each stream really needed come back to the
  host in ONE transfer per run, and a capacity overflow grows the plan
  and re-runs.

Schedules with ``split``/``parallelize`` (§4.1/§4.4) lower through
``custard.lower``: each parallelized term runs as N lanes, each the same
graph restricted to its coordinate chunk. Eager PyTorch has no ``vmap``
for ops whose output shape depends on the data, so the lanes of a plan
run one after another at the plan's fixed per-lane capacities (the
reference vmaps them, or shard_maps them over a device mesh), and every
(term, lane) partial merges through ONE keyed union reduce. Results come
back in the original coordinate space. ``execute_batch`` runs many
same-format operand sets through one plan: they pad to one input
signature, upload stacked (one copy per operand array), run member by
member on the same kernels, and return in one transfer.

``b``-format (block-sparse) operands take the BSR bridge: ``compile_expr``
routes an expression that ``bsr_bridge.bsr_pattern`` recognizes (SpMM,
SDDMM, block attention) to a ``BsrEngine`` on its three hand-written
kernels; any other ``b``-format expression goes on to ``CompiledExpr``,
which refuses ``b`` levels as the reference's does.

Multi-assignment programs (``compile_program`` -> ``CompiledProgram``)
run each fused producer→consumer chain as one ``_FusedChain``: the
producer's keyed COO result turns into on-device ``(seg, crd)`` levels
through the ``coo_to_levels`` dispatch entry (the hand-written
``coo_levels`` kernel on the GPU) and the consumer's level scanners read
them there; every other stage is a ``CompiledExpr`` with a dense host
handoff between units.

Out-of-core execution (``Schedule.tile``, or a ``mem_budget`` that
``tiling.resolve_plan`` turns into one) runs as a ``TiledExpr``: the
tiles of the coordinate space stream one after another through ONE
shared per-tile ``CompiledExpr`` (one plan for every tile), and their
partial COOs merge on the host's running accumulator through
``coord_ops.accumulate_coo``, one keyed union reduce a tile on the
device. Under a budget each tile runs in pieces (``core/pieces.py``):
lanes over its outermost loop variable, so the port's streams keep the
budget the reference's estimate planned for. ``schedule="auto"`` resolves
through the port's copy of
``autoschedule`` (its persistent schedule cache is the port's own file).

Not ported yet: lanes spread over more than one GPU (``shard_lanes``),
which raises ``NotImplementedError`` naming its ROADMAP.md slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from . import coord_ops as co
from . import graph as g
from . import pieces, tiling
from .bsr_bridge import BsrEngine, bsr_pattern
from .custard import expr_cache_key, lower
from .einsum import Assignment, Term, parse
from .fibertree import BITVECTOR, COMPRESSED, DENSE, FiberTree, canonical_tree
from .program import lower_program, program_cache_key
from .schedule import Format, Schedule, build_inputs

PAD = co.PAD_KEY

# what the unported path waits for: its entry in ROADMAP.md's list of
# what is still to port
_DIST_SLICE = "ROADMAP.md, still to port #5: distributed tiles"


@dataclasses.dataclass
class JLevel:
    seg: torch.Tensor
    crd: torch.Tensor
    dim: int


def _engine_tree(ft: FiberTree) -> FiberTree:
    """Canonicalize a tensor for engine ingest.

    The engine iterates (seg, crd) levels in ascending coordinate order,
    so singleton/hashed/bitmap storage is converted to its d/c canonical
    form here (bit-identical values; see ``fibertree.canonical_tree``).
    The graph's CONVERT nodes are then pass-throughs. Explicit ``b``
    (bitvector) storage stays simulator-only.
    """
    for lv in ft.levels:
        if lv.format == BITVECTOR:
            raise NotImplementedError(
                f"PyTorch backend supports d/c levels, not {lv.format}")
    return canonical_tree(ft)


@dataclasses.dataclass
class JTensor:
    levels: List[JLevel]
    vals: torch.Tensor

    @staticmethod
    def from_fibertree(ft: FiberTree, device) -> "JTensor":
        ft = _engine_tree(ft)
        levels = []
        num_parents = 1
        for lv in ft.levels:
            if lv.format == COMPRESSED:
                levels.append(JLevel(
                    torch.as_tensor(np.asarray(lv.seg, np.int32),
                                    device=device),
                    torch.as_tensor(np.asarray(lv.crd, np.int32),
                                    device=device), lv.dim))
                num_parents = len(lv.crd)
            elif lv.format == DENSE:
                # densified: fiber r is [0, dim) with refs r*dim + c
                seg = torch.arange(num_parents + 1, dtype=torch.int32,
                                   device=device) * lv.dim
                crd = torch.arange(lv.dim, dtype=torch.int32,
                                   device=device).repeat(num_parents)
                levels.append(JLevel(seg, crd, lv.dim))
                num_parents *= lv.dim
            else:
                raise NotImplementedError(
                    f"PyTorch backend supports d/c levels, not {lv.format}")
        return JTensor(levels, torch.as_tensor(
            np.asarray(ft.vals, np.float32), device=device))


@dataclasses.dataclass
class CanonStream:
    """Canonical iteration stream at one level (parent-indexed coords)."""

    var: str
    crd: torch.Tensor
    parent_idx: torch.Tensor
    valid: torch.Tensor
    dim: int
    parent: Optional["CanonStream"]
    _key: Optional[torch.Tensor] = None

    @property
    def size(self) -> int:
        return self.crd.shape[0]

    def key(self) -> torch.Tensor:
        if self._key is None:
            if self.parent is None:
                base = torch.zeros_like(self.crd, dtype=torch.int64)
            else:
                pk = self.parent.key()
                base = pk.index_select(
                    0, co._clip(self.parent_idx, 0, pk.shape[0] - 1))
            k = base * self.dim + self.crd.to(torch.int64)
            self._key = torch.where(self.valid & (base != PAD), k, PAD)
        return self._key

    def ancestors(self) -> List["CanonStream"]:
        out, s = [], self
        while s is not None:
            out.append(s)
            s = s.parent
        return out  # innermost first


@dataclasses.dataclass
class RefStream:
    stream: Optional[CanonStream]        # None => scalar/root alignment
    ref: torch.Tensor
    valid: torch.Tensor


@dataclasses.dataclass
class ValStream:
    stream: Optional[CanonStream]
    _vals: Optional[torch.Tensor]
    valid: torch.Tensor
    # provenance of a multiply: ``(a_vals, b_vals)`` with
    # ``vals == a_vals * b_vals``; lets the final collapse hand the
    # un-multiplied streams to the fused multiply-reduce kernel
    pair: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @property
    def vals(self) -> torch.Tensor:
        """The values. A multiply's product is formed on first use: when
        it only feeds the final collapse, which takes ``pair``, it is never
        materialized (a stream-sized array less on the card)."""
        if self._vals is None:
            self._vals = self.pair[0] * self.pair[1]
        return self._vals


@dataclasses.dataclass
class COOResult:
    keys: torch.Tensor
    vals: torch.Tensor
    valid: torch.Tensor
    strides: List[Tuple[str, int]]       # (var, dim) outer->inner


def _val_writer_node(graph_: g.Graph) -> g.Node:
    for n in graph_.of_kind(g.LEVEL_WRITE):
        if n.params.get("var") == "vals":
            return n
    raise ValueError(f"graph {graph_.name} has no value writer")


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def decode_live_coo(keys, vals, valid, strides):
    """Host-side decode of a keyed COO result: drop padding and explicit
    zeros, then unflatten keys into per-level coordinates (one column per
    stride, outer->inner)."""
    keys, vals, valid = _host(keys), _host(vals), _host(valid)
    live = valid & (vals != 0.0)
    keys, vals = keys[live], vals[live]
    coords = np.zeros((len(keys), len(strides)), dtype=np.int64)
    rem = keys
    for col in range(len(strides) - 1, -1, -1):
        dim = strides[col][1]
        coords[:, col] = rem % dim
        rem = rem // dim
    return coords, vals


def coo_to_fibertree(keys, vals, valid, strides, shape, fmt_str,
                     mode_order) -> FiberTree:
    """Host-side decode of a keyed COO result into an output FiberTree."""
    coords, vals = decode_live_coo(keys, vals, valid, strides)
    ft = FiberTree.from_coords(shape, coords, vals, fmt_str)
    if mode_order is not None:
        ft.mode_order = tuple(mode_order)
    return ft


class TorchBackend:
    """Executes a single-term SAM graph on coordinate tensors.

    Eager mode (default): stream capacities are measured from the data per
    call (and recorded in ``caps_record`` for the compiled engine's
    capacity-bucketing pass). Static mode (``scan_caps``/``out_cap``
    given): every shape is fixed up front; the actually needed sizes come
    back as 0-d device tensors in ``required`` so the caller can detect
    capacity overflow and re-bucket.
    """

    def __init__(self, graph_: g.Graph, tensors: Dict[str, JTensor],
                 dims: Dict[str, int], result_vars: List[str], *,
                 device, scan_caps: Optional[Dict[int, int]] = None,
                 out_cap: Optional[int] = None,
                 segsum: Optional[Callable] = None,
                 intersect: Optional[Callable] = None,
                 mul_reduce: Optional[Callable] = None,
                 lane: Optional[int] = None):
        self.g = graph_
        self.t = tensors
        self.dims = dims
        self.result_vars = result_vars
        self.device = torch.device(device)
        # §4.4 parallel lane: ``chunk_n``-marked scanners restrict to this
        # lane's coordinate chunk; None executes the full iteration space
        self.lane = lane
        self.env: Dict[Tuple[int, str], Any] = {}
        self.final: Optional[COOResult] = None
        self.scan_caps = scan_caps
        self.out_cap = out_cap
        self.segsum = segsum                       # keyed segment-sum impl
        self.intersect_impl = intersect or co.intersect_keys
        # fused multiply × keyed-reduce impl for the final collapse; None
        # keeps the classic path (reduce the already-multiplied stream)
        self.mul_reduce_impl = mul_reduce
        self.caps_record: Dict[str, int] = {}      # eager: exact sizes used
        self.required: Dict[str, torch.Tensor] = {}  # static: device needs
        # the lane's coordinate chunk: (var, first, past-the-end)
        self._chunk: Optional[Tuple[str, int, int]] = None
        if lane is not None:
            for n in graph_.of_kind(g.LEVEL_SCAN):
                if n.params.get("chunk_n"):
                    v = n.params["var"]
                    csz = -(-dims[v] // n.params["chunk_n"])
                    self._chunk = (v, lane * csz, (lane + 1) * csz)

    # -- helpers -------------------------------------------------------
    def _ins(self, node):
        return {e.dst_port: self.env[(e.src, e.src_port)]
                for e in self.g.in_edges(node)}

    @staticmethod
    def _cap(n: int) -> int:
        return max(8, int(np.ceil(n / 8)) * 8)

    # -- handlers -------------------------------------------------------
    def _root(self, node, ins):
        return {"ref": RefStream(
            None, torch.zeros((1,), dtype=torch.int32, device=self.device),
            torch.ones((1,), dtype=torch.bool, device=self.device))}

    def _level_scan(self, node, ins):
        t = self.t[node.params["tensor"]]
        lv = t.levels[node.params["mode"]]
        r: RefStream = ins["ref"]
        pr = co._clip(r.ref, 0, lv.seg.shape[0] - 2)
        lengths = torch.where(r.valid & (r.ref >= 0),
                              lv.seg[pr + 1] - lv.seg[pr], 0)
        if self.scan_caps is None:
            need = int(torch.sum(lengths))
            cap = self._cap(need)
            self.caps_record[f"s{node.id}"] = need
        else:
            cap = self.scan_caps[node.id]
            self.required[f"s{node.id}"] = torch.sum(lengths)
        crd, ref, sid, valid = co.scan_level(lv.seg, lv.crd, r.ref, r.valid,
                                             cap)
        ref_valid = valid
        if node.params.get("chunk_n") and self._chunk is not None:
            # split-level scanning: predicate this lane's REFERENCE stream
            # to its contiguous coordinate chunk. The crd/key stream stays
            # fully valid (sorted-key intersection and locate probes rely
            # on monotone keys), while the dead references zero the
            # out-of-chunk subtrees and collapse their fiber expansions
            ref_valid = valid & self._in_chunk(crd)
        cs = CanonStream(var=node.params["var"], crd=crd, parent_idx=sid,
                         valid=valid, dim=lv.dim, parent=r.stream)
        out = {"crd": cs, "ref": RefStream(cs, ref, ref_valid)}
        if node.params.get("bv"):
            # word-packed graphs label this edge "bv"; canonical execution
            # publishes the same coordinate stream under both port names
            out["bv"] = cs
        return out

    def _intersect(self, node, ins):
        m = node.params.get("arity", 2)
        crds: List[CanonStream] = [
            ins[f"crd{i}"] if f"crd{i}" in ins else ins[f"bv{i}"]
            for i in range(m)]
        refs: List[RefStream] = [ins[f"ref{i}"] for i in range(m)]
        base = crds[0]
        hit = base.valid
        out_refs = [refs[0].ref]
        out_refs_valid = [refs[0].valid]
        akey = base.key()
        for i in range(1, m):
            bkey = crds[i].key()
            h, idx = self.intersect_impl(akey, hit, bkey, crds[i].valid)
            hit = h
            out_refs.append(refs[i].ref[idx])
            out_refs_valid.append(refs[i].valid[idx])
        cs = CanonStream(var=base.var, crd=base.crd,
                         parent_idx=base.parent_idx, valid=hit, dim=base.dim,
                         parent=base.parent)
        out = {"crd": cs}
        for i in range(m):
            out[f"ref{i}"] = RefStream(cs, out_refs[i],
                                       hit & out_refs_valid[i])
        return out

    def _locate(self, node, ins):
        t = self.t[node.params["tensor"]]
        lv = t.levels[node.params["mode"]]
        cs: CanonStream = ins["crd"]
        pref: RefStream = ins["ref"]
        # parent refs of the located tensor, gathered to element positions
        if pref.stream is None:
            par_ref = pref.ref[0].expand(cs.crd.shape)
            par_ok = pref.valid[0].expand(cs.crd.shape)
        else:
            par_ref = pref.ref[cs.parent_idx]
            par_ok = pref.valid[cs.parent_idx]
        found, idx = co.locate_keys(lv.seg, lv.crd, par_ref, cs.crd,
                                    cs.valid & par_ok)
        return {"crd": cs, "ref": RefStream(cs, idx, found),
                "ref_in": pref}

    def _in_chunk(self, crd: torch.Tensor) -> torch.Tensor:
        _, lo, hi = self._chunk
        return (crd >= lo) & (crd < hi)

    def _repeat(self, node, ins):
        r: RefStream = ins["ref"]
        cs: CanonStream = ins["crd"]
        if r.stream is None:
            ref = r.ref[0].expand(cs.crd.shape)
            ok = r.valid[0].expand(cs.crd.shape) & cs.valid
        else:
            ref = r.ref.index_select(0, cs.parent_idx)
            ok = r.valid.index_select(0, cs.parent_idx).logical_and_(
                cs.valid)
        if self._chunk is not None and cs.var == self._chunk[0]:
            # a tensor repeated over the lane's variable: only the lane's
            # chunk, so the fibers it scans below are the lane's alone
            # (nothing outside the chunk can meet the chunked operand)
            ok = ok & self._in_chunk(cs.crd)
        return {"ref": RefStream(cs, ref, ok)}

    def _array(self, node, ins):
        t = self.t[node.params["tensor"]]
        r: RefStream = ins["ref"]
        if t.vals.shape[0] == 0:   # tensor with no stored values
            vals = torch.zeros(r.ref.shape, dtype=torch.float32,
                               device=self.device)
            return {"val": ValStream(r.stream, vals, r.valid)}
        vals = t.vals.index_select(
            0, co._clip(r.ref, 0, t.vals.shape[0] - 1))
        vals.masked_fill_(~r.valid, 0.0)
        return {"val": ValStream(r.stream, vals, r.valid)}

    def _alu(self, node, ins):
        a: ValStream = ins["a"]
        b: ValStream = ins["b"]
        op = node.params["op"]
        if a.valid.shape != b.valid.shape:
            raise ValueError("ALU operands misaligned in PyTorch backend")
        if op == "mul":
            return {"val": ValStream(a.stream, None, a.valid | b.valid,
                                     pair=(a.vals, b.vals))}
        f = {"add": torch.add, "sub": torch.sub}[op]
        return {"val": ValStream(a.stream, f(a.vals, b.vals),
                                 a.valid | b.valid)}

    def _reduce(self, node, ins):
        v: ValStream = ins["val"]
        if self.final is not None:      # already collapsed into final reduce
            return {"val": v, **{f"crd{k}": ins[f"crd{k}"]
                                 for k in range(int(node.params.get("n", 0)))
                                 if f"crd{k}" in ins}}
        n = int(node.params.get("n", 0))
        cs = v.stream
        if n == 0:
            parent = cs.parent
            num = parent.size if parent is not None else 1
            sums = co.segment_sum(v.vals, cs.parent_idx, v.valid & cs.valid,
                                  num)
            pvalid = (parent.valid if parent is not None else
                      torch.ones((1,), dtype=torch.bool, device=self.device))
            return {"val": ValStream(parent, sums, pvalid)}
        # n >= 1: fuse every remaining reduction into one keyed reduce over
        # the final result coordinates.
        coo = self._collapse_to_result(v)
        self.final = coo
        out = {"val": coo}
        for k in range(n):
            if f"crd{k}" in ins:
                out[f"crd{k}"] = coo
        return out

    def _collapse_to_result(self, v: ValStream) -> COOResult:
        cs = v.stream
        chain = cs.ancestors()           # innermost first
        strides: List[Tuple[str, int]] = []
        mults: List[Optional[int]] = []  # a result level's key multiplier
        mult = 1
        for s in chain:
            if s.var in self.result_vars:
                mults.append(mult)
                strides.append((s.var, self.dims[s.var]))
                mult *= self.dims[s.var]
            else:
                mults.append(None)
        strides.reverse()                # outer -> inner
        # the key and validity of every level's elements, built outermost
        # first: each level gathers its parent's by ``parent_idx`` and adds
        # its own coordinate. Only the innermost level is stream-sized, so
        # the stream sees one int64 gather and one mask, nothing more (the
        # stream is a plan's largest allocation)
        key: Optional[torch.Tensor] = None
        valid: Optional[torch.Tensor] = None
        for s, m in zip(reversed(chain), reversed(mults)):
            if valid is None:
                valid = s.valid.clone()
            else:
                key = (None if key is None
                       else key.index_select(0, s.parent_idx))
                valid = valid.index_select(0, s.parent_idx).logical_and_(
                    s.valid)
            if m is not None:
                key = (s.crd.to(torch.int64).mul_(m) if key is None
                       else key.add_(s.crd, alpha=m))
        valid.logical_and_(v.valid)
        if key is None:
            key = torch.zeros(cs.size, dtype=torch.int64, device=self.device)
        if self.out_cap is None:
            # the eager pass sizes its reduce for every live row (at most
            # the key space), but records the distinct keys it found: a
            # plan's result holds those, so a product stream's result does
            # not cross to the host at the stream's capacity; a later call
            # with more keys reports ``count > cap`` and regrows
            cap = self._cap(min(int(torch.sum(valid)), mult))
        else:
            cap = self.out_cap
        if v.pair is not None and self.mul_reduce_impl is not None:
            # the stream is a multiply: hand the un-multiplied operand
            # streams to the fused multiply-reduce primitive (on the GPU
            # one workspace kernel forms the product; the fallback is the
            # composition below, so results are bit-identical)
            pa, pb = v.pair
            uk, uv, uvalid, count = self.mul_reduce_impl(
                key, pa, pb, valid, cap, key_bound=mult,
                segment_sum_impl=self.segsum)
        else:
            uk, uv, uvalid, count = co.keyed_union_reduce(
                key, v.vals, valid, cap, self.segsum, key_bound=mult)
        if self.out_cap is None:
            self.caps_record["out"] = int(count)
        else:
            self.required["out"] = count
        return COOResult(uk, uv, uvalid, strides)

    def _crd_drop(self, node, ins):
        # predication: masks already guarantee ineffectual coordinates never
        # reach the output; explicit zeros are filtered at assembly.
        out = {}
        if "outer" in ins:
            out["outer"] = ins["outer"]
        if "inner" in ins:
            out["inner"] = ins["inner"]
        for k in ins:
            if k.startswith("pass"):
                out[k] = ins[k]
        return out

    def _level_write(self, node, ins):
        return dict(ins)

    def _convert(self, node, ins):
        # format-conversion nodes are pass-throughs on the engine: operands
        # were canonicalized to d/c order at ingest (``_engine_tree``)
        return dict(ins)

    def run_nodes(self) -> None:
        handlers = {
            g.ROOT: self._root, g.LEVEL_SCAN: self._level_scan,
            g.INTERSECT: self._intersect, g.UNION: self._union_unsupported,
            g.REPEAT: self._repeat, g.ARRAY: self._array, g.ALU: self._alu,
            g.REDUCE: self._reduce, g.CRD_DROP: self._crd_drop,
            g.LOCATE: self._locate, g.LEVEL_WRITE: self._level_write,
            g.CONVERT: self._convert,
        }
        order = self.g.topo_order()
        # an output leaves ``env`` once its last consumer has run (the
        # writers' stay: ``run_streams`` reads them), so stream-sized
        # references (a scanner's refs, a repeat's gathers) free early
        pending: Dict[Tuple[int, str], int] = {}
        for node in order:
            for e in self.g.in_edges(node):
                key = (e.src, e.src_port)
                pending[key] = pending.get(key, 0) + 1
        for node in order:
            outs = handlers[node.kind](node, self._ins(node))
            for port, val in outs.items():
                self.env[(node.id, port)] = val
            for e in self.g.in_edges(node):
                key = (e.src, e.src_port)
                pending[key] -= 1
                if (pending[key] == 0
                        and self.g.nodes[e.src].kind != g.LEVEL_WRITE):
                    self.env.pop(key, None)

    def run_streams(self):
        """Execute the graph; return the value-writer stream in final form:
        a ``COOResult`` over the result coordinates, or a 0-d tensor."""
        self.run_nodes()
        n = _val_writer_node(self.g)
        v = self.env[(n.id, "val")]
        if isinstance(v, COOResult):
            return v
        if isinstance(v, ValStream):
            if v.stream is None:     # scalar result
                return torch.sum(torch.where(v.valid, v.vals, 0.0))
            return self._collapse_to_result(v)
        raise TypeError(type(v))

    def run(self) -> Dict[str, FiberTree]:
        v = self.run_streams()
        n = _val_writer_node(self.g)
        tname = n.params["tensor"]
        if not isinstance(v, COOResult):           # scalar result
            return {tname: FiberTree.from_dense(np.asarray(float(v)), "")}
        fmt = n.params.get("format", "c" * len(v.strides)) or ""
        return {tname: coo_to_fibertree(
            v.keys, v.vals, v.valid, v.strides, n.params.get("shape", ()),
            fmt, n.params.get("mode_order"))}

    def _union_unsupported(self, node, ins):
        raise NotImplementedError(
            "multi-term graphs: compile per term (see CompiledExpr) and "
            "combine with the fused keyed union")


# ---------------------------------------------------------------------------
# compiled engine
# ---------------------------------------------------------------------------

def _cat(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``torch.cat``, without the copy of a single tensor."""
    return tensors[0] if len(tensors) == 1 else torch.cat(tensors)


def _bucket(n: int) -> int:
    """Capacity bucket: next power of two, floor 8. Bucketing keeps the
    number of distinct plans logarithmic in the data size."""
    return 8 if n <= 8 else 1 << (n - 1).bit_length()


def _bucket_cap(n: int) -> int:
    """Bucket an intermediate-stream capacity with 25% headroom so sizes
    recorded just under a power of two don't regrow on the next call."""
    return _bucket(int(n * 1.25))


def _pad_end(a: np.ndarray, n: int, fill) -> np.ndarray:
    if a.shape[0] >= n:
        return a
    pad = np.full((n - a.shape[0],), fill, a.dtype)
    return np.concatenate([a, pad])


@dataclasses.dataclass
class _Plan:
    """One executable: fixed capacities + the callable that honours them."""
    caps: Dict[str, int]
    fn: Callable


@dataclasses.dataclass
class EncodedBatch:
    """A host-encoded batched dispatch, ready for the device stage.

    Produced by ``CompiledExpr.encode_batch`` (host encode), consumed by
    ``execute_encoded`` (device execute) and ``decode_batch`` (host
    decode), so a serving pipeline can overlap the encode of dispatch N+1
    with the execute of dispatch N."""
    stacked: Any                 # batch-stacked padded operand arrays
    sig: Tuple                   # shared input signature (plan-cache key)
    b: int                       # batch members
    flats: List                  # members, unstacked (cap recording)
    rep: int = 0                 # index of the largest-nnz member


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Bring device tensors to the host in ONE transfer: each is viewed as
    bytes, the bytes are joined on the device (widest types first, so every
    piece stays aligned), copied once, and viewed back as numpy arrays."""
    names = sorted(tensors, key=lambda k: -tensors[k].element_size())
    flat = [tensors[k].contiguous().reshape(-1) for k in names]
    if not flat or flat[0].device.type == "cpu":
        return {k: t.reshape(tensors[k].shape).numpy()
                for k, t in zip(names, flat)}
    blob = torch.cat([t.view(torch.uint8) for t in flat]).cpu().numpy()
    out, off = {}, 0
    for k, t in zip(names, flat):
        n = t.numel() * t.element_size()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out[k] = blob[off:off + n].view(dtype).reshape(tensors[k].shape)
        off += n
    return out


def _max_into(required: Dict[str, torch.Tensor], key: str,
              r: torch.Tensor) -> None:
    """Keep the largest need of ``key`` (over lanes, or batch members)."""
    r = r.reshape(()).to(torch.int64)
    required[key] = r if key not in required else torch.maximum(
        required[key], r)


def _run_with_growth(plan: _Plan, flat, stats: Dict[str, int],
                     reinstall: Callable[[Dict[str, int]], _Plan],
                     fresh: bool):
    """Run a plan, growing bucketed capacities on overflow and retrying.

    Each retry can reveal larger downstream needs (truncation hid
    elements), so loop to a fixpoint. On a plan hit the result and the
    required sizes reach the host together in ONE transfer (a transfer per
    capacity would synchronize once per stream). A ``fresh`` plan (just
    recorded) and a grown one may overflow, so their runs bring the needs
    back alone first and the result only once it fits: a retry moves no
    result. The result comes back as numpy arrays.
    """
    for _ in range(32):
        out, required = plan.fn(flat)
        names = list(required)
        dev = {f"out.{k}": v for k, v in out.items()}
        if names:
            dev["needs"] = torch.stack([required[k].reshape(()).to(
                torch.int64) for k in names])
        needs_only = fresh and bool(names)
        host = _to_host({"needs": dev["needs"]} if needs_only else dev)
        needs = host["needs"].tolist() if names else []
        grow = {k: _bucket_cap(n) for k, n in zip(names, needs)
                if n > plan.caps[k]}
        if not grow:
            if needs_only:
                host = _to_host(dev)
            return {k[4:]: v for k, v in host.items()
                    if k.startswith("out.")}
        stats["overflow_retries"] += 1
        plan = reinstall({**plan.caps, **grow})
        fresh = True
    raise RuntimeError("compiled SAM capacity growth did not converge")


def _raw_flat_of(ft: FiberTree) -> Dict[str, Any]:
    """Raw per-level arrays of one operand fibertree, as numpy. Dense
    levels get zero-length placeholders (``_pad_flat_arrays`` rebuilds
    their expansion from the level metadata)."""
    segs, crds = [], []
    empty = np.zeros(0, np.int32)
    for lv in ft.levels:
        if lv.format == COMPRESSED:
            segs.append(np.asarray(lv.seg, np.int32))
            crds.append(np.asarray(lv.crd, np.int32))
        elif lv.format == DENSE:
            segs.append(empty)
            crds.append(empty)
        else:
            raise NotImplementedError(
                f"PyTorch backend supports d/c levels, not {lv.format}")
    return {"segs": tuple(segs), "crds": tuple(crds),
            "vals": np.asarray(ft.vals, np.float32)}


def _pad_flat_arrays(raw, level_meta, hints=None):
    """Pad raw operand arrays to power-of-two buckets.

    Only compressed-level coordinate counts are bucketed independently;
    segment lengths (parents+1), dense-level expansions, and the value
    array length all derive from the parent-level bucket, so the input
    signature depends on nothing but per-level nnz buckets.
    """
    flat, sig = {}, []
    for name in sorted(raw):
        e = raw[name]
        segs, crds, lsig = [], [], []
        num_parents = 1
        for i, (fmt_l, dim) in enumerate(level_meta[name]):
            ns = num_parents + 1
            if fmt_l == DENSE:
                nc = num_parents * dim
                segs.append(np.arange(ns, dtype=np.int32) * dim)
                crds.append(np.tile(np.arange(dim, dtype=np.int32),
                                    num_parents))
            else:
                c = e["crds"][i]
                nc = (hints[name][i] if hints
                      else _bucket(c.shape[0]))
                s = e["segs"][i]
                segs.append(_pad_end(s, ns, s[-1]))
                crds.append(_pad_end(c, nc, 0))
            lsig.append((ns, nc))
            num_parents = nc
        vals = _pad_end(e["vals"], num_parents, 0.0)
        flat[name] = {"segs": tuple(segs), "crds": tuple(crds),
                      "vals": vals}
        sig.append((name, tuple(lsig), vals.shape[0]))
    return flat, tuple(sig)


def _tensors_from_flat_arrays(flat, level_meta, device
                              ) -> Dict[str, JTensor]:
    """Upload padded numpy operands to ``device`` as engine tensors."""
    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {name: JTensor(
        [JLevel(up(s), up(c), d)
         for s, c, (_, d) in zip(e["segs"], e["crds"], level_meta[name])],
        up(e["vals"])) for name, e in flat.items()}


_COMPILED: Dict[Tuple, "CompiledExpr"] = {}
_BSR: Dict[Tuple, BsrEngine] = {}


def _stack_flats(flats: Sequence[Dict]) -> Dict:
    """Stack same-signature padded operand sets along a new leading axis
    (a view, not a copy, for a single set)."""
    def stack(arrays):
        return arrays[0][None] if len(arrays) == 1 else np.stack(arrays)

    out = {}
    for name, e in flats[0].items():
        out[name] = {part: tuple(stack([f[name][part][i] for f in flats])
                                 for i in range(len(e[part])))
                     for part in ("segs", "crds")}
        out[name]["vals"] = stack([f[name]["vals"] for f in flats])
    return out


def _member(tensors: Dict[str, JTensor], m: int) -> Dict[str, JTensor]:
    """Batch member ``m`` of batch-stacked engine tensors (views)."""
    return {name: JTensor([JLevel(lv.seg[m], lv.crd[m], lv.dim)
                           for lv in jt.levels], jt.vals[m])
            for name, jt in tensors.items()}


def lane_mesh_size(par_n: int, bound: Optional[int] = None) -> int:
    """Largest CUDA device count that can host the lane mesh: the biggest
    divisor of ``par_n`` no larger than the available GPUs (and the
    caller's ``bound``, e.g. serve's --devices). 1 means no useful mesh."""
    n_dev = torch.cuda.device_count()
    limit = min(n_dev, par_n, bound or n_dev)
    return max((d for d in range(1, limit + 1) if par_n % d == 0),
               default=1)


def _check_shard_lanes(shard_lanes, par_n: int) -> None:
    """The port's counterpart of the reference's ``_resolve_shard_lanes``.
    ``shard_lanes``: None or False runs every lane on the engine's device
    (a mesh of 1); True (or an int device bound) REQUIRES a mesh of 2 or
    more GPUs and raises ``ValueError`` when none fits, as the reference
    does. Spreading lanes over GPUs belongs to the distributed slice, so
    where a mesh would fit it raises ``NotImplementedError``."""
    if shard_lanes is None or shard_lanes is False:
        return
    bound = None if shard_lanes is True else int(shard_lanes)
    m = lane_mesh_size(par_n, bound)
    if m < 2:
        raise ValueError(
            f"cannot shard {par_n} lane(s) over {torch.cuda.device_count()} "
            f"device(s)" + (f" with --devices {bound}" if bound else ""))
    raise NotImplementedError(
        f"lanes over {m} GPUs are not ported yet ({_DIST_SLICE})")


class CompiledExpr:
    """A Custard expression lowered once into plan-cached executables.

    Lifecycle per call:

    1. operands -> concordant fibertrees -> coordinate arrays, padded to
       power-of-two **input buckets** (the plan key stays stable while nnz
       wobbles inside a bucket), uploaded to ``device``;
    2. plan lookup by input signature. A miss runs the eager backend once
       as a **capacity-recording pass** and buckets every intermediate
       stream capacity (``stats["traces"]`` counts plan builds);
    3. the plan runs every term, each parallelized term lane by lane, and
       fuses every (term, lane) partial with one keyed union reduce; it
       also returns the true required sizes, so a **capacity overflow**
       grows the plan and re-runs — results are never silently truncated;
    4. the COO result is decoded host-side into an output FiberTree in
       the ORIGINAL coordinate space (split levels re-merged).

    ``execute_batch`` runs many same-format operand sets through one plan
    (every member pads to one shared signature); a single call is a batch
    of one, so both share one plan cache. ``device`` defaults to CUDA; with no GPU, pass
    ``device="cpu"`` to run the plain PyTorch fallbacks.
    """

    def __init__(self, expr, fmt: Format, schedule: Schedule,
                 dims: Dict[str, int], *, use_kernels: bool = True,
                 device=None, shard_lanes: Optional[bool] = None):
        self.device = co.resolve_device(device)
        self.assign: Assignment = parse(expr) if isinstance(expr, str) else expr
        self.fmt = fmt
        self.schedule = schedule
        self.dims = dict(dims)
        self.cache_key = expr_cache_key(self.assign, fmt, schedule, self.dims)
        low = lower(self.assign, fmt, schedule, self.dims)
        self.low = low
        terms = low.require_terms()
        self.signs = [t.sign for t in terms]
        self.graphs = [t.graph for t in terms]
        self.lane_ns = [t.lane_n for t in terms]
        self.par_n = low.par_n
        self.graph_hashes = tuple(G.structural_hash() for G in self.graphs)
        self.rvars = low.result_vars           # post-split, loop order
        self._scalar = not self.rvars
        writer = _val_writer_node(self.graphs[0])
        self._out_shape = writer.params.get("shape", ())
        self._out_fmt = (writer.params.get("format")
                         or "c" * len(self.rvars))
        self._mode_order = writer.params.get("mode_order")
        self._strides = [(v, low.dims[v]) for v in self.rvars]
        # results come back in the ORIGINAL coordinate space: split result
        # levels (vo, vi) are re-merged during output assembly
        self._out_merge = self._build_out_merge()
        _check_shard_lanes(shard_lanes, self.par_n)
        self._segsum = None
        self._intersect = None
        self._union_reduce = None
        self._mul_reduce = None
        if use_kernels:
            self._segsum = kops.sam_primitive("keyed_segment_sum",
                                              self.device)
            self._intersect = kops.sam_primitive("sorted_intersect",
                                                 self.device)
            self._union_reduce = kops.sam_primitive("keyed_union_reduce",
                                                    self.device)
            self._mul_reduce = kops.sam_primitive("mul_reduce", self.device)
        self._level_meta: Dict[str, List[Tuple[str, int]]] = {}
        self._plans: Dict[Tuple, _Plan] = {}
        self._core_cache: Dict[Tuple, Callable] = {}
        # sticky per-level bucket high-water for batched encodes: a stream
        # of batches whose nnz jitters across buckets settles on ONE
        # signature (and one plan) after warm-up
        self._hint_highwater: Dict[str, List[int]] = {}
        self.stats = {"traces": 0, "plan_hits": 0, "plan_misses": 0,
                      "overflow_retries": 0, "calls": 0, "batch_calls": 0,
                      "lane_dispatches": 0, "sharded_dispatches": 0}

    def _build_out_merge(self):
        """Decode plan for split result levels: [(orig var, o-col, i-col or
        None, inner chunk)] over the post-split stride columns."""
        split_of = self.low.split_of
        if not any(v in split_of for v in self.low.orig_result_vars):
            return None
        merge, i = [], 0
        while i < len(self.rvars):
            v = self.rvars[i]
            if (v.endswith("o") and v[:-1] in split_of
                    and i + 1 < len(self.rvars)
                    and self.rvars[i + 1] == v[:-1] + "i"):
                merge.append((v[:-1], i, i + 1, self.low.dims[v[:-1] + "i"]))
                i += 2
            else:
                merge.append((v, i, None, None))
                i += 1
        return merge

    # -- operand flattening ------------------------------------------------
    def _raw_flat(self, arrays: Dict[str, np.ndarray]) -> Dict[str, Any]:
        tensors = self.low.build_inputs(arrays)
        raw = {}
        for name, ft in tensors.items():
            ft = _engine_tree(ft)   # s/h/m storage canonicalizes to d/c
            self._level_meta.setdefault(
                name, [(lv.format, lv.dim) for lv in ft.levels])
            raw[name] = _raw_flat_of(ft)
        return raw

    def _pad_flat(self, raw, hints=None):
        """Pad operand arrays to power-of-two buckets (see
        ``_pad_flat_arrays``)."""
        return _pad_flat_arrays(raw, self._level_meta, hints)

    def _tensors_from_flat(self, flat) -> Dict[str, JTensor]:
        return _tensors_from_flat_arrays(flat, self._level_meta, self.device)

    # -- plan construction -------------------------------------------------
    def _lanes_of(self, ti: int):
        n = self.lane_ns[ti]
        return range(n) if n > 1 else [None]

    def _needs_fused(self) -> bool:
        return (not self._scalar
                and (len(self.graphs) > 1
                     or any(n > 1 for n in self.lane_ns)))

    def _backend(self, ti: int, tensors, lane=None, **caps) -> TorchBackend:
        return TorchBackend(self.graphs[ti], tensors, self.low.dims,
                            self.rvars, device=self.device,
                            segsum=self._segsum, intersect=self._intersect,
                            mul_reduce=self._mul_reduce, lane=lane, **caps)

    def _record_caps(self, flats: Sequence[Dict]) -> Dict[str, int]:
        """Eager capacity-recording pass over one (or, batched, every)
        concrete padded operand set; returns bucketed capacities. Parallel
        lanes run with their lane ids, and a laned term's caps are the max
        over its lanes (every lane runs at the same capacities). It runs
        through the same dispatch entries as the plans, so on the GPU its
        reduces are the kernels too."""
        caps: Dict[str, int] = {}
        fused_need = 0
        for flat in flats:
            tensors = self._tensors_from_flat(flat)
            call_fused = 0
            for ti in range(len(self.graphs)):
                for lane in self._lanes_of(ti):
                    be = self._backend(ti, tensors, lane)
                    v = be.run_streams()
                    for k, n in be.caps_record.items():
                        key = f"t{ti}.{k}"
                        caps[key] = max(caps.get(key, 0), n)
                    if isinstance(v, COOResult):
                        call_fused += int(torch.sum(v.valid))
            fused_need = max(fused_need, call_fused)
        caps = {k: _bucket_cap(n) for k, n in caps.items()}
        if self._needs_fused():
            caps["fused"] = _bucket_cap(fused_need)
        return caps

    def _build_core(self, caps: Dict[str, int]) -> Callable:
        union_reduce = self._union_reduce or co.keyed_union_reduce
        scan_caps = [
            {n.id: caps[f"t{ti}.s{n.id}"] for n in G.of_kind(g.LEVEL_SCAN)}
            for ti, G in enumerate(self.graphs)]
        out_caps = [caps.get(f"t{ti}.out") for ti in range(len(self.graphs))]
        signs = self.signs
        bound = 1
        for _, d in self._strides:
            bound *= d

        def run_term(ti, tensors, required):
            """One term's partial. Its lanes run one after another at the
            plan's per-lane capacities; a lane's needs are maxed."""
            parts = []
            for lane in self._lanes_of(ti):
                be = self._backend(ti, tensors, lane, scan_caps=scan_caps[ti],
                                   out_cap=out_caps[ti])
                parts.append(be.run_streams())
                for k, r in be.required.items():
                    _max_into(required, f"t{ti}.{k}", r)
            if len(parts) == 1:
                return parts[0]
            if self._scalar:
                return torch.stack(parts).sum()
            return COOResult(torch.cat([c.keys for c in parts]),
                             torch.cat([c.vals for c in parts]),
                             torch.cat([c.valid for c in parts]),
                             list(self._strides))

        def run(tensors):
            required: Dict[str, torch.Tensor] = {}
            outs = [run_term(ti, tensors, required)    # COOResult or scalar
                    for ti in range(len(self.graphs))]
            if self._scalar:
                total = signs[0] * outs[0]
                for s, v in zip(signs[1:], outs[1:]):
                    total = total + s * v
                return {"scalar": total}, required
            if len(outs) == 1 and self.lane_ns[0] == 1:
                coo = outs[0]
                vals = coo.vals if signs[0] == 1 else signs[0] * coo.vals
                return {"keys": coo.keys, "vals": vals,
                        "valid": coo.valid}, required
            # term/lane merge: ONE keyed union reduce combines every (term,
            # lane) partial result (sums commute; signs fold into the
            # values; disjoint lane outputs merge by concatenation for free)
            keys = _cat([c.keys for c in outs])
            vals = _cat([c.vals if s == 1 else s * c.vals
                         for s, c in zip(signs, outs)])
            valid = _cat([c.valid for c in outs])
            del outs
            uk, uv, uvalid, count = union_reduce(
                keys, vals, valid, caps["fused"], self._segsum,
                key_bound=bound)
            required["fused"] = count
            return {"keys": uk, "vals": uv, "valid": uvalid}, required

        def core(stacked):
            """A batch-stacked operand set (one upload per array; a single
            call is a batch of one): the members run one after another on
            the same plan, their results stacked along a leading axis and
            their needs maxed."""
            tensors = self._tensors_from_flat(stacked)
            required: Dict[str, torch.Tensor] = {}
            outs = []
            for m in range(next(iter(tensors.values())).vals.shape[0]):
                out, req = run(_member(tensors, m))
                outs.append(out)
                for k, r in req.items():
                    _max_into(required, k, r)
            if len(outs) == 1:
                return {k: v[None] for k, v in outs[0].items()}, required
            return {k: torch.stack([o[k] for o in outs])
                    for k in outs[0]}, required

        return core

    def _install_plan(self, sig, caps: Dict[str, int]) -> _Plan:
        core_key = (sig, tuple(sorted(caps.items())))
        fn = self._core_cache.get(core_key)
        if fn is None:
            fn = self._build_core(caps)
            self._core_cache[core_key] = fn
            self.stats["traces"] += 1
        plan = _Plan(caps=caps, fn=fn)
        self._plans[sig] = plan
        return plan

    def _dispatch(self, sig, stacked, rep_flat):
        """One plan-cached execution of a batch-stacked operand set; a miss
        records capacities on ``rep_flat``. Returns the keyed-COO ``out``
        as host arrays with a leading member axis."""
        if any(n > 1 for n in self.lane_ns):
            self.stats["lane_dispatches"] += 1
        plan = self._plans.get(sig)
        fresh = plan is None
        if fresh:
            self.stats["plan_misses"] += 1
            plan = self._install_plan(sig, self._record_caps([rep_flat]))
        else:
            self.stats["plan_hits"] += 1
        return _run_with_growth(
            plan, stacked, self.stats,
            lambda caps: self._install_plan(sig, caps), fresh)

    # -- output assembly ---------------------------------------------------
    def _assemble_out(self, out) -> FiberTree:
        """One member's keyed-COO ``out`` as a result ``FiberTree``."""
        if "scalar" in out:
            return FiberTree.from_dense(np.asarray(float(out["scalar"])), "")
        if self._out_merge is None:
            return coo_to_fibertree(out["keys"], out["vals"], out["valid"],
                                    self._strides, self._out_shape,
                                    self._out_fmt, self._mode_order)
        return self._assemble_unsplit(out["keys"], out["vals"], out["valid"])

    @property
    def orig_result_order(self) -> List[str]:
        """The ORIGINAL result variables in storage (loop) order — the
        column order of ``execute_coo`` coordinates."""
        if self._out_merge is not None:
            return [m[0] for m in self._out_merge]
        return list(self.rvars)

    def _live_coords(self, out) -> Tuple[np.ndarray, np.ndarray]:
        """(coords, vals) of the live result in the ORIGINAL coordinate
        space; one coordinate column per ``orig_result_order`` var (split
        result levels re-merged, padding/zeros dropped)."""
        cols, vals = decode_live_coo(out["keys"], out["vals"], out["valid"],
                                     self._strides)
        if self._out_merge is None:
            return cols, vals
        coords = np.zeros((len(cols), len(self._out_merge)), dtype=np.int64)
        for k, (v, io, ii, chunk) in enumerate(self._out_merge):
            coords[:, k] = (cols[:, io] if ii is None
                            else cols[:, io] * chunk + cols[:, ii])
        return coords, vals

    def _assemble_unsplit(self, keys, vals, valid) -> FiberTree:
        """Decode a split-space COO result back into the ORIGINAL
        coordinate space: each (vo, vi) level pair merges to vo*chunk+vi.
        Split padding carries only explicit zeros, which are filtered."""
        coords, vals = self._live_coords(
            {"keys": keys, "vals": vals, "valid": valid})
        orig_vars = self.orig_result_order
        shape = tuple(self.low.orig_dims[v] for v in orig_vars)
        lhs = self.low.orig_assign.lhs
        ft = FiberTree.from_coords(
            shape, coords, vals,
            self.fmt.of(lhs.tensor, len(orig_vars)) or "c" * len(orig_vars))
        ft.mode_order = tuple(lhs.vars.index(v) for v in orig_vars)
        return ft

    # -- public execution --------------------------------------------------
    def execute(self, arrays: Dict[str, np.ndarray]) -> FiberTree:
        """Execute one operand set through the plan cache.

        Args:
            arrays: dense numpy array per input tensor name (concordant
                fibertrees are built internally per the schedule).

        Returns:
            The result ``FiberTree`` in the ORIGINAL coordinate space
            (split levels re-merged, padding trimmed). Equivalent to
            ``eng(arrays)``.

        >>> import numpy as np
        >>> from repro_torch.core.schedule import Format, Schedule
        >>> eng = compile_expr("x(i) = B(i,j) * c(j)",
        ...                    Format({"B": "cc", "c": "c"}),
        ...                    Schedule(loop_order=("i", "j")),
        ...                    {"i": 2, "j": 3}, device="cpu")
        >>> B = np.array([[1., 0., 2.], [0., 3., 0.]])
        >>> eng.execute({"B": B, "c": np.ones(3)}).to_dense()
        array([3., 3.])
        """
        return self(arrays)

    def _shared_hints(self, raws: Sequence[Dict]) -> Dict[str, List[int]]:
        """Common bucket per compressed level: max over the operand sets,
        so every member pads to ONE input signature."""
        return {name: [
            max(_bucket(r[name]["crds"][i].shape[0]) for r in raws)
            for i in range(len(raws[0][name]["crds"]))]
            for name in raws[0]}

    def _sticky_hints(self, raws: Sequence[Dict]) -> Dict[str, List[int]]:
        """Shared hints merged with the engine's running per-level
        high-water, so the batch input signature is monotone over the
        engine's lifetime: a stream of dispatches with jittering nnz
        settles on ONE signature (and one plan) after warm-up."""
        hints = self._shared_hints(raws)
        for name, hs in hints.items():
            prev = self._hint_highwater.get(name)
            if prev is not None:
                hs = [max(a, b) for a, b in zip(hs, prev)]
                hints[name] = hs
            self._hint_highwater[name] = list(hs)
        return hints

    def _dispatch_out(self, flat, sig):
        """One single call, run as a batch of one; returns its keyed-COO
        ``out`` as host arrays."""
        self.stats["calls"] += 1
        out = self._dispatch(sig, _stack_flats([flat]), flat)
        return {k: v[0] for k, v in out.items()}

    def __call__(self, arrays: Dict[str, np.ndarray]) -> FiberTree:
        flat, sig = self._pad_flat(self._raw_flat(arrays))
        return self._assemble_out(self._dispatch_out(flat, sig))

    def execute_coo(self, arrays: Dict[str, np.ndarray], *, hints=None
                    ) -> Tuple[Optional[np.ndarray], Any]:
        """Execute one operand set, returning the live result as a COO.

        Returns ``(coords, vals)``: ``coords`` is ``(nnz, k)`` int64 in the
        ORIGINAL coordinate space, one column per ``orig_result_order``
        variable; scalar expressions return ``(None, float)``. ``hints``
        overrides the per-level input buckets (``{tensor: [bucket per
        level]}``) so related operand sets share one input signature and
        therefore one plan.
        """
        flat, sig = self._pad_flat(self._raw_flat(arrays), hints)
        out = self._dispatch_out(flat, sig)
        if "scalar" in out:
            return None, float(out["scalar"])
        return self._live_coords(out)

    def execute_many(self, arrays_list: Sequence[Dict[str, np.ndarray]]
                     ) -> List[FiberTree]:
        """Dispatch several operand sets as INDIVIDUAL calls sharing one
        input signature (buckets maxed over the set and the engine's
        high-water, as ``execute_batch`` pads), so warm traffic stays on a
        single plan."""
        if not arrays_list:
            return []
        raws = [self._raw_flat(a) for a in arrays_list]
        hints = self._sticky_hints(raws)
        out = []
        for raw in raws:
            flat, sig = self._pad_flat(raw, hints)
            out.append(self._assemble_out(self._dispatch_out(flat, sig)))
        return out

    # -- staged batch execution (host encode / device execute / host
    # decode, split so a serving pipeline can overlap the stages of
    # consecutive dispatches) ---------------------------------------------
    def encode_batch(self, arrays_list: Sequence[Dict[str, np.ndarray]]
                     ) -> EncodedBatch:
        """Host-side stage 1 of a batched dispatch: build the concordant
        fibertrees, pad every member to ONE shared input signature, and
        stack (numpy; the upload happens in ``execute_encoded``)."""
        raws = [self._raw_flat(a) for a in arrays_list]
        hints = self._sticky_hints(raws)
        # the largest member, before padding: capacity recording runs just
        # this one member eagerly, and the growth loop heals any residual
        # undershoot from the others
        rep = max(range(len(raws)),
                  key=lambda i: sum(int(e["vals"].shape[0])
                                    for e in raws[i].values()))
        flats_sigs = [self._pad_flat(r, hints) for r in raws]
        flats = [f for f, _ in flats_sigs]
        return EncodedBatch(stacked=_stack_flats(flats),
                            sig=flats_sigs[0][1], b=len(flats), flats=flats,
                            rep=rep)

    def execute_encoded(self, enc: EncodedBatch):
        """Device stage 2: one plan-cached dispatch of an encoded batch.
        The stacked operands upload once; the members run one after
        another on the plan, and their results and needed sizes reach the
        host in one transfer. Returns the keyed-COO ``out`` for
        ``decode_batch``."""
        self.stats["batch_calls"] += 1
        return self._dispatch(enc.sig, enc.stacked, enc.flats[enc.rep])

    def decode_batch(self, enc: EncodedBatch, out) -> List[FiberTree]:
        """Host-side stage 3: one ``FiberTree`` per batch member."""
        return [self._assemble_out({k: v[i] for k, v in out.items()})
                for i in range(enc.b)]

    def execute_batch(self, arrays_list: Sequence[Dict[str, np.ndarray]]
                      ) -> List[FiberTree]:
        """Execute many same-format operand sets in ONE plan-cached
        dispatch.

        Args:
            arrays_list: operand sets (each as in ``execute``); all must
                share the expression's tensor names and dims. Every
                member pads to ONE shared input signature.

        Returns:
            One result ``FiberTree`` per operand set, in order.

        >>> import numpy as np
        >>> from repro_torch.core.schedule import Format, Schedule
        >>> eng = compile_expr("x(i) = B(i,j) * c(j)",
        ...                    Format({"B": "cc", "c": "c"}),
        ...                    Schedule(loop_order=("i", "j")),
        ...                    {"i": 2, "j": 3}, device="cpu")
        >>> B = np.array([[1., 0., 2.], [0., 3., 0.]])
        >>> outs = eng.execute_batch([{"B": B, "c": np.ones(3)},
        ...                           {"B": 2 * B, "c": np.ones(3)}])
        >>> [o.to_dense().tolist() for o in outs]
        [[3.0, 3.0], [6.0, 6.0]]
        """
        if not arrays_list:
            return []
        enc = self.encode_batch(arrays_list)
        return self.decode_batch(enc, self.execute_encoded(enc))


# ---------------------------------------------------------------------------
# tiled out-of-core execution (DESIGN.md §7, docs/TILING.md)
# ---------------------------------------------------------------------------

class TiledExpr:
    """Out-of-core engine: stream coordinate-space tiles through ONE
    plan-cached per-tile engine, accumulating the partial COOs.

    The port of the reference's ``TiledExpr``. An expression whose untiled
    device allocation exceeds the memory budget executes as a grid of
    coordinate tiles (``Schedule.tile``, ``{var: n_tiles}``): every tiled
    variable's coordinate space partitions into ``n`` contiguous chunks,
    and each grid cell runs the SAME expression over zero-padded operand
    slices with the tiled extents shrunk to one chunk
    (``tiling.slice_operands``). Every tile shares the expression,
    formats, schedule and (padded) extents, so all tiles resolve to ONE
    process-wide ``CompiledExpr``, and the shared input buckets
    (``_measure_hints``) put every tile on ONE input signature: the first
    tile records capacities and builds the plan, every later tile hits
    it. Tile partials merge through ``coord_ops.accumulate_coo`` (one
    ``keyed_union_reduce`` a tile on ``device``; on the GPU the
    ``scatter_workspace`` kernel for a result key space up to
    ``DENSE_REDUCE_BOUND``, else the sort-merge on ``segment_reduce``):
    contraction-tiled partials overlap (reduce-merge), result-tiled
    partials are disjoint (concat-merge). The running result lives on the
    host; one tile's working set is on the device at a time.

    Under a budget, each tile runs in ``pieces`` (``core/pieces.py``): the
    tile's schedule with its outermost loop variable parallelized into
    that many lanes, which the engine runs one after another on its one
    plan, so the port's streams (more bytes an element than the
    reference's estimate counts) keep the budget the plan was made for.
    The plan (``tile_of``, ``n_tiles``, ``tile_bytes``) stays the
    reference's.

    Built by ``compile_expr`` whenever the schedule carries ``tile`` or a
    ``mem_budget`` forces one; quacks like ``CompiledExpr`` for the
    serving paths (``__call__``/``execute``/``execute_batch``/
    ``execute_many``/``stats``, and the ``low``/``par_n`` facets).
    """

    def __init__(self, expr, fmt: Format, schedule: Schedule,
                 dims: Dict[str, int], *, use_kernels: bool = True,
                 device=None, shard_lanes: Optional[bool] = None,
                 mem_budget: Optional[int] = None,
                 densities: Optional[Dict[str, float]] = None):
        self.device = co.resolve_device(device)
        self.assign: Assignment = (parse(expr) if isinstance(expr, str)
                                   else expr)
        self.fmt = fmt
        self.schedule = schedule
        self.dims = dict(dims)
        tile = tiling.normalize_tile(schedule)
        tiling.check_tile(self.assign, tile, schedule=schedule)
        for v, n in tile.items():
            if n > dims[v]:
                raise ValueError(f"tile {v}:{n} exceeds its extent "
                                 f"{dims[v]}")
        self.tile_of = tile
        self.n_tiles = tiling.n_tiles(tile)
        self.inner_dims = tiling.tile_extents(self.dims, tile)
        inner = dataclasses.replace(schedule, tile={})
        self.mem_budget = (None if mem_budget is None
                           else tiling.parse_budget(mem_budget))
        self.tile_bytes = tiling.estimate_call_bytes(
            self.assign, fmt, inner, self.inner_dims, densities=densities)
        if self.mem_budget is not None and self.tile_bytes > self.mem_budget:
            raise tiling.MemoryBudgetExceeded(
                f"one tile of tile={tile} still needs "
                f"~{tiling.format_bytes(self.tile_bytes)} > budget "
                f"{tiling.format_bytes(self.mem_budget)}; tile finer",
                estimate=self.tile_bytes, budget=self.mem_budget)
        # each tile runs in as many pieces (lanes over its outermost loop
        # variable) as the port's bytes a stream element need to keep the
        # budget; decided here, before any tile reaches the device
        self.pieces = pieces.tile_pieces(self.assign, fmt, inner,
                                         self.inner_dims, self.mem_budget,
                                         densities=densities)
        # ONE engine for every tile: identical expression/format/schedule/
        # extents/device => the process-wide cached CompiledExpr, whose
        # plan cache all tiles share
        self.engine = compile_expr(self.assign, fmt,
                                   pieces.piece_schedule(inner, self.pieces),
                                   self.inner_dims, use_kernels=use_kernels,
                                   device=self.device,
                                   shard_lanes=shard_lanes)
        # the tile merge: the same dispatch entry as the engine's
        # lane/term merge
        self._union_reduce = (kops.sam_primitive("keyed_union_reduce",
                                                 self.device)
                              if use_kernels else None)
        self.rvars = self.engine.orig_result_order   # orig vars, loop order
        self._scalar = not self.rvars
        self._out_strides = [(v, self.dims[v]) for v in self.rvars]
        bound = 1
        for _, d in self._out_strides:
            bound *= d
        self._key_bound = bound if bound <= co.DENSE_REDUCE_BOUND else None
        # running max input bucket per (tensor, level) across tiles, so
        # EVERY tile pads to one shared signature and hits one plan
        self._hints: Dict[str, List[int]] = {}
        self.stats = {"calls": 0, "tile_calls": 0, "tiles": self.n_tiles,
                      "batch_calls": 0}

    # engine facets the serving paths read ------------------------------
    @property
    def low(self):
        return self.engine.low

    @property
    def par_n(self) -> int:
        """The schedule's lanes (a tile's pieces are not among them)."""
        return 1 if self.pieces > 1 else self.engine.par_n

    # -- execution -------------------------------------------------------
    def _global_keys(self, coords: np.ndarray,
                     tids: Dict[str, int]) -> np.ndarray:
        """Shift a tile's result coordinates by its offsets and flatten
        into int64 keys over the FULL result extents."""
        keys = np.zeros(len(coords), dtype=np.int64)
        for col, (v, dim) in enumerate(self._out_strides):
            c = coords[:, col]
            if v in self.tile_of:
                c = c + tids[v] * self.inner_dims[v]
            keys = keys * dim + c
        return keys

    def _measure_hints(self, arrays: Dict[str, np.ndarray]) -> None:
        """Grow the shared per-level input buckets to cover every tile of
        this operand set. Host-side only (fibertrees, no device tensors):
        one extra walk over the operands keeps all tiles on ONE input
        signature, so the first tile builds the plan and the rest hit it.
        Building every tile's padded operands at once instead would hold
        them all, which is the allocation the budget forbids; here at most
        one tile is on the device at a time, and the hints persist across
        calls. Levels are read as the engine ingests them (``s``/``h``/
        ``m`` storage canonicalized to ``c``)."""
        for tids in tiling.tile_grid(self.tile_of):
            sliced = tiling.slice_operands(self.assign, arrays, self.dims,
                                           self.tile_of, tids)
            for name, ft in self.engine.low.build_inputs(sliced).items():
                ft = _engine_tree(ft)
                cur = self._hints.setdefault(name, [0] * len(ft.levels))
                for i, lv in enumerate(ft.levels):
                    if lv.format == COMPRESSED:
                        cur[i] = max(cur[i], _bucket(len(lv.crd)))

    def _finalize(self, acc_k: np.ndarray, acc_v: np.ndarray,
                  total: float) -> FiberTree:
        """Assemble the merged tile partials (the accumulated COO, or the
        running scalar ``total``) into the result ``FiberTree`` in the
        ORIGINAL coordinate space, exactly as the untiled ``CompiledExpr``
        returns it."""
        if self._scalar:
            return FiberTree.from_dense(np.asarray(float(total)), "")
        # coo_to_fibertree also drops zeros (cancelled partial sums)
        lhs = self.assign.lhs
        return coo_to_fibertree(
            acc_k, acc_v, np.ones(len(acc_k), bool), self._out_strides,
            tuple(self.dims[v] for v in self.rvars),
            self.fmt.of(lhs.tensor, len(self.rvars))
            or "c" * len(self.rvars),
            tuple(lhs.vars.index(v) for v in self.rvars))

    def __call__(self, arrays: Dict[str, np.ndarray]) -> FiberTree:
        """Execute one operand set tile by tile; returns the result
        ``FiberTree`` in the ORIGINAL coordinate space, exactly as the
        untiled ``CompiledExpr`` would."""
        self.stats["calls"] += 1
        self._measure_hints(arrays)
        total = 0.0
        acc_k = np.zeros(0, np.int64)
        acc_v = np.zeros(0, np.float32)
        for tids in tiling.tile_grid(self.tile_of):
            sliced = tiling.slice_operands(self.assign, arrays, self.dims,
                                           self.tile_of, tids)
            coords, vals = self.engine.execute_coo(sliced,
                                                   hints=self._hints)
            self.stats["tile_calls"] += 1
            if coords is None:                       # scalar partial
                total += vals
                continue
            acc_k, acc_v = co.accumulate_coo(
                acc_k, acc_v, self._global_keys(coords, tids), vals,
                key_bound=self._key_bound,
                union_reduce_impl=self._union_reduce, device=self.device)
        return self._finalize(acc_k, acc_v, total)

    def execute(self, arrays: Dict[str, np.ndarray]) -> FiberTree:
        """Alias of ``__call__`` (API parity with ``CompiledExpr``)."""
        return self(arrays)

    def execute_batch(self, arrays_list: Sequence[Dict[str, np.ndarray]]
                      ) -> List[FiberTree]:
        """Requests execute one after another: under a memory budget the
        tile stream IS the batching axis (each tile still reuses the
        shared per-tile plan, so warm requests never rebuild it)."""
        self.stats["batch_calls"] += 1
        return [self(a) for a in arrays_list]

    execute_many = execute_batch


_TILED: Dict[Tuple, TiledExpr] = {}


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def compile_expr(expr, fmt: Format, schedule, dims: Dict[str, int], *,
                 use_kernels: bool = True, device=None,
                 shard_lanes: Optional[bool] = None, sparsity=None,
                 mem_budget=None, auto_tile: bool = True
                 ) -> "CompiledExpr | TiledExpr | BsrEngine":
    """Compile an expression once into a plan-cached engine.

    Args:
        expr: tensor index notation text or a parsed ``Assignment``.
        fmt: per-tensor level formats.
        schedule: a ``Schedule``, or ``"auto"`` to resolve one through the
            autoscheduler + the persistent on-disk schedule cache (keyed
            by expression + format + dims bucket + sparsity bucket, so a
            shape is searched at most once per cache; DESIGN.md §5).
        dims: extent of every index variable.
        use_kernels: route the hot primitives through the
            ``kernels/ops`` dispatch table (the CUDA kernels on a GPU).
        device: where the engine runs; CUDA by default, and an error when
            there is no GPU (pass ``device="cpu"`` for the CPU).
        shard_lanes: §4.4 lane placement. None or False runs every lane
            of a ``parallelize`` schedule on ``device``; True (or an int
            device bound) requires a mesh of GPUs: ``ValueError`` when
            none fits, ``NotImplementedError`` where one would (lanes over
            GPUs belong to the distributed slice).
        sparsity: density hint for ``schedule="auto"`` and the memory
            estimator (float or per-tensor dict; defaults to
            ``autoschedule.DEFAULT_SPARSITY``).
        mem_budget: peak-device-allocation budget in bytes (int or a
            string like ``"64MB"``). A schedule whose untiled estimate
            (``tiling.estimate_call_bytes``) exceeds it is routed through
            the out-of-core ``TiledExpr`` engine (``auto_tile=True``, the
            default) or refused with ``tiling.MemoryBudgetExceeded``
            (``auto_tile=False``); ``schedule="auto"`` additionally bounds
            the schedule search with the budget (DESIGN.md §7,
            docs/TILING.md).
        auto_tile: set False to refuse over-budget expressions instead
            of tiling them.

    Returns:
        The process-wide engine for this configuration: a
        ``CompiledExpr``, or a ``TiledExpr`` when the schedule carries
        ``tile`` (explicitly or via the budget). Repeated calls with the
        same (expression, formats, schedule, dims, use_kernels, device)
        return the SAME engine, so its plans are shared; a tiled engine
        is also keyed by the budget and the density hint. The schedule's
        split/parallelize/tile spec is part of the key. A block-sparse
        contraction that ``bsr_pattern`` recognizes gets a ``BsrEngine``,
        shared by (expression, formats, schedule, dims, device).

    >>> import numpy as np
    >>> from repro_torch.core.schedule import Format, Schedule
    >>> eng = compile_expr("x(i) = B(i,j) * c(j)",
    ...                    Format({"B": "cc", "c": "c"}),
    ...                    Schedule(loop_order=("i", "j")), {"i": 2, "j": 3},
    ...                    device="cpu")
    >>> eng({"B": np.eye(2, 3), "c": np.ones(3)}).to_dense()
    array([1., 1.])

    A tiled schedule streams out-of-core with identical results:

    >>> tiled = compile_expr("x(i) = B(i,j) * c(j)",
    ...                      Format({"B": "cc", "c": "c"}),
    ...                      Schedule(loop_order=("i", "j"),
    ...                               tile={"j": 3}), {"i": 2, "j": 3},
    ...                      device="cpu")
    >>> tiled.n_tiles, tiled({"B": np.eye(2, 3), "c": np.ones(3)}).to_dense()
    (3, array([1., 1.]))
    """
    if mem_budget is not None:
        mem_budget = tiling.parse_budget(mem_budget)
    if isinstance(schedule, str):
        if schedule != "auto":
            raise ValueError(
                f"schedule must be a Schedule or 'auto', got {schedule!r}")
        from .autoschedule import resolve_schedule
        # the search ranks under the parallelism this engine will run.
        # With shard_lanes None or False the port runs every lane on one
        # device (_check_shard_lanes), so it searches for one device; the
        # reference passes None there, its host's device count, which is 1
        # on the CPU and on a one-GPU machine too. True or an int asks for
        # a mesh, as in the reference (and is refused below)
        if shard_lanes is None or shard_lanes is False:
            n_dev = 1
        elif shard_lanes is True:
            n_dev = None                     # the host's CUDA devices
        else:
            n_dev = int(shard_lanes)
        # auto_tile=False means "refuse rather than tile": keep the budget
        # OUT of the search (a budgeted search returns tiled schedules) so
        # the refusal gate below sees an untiled winner
        kw = ({} if mem_budget is None or not auto_tile
              else {"mem_budget": mem_budget})
        schedule = resolve_schedule(expr, fmt, dims, sparsity=sparsity,
                                    device_count=n_dev, **kw).schedule
    dev = co.resolve_device(device)
    assign = parse(expr) if isinstance(expr, str) else expr

    # recognized block-sparse contractions run on the BSR kernels end to
    # end instead of the streaming engine (core/bsr_bridge.py); the engine
    # ignores use_kernels, as the reference's does
    pat = bsr_pattern(assign, fmt)
    if pat is not None:
        bkey = (expr_cache_key(assign, fmt, schedule, dims), str(dev))
        beng = _BSR.get(bkey)
        if beng is None:
            beng = BsrEngine(assign, fmt, dims, pat, device=dev)
            _BSR[bkey] = beng
        return beng

    # resolved before keying, so a refused lane placement never returns a
    # cached engine
    par_n = max([n for n in schedule.parallelize.values() if n > 1],
                default=1)
    _check_shard_lanes(shard_lanes, par_n)

    # -- memory-budget gate + tiled routing (DESIGN.md §7) ----------------
    if mem_budget is not None or schedule.tile:
        densities = None
        if sparsity is not None:
            from .autoschedule import resolve_densities
            densities = resolve_densities(assign, sparsity)
        if mem_budget is not None and not schedule.tile:
            if not auto_tile:
                # refuse over-budget untiled requests loudly
                tiling.require_budget(assign, fmt, schedule, dims,
                                      mem_budget, densities=densities)
            else:
                plan = tiling.resolve_plan(assign, fmt, schedule, dims,
                                           mem_budget, densities=densities)
                if plan.tile:
                    schedule = dataclasses.replace(schedule,
                                                   tile=dict(plan.tile))
        if schedule.tile:
            # densities steer the per-tile budget check, so they partition
            # the tiled-engine cache
            tkey = (expr_cache_key(assign, fmt, schedule, dims),
                    use_kernels, str(dev), mem_budget,
                    tuple(sorted(densities.items())) if densities
                    else None)
            teng = _TILED.get(tkey)
            if teng is None:
                teng = TiledExpr(assign, fmt, schedule, dims,
                                 use_kernels=use_kernels, device=dev,
                                 shard_lanes=shard_lanes,
                                 mem_budget=mem_budget, densities=densities)
                _TILED[tkey] = teng
            return teng

    key = (expr_cache_key(assign, fmt, schedule, dims), use_kernels, str(dev))
    eng = _COMPILED.get(key)
    if eng is None:
        eng = CompiledExpr(assign, fmt, schedule, dims,
                           use_kernels=use_kernels, device=dev)
        _COMPILED[key] = eng
    return eng


def clear_compile_cache() -> None:
    _COMPILED.clear()
    _TILED.clear()
    _BSR.clear()


def execute_graph(graph_: g.Graph, tensors: Dict[str, FiberTree],
                  dims: Dict[str, int], result_vars: List[str], *,
                  device=None) -> Dict[str, FiberTree]:
    """Eager execution of one SAM graph over operand FiberTrees (``s``,
    ``h`` and ``m`` storage canonicalizes at ingest). On a GPU its reduces
    run through the dispatch table's kernels."""
    dev = co.resolve_device(device)
    jt = {k: JTensor.from_fibertree(v, dev) for k, v in tensors.items()}
    return TorchBackend(
        graph_, jt, dims, list(result_vars), device=dev,
        segsum=kops.sam_primitive("keyed_segment_sum", dev),
        intersect=kops.sam_primitive("sorted_intersect", dev),
        mul_reduce=kops.sam_primitive("mul_reduce", dev)).run()


def execute_expr(expr: str, fmt: Format, schedule: Schedule,
                 arrays: Dict[str, np.ndarray], dims: Dict[str, int],
                 compiled: bool = True, *, device=None) -> FiberTree:
    """Execute an expression via the compiled engine (plan-cached, fused
    multi-term). Falls back to the eager per-term path when the compiled
    engine does not support the configuration."""
    if compiled:
        try:
            return compile_expr(expr, fmt, schedule, dims,
                                device=device)(arrays)
        except NotImplementedError:
            pass
    # the eager path has no capacities to bound, so a tile spec is moot
    if schedule.tile:
        schedule = dataclasses.replace(schedule, tile={})
    low = lower(expr, fmt, schedule, dims)
    tensors = low.build_inputs(arrays)
    rvars = low.result_vars
    total: Optional[np.ndarray] = None
    for t in low.require_terms():
        res = execute_graph(t.graph, tensors, low.dims, rvars, device=device)
        dense = res[low.assign.lhs.tensor].to_dense()
        total = t.sign * dense if total is None else total + t.sign * dense
    total = low.unsplit(total)
    out_fmt = fmt.of(low.orig_assign.lhs.tensor,
                     len(low.orig_assign.lhs.vars))
    return FiberTree.from_dense(np.asarray(total), out_fmt or "")


# ---------------------------------------------------------------------------
# compiled programs: fused producer→consumer cascades (DESIGN.md §6)
# ---------------------------------------------------------------------------

class _FusedChain:
    """One fused pipeline run as ONE plan-cached callable.

    The stages (program order; the last one is the chain's sink) execute
    back to back on ``device``: each fused intermediate's keyed COO result
    converts to on-device ``(seg, crd)`` level tensors (the
    ``coo_to_levels`` entry) that the next stage's level scanners read
    directly — the intermediate never round-trips through a host
    ``FiberTree``. Capacities (scan streams, stage outputs, intermediate
    levels) are recorded eagerly on first call, bucketed, and grown on
    overflow exactly like ``CompiledExpr``; the intermediate levels' live
    counts join the one host transfer of needed sizes per run.
    """

    def __init__(self, stages, *, device, segsum=None, intersect=None,
                 coo_levels=None):
        self.stages = stages
        self.device = torch.device(device)
        self.names = [s.name for s in stages]
        fused = {t for s in stages for t in s.fused_inputs}
        self.graphs = [s.lowered.graph for s in stages]
        self.signs = [s.lowered.terms[0].sign for s in stages]
        self._segsum = segsum
        self._intersect = intersect
        self._coo_levels = coo_levels or co.coo_to_levels
        # external accesses per stage (everything not spliced), and the
        # sub-assignment used to build their concordant fibertrees
        self._ext: List[Tuple] = []
        for s in stages:
            accs, seen = [], set()
            for t in s.lowered.assign.terms:
                for f in t.factors:
                    if f.tensor not in fused and f.tensor not in seen:
                        accs.append(f)
                        seen.add(f.tensor)
            self._ext.append((tuple(accs),
                              Assignment(lhs=s.lowered.assign.lhs,
                                         terms=(Term(1, tuple(accs)),))))
        # fused intermediates' level extents (producer storage order)
        self._inter_dims = {
            s.name: [s.lowered.dims[v] for v in s.lowered.result_vars]
            for s in stages if s.fused_output}
        final = stages[-1]
        self._final_rvars = final.lowered.result_vars
        self._scalar = not self._final_rvars
        writer = _val_writer_node(self.graphs[-1])
        self._out_shape = writer.params.get("shape", ())
        self._out_fmt = (writer.params.get("format")
                         or "c" * len(self._final_rvars))
        self._mode_order = writer.params.get("mode_order")
        self._strides = [(v, final.lowered.dims[v])
                         for v in self._final_rvars]
        self._level_meta: Dict[str, List[Tuple[str, int]]] = {}
        self._plans: Dict[Tuple, _Plan] = {}
        self._core_cache: Dict[Tuple, Callable] = {}
        self.stats = {"traces": 0, "plan_hits": 0, "plan_misses": 0,
                      "overflow_retries": 0, "calls": 0}

    # -- operand flattening ------------------------------------------------
    def _raw_flat(self, env: Dict[str, np.ndarray]) -> Dict[str, Any]:
        raw = {}
        for i, stg in enumerate(self.stages):
            accs, sub = self._ext[i]
            fts = build_inputs(sub, stg.lowered.fmt, stg.lowered.schedule,
                               {a.tensor: env[a.tensor] for a in accs})
            for name, ft in fts.items():
                key = f"s{i}.{name}"
                ft = _engine_tree(ft)
                self._level_meta.setdefault(
                    key, [(lv.format, lv.dim) for lv in ft.levels])
                raw[key] = _raw_flat_of(ft)
        return raw

    def _stage_tensors(self, flat, i: int, inter: Dict[str, JTensor]
                       ) -> Dict[str, JTensor]:
        accs, _ = self._ext[i]
        sub = {f"s{i}.{a.tensor}": flat[f"s{i}.{a.tensor}"] for a in accs}
        tensors = {k.split(".", 1)[1]: v for k, v in
                   _tensors_from_flat_arrays(sub, self._level_meta,
                                             self.device).items()}
        for t in self.stages[i].fused_inputs:
            tensors[t] = inter[t]
        return tensors

    def _backend(self, i: int, tensors, **caps) -> TorchBackend:
        stg = self.stages[i]
        return TorchBackend(self.graphs[i], tensors, stg.lowered.dims,
                            stg.lowered.result_vars, device=self.device,
                            segsum=self._segsum, intersect=self._intersect,
                            **caps)

    # -- the COO -> levels splice ------------------------------------------
    def _jt_from_coo(self, coo: COOResult, sign: int, level_caps
                     ) -> Tuple[JTensor, List]:
        dims_list = [d for _, d in coo.strides]
        segs, crds, counts = self._coo_levels(coo.keys, coo.valid,
                                              dims_list, level_caps)
        cap_in = level_caps[-1]
        vals = coo.vals if sign == 1 else sign * coo.vals
        if vals.shape[0] >= cap_in:
            vals = vals[:cap_in]
        else:
            vals = torch.cat([vals, vals.new_zeros(cap_in - vals.shape[0])])
        levels = [JLevel(seg, crd, d)
                  for seg, crd, d in zip(segs, crds, dims_list)]
        return JTensor(levels, vals), counts

    # -- capacity recording ------------------------------------------------
    def _record_caps(self, flat) -> Dict[str, int]:
        """Eager capacity-recording pass over one padded operand set,
        through the same dispatch entries as the plans."""
        caps: Dict[str, int] = {}
        inter: Dict[str, JTensor] = {}
        for i, stg in enumerate(self.stages):
            be = self._backend(i, self._stage_tensors(flat, i, inter))
            v = be.run_streams()
            for k, n in be.caps_record.items():
                caps[f"s{i}.{k}"] = _bucket_cap(n)
            if not stg.fused_output:
                continue
            keys = v.keys[v.valid].cpu().numpy()
            dims_list = [d for _, d in v.strides]
            cnts: List[int] = []
            p = keys
            for l in range(len(dims_list) - 1, -1, -1):
                cnts.insert(0, len(np.unique(p)))
                p = p // dims_list[l]
            level_caps = [_bucket_cap(c) for c in cnts]
            for l, c in enumerate(level_caps):
                caps[f"s{i}.lv{l}"] = c
            inter[stg.name], _ = self._jt_from_coo(v, self.signs[i],
                                                   level_caps)
        return caps

    # -- the cascade ---------------------------------------------------------
    def _build_core(self, caps: Dict[str, int]) -> Callable:
        scan_caps = [
            {n.id: caps[f"s{i}.s{n.id}"] for n in G.of_kind(g.LEVEL_SCAN)}
            for i, G in enumerate(self.graphs)]
        out_caps = [caps.get(f"s{i}.out") for i in range(len(self.graphs))]
        level_caps = {
            s.name: [caps[f"s{i}.lv{l}"]
                     for l in range(len(self._inter_dims[s.name]))]
            for i, s in enumerate(self.stages) if s.fused_output}

        def core(flat):
            required: Dict[str, torch.Tensor] = {}
            inter: Dict[str, JTensor] = {}
            v = None
            for i, stg in enumerate(self.stages):
                be = self._backend(i, self._stage_tensors(flat, i, inter),
                                   scan_caps=scan_caps[i],
                                   out_cap=out_caps[i])
                v = be.run_streams()
                for k, r in be.required.items():
                    required[f"s{i}.{k}"] = r
                if stg.fused_output:
                    jt, counts = self._jt_from_coo(
                        v, self.signs[i], level_caps[stg.name])
                    for l, c in enumerate(counts):
                        required[f"s{i}.lv{l}"] = c
                    inter[stg.name] = jt
            sign = self.signs[-1]
            if self._scalar:
                return {"scalar": sign * v}, required
            vals = v.vals if sign == 1 else sign * v.vals
            return {"keys": v.keys, "vals": vals, "valid": v.valid}, required

        return core

    def _install_plan(self, sig, caps: Dict[str, int]) -> _Plan:
        core_key = (sig, tuple(sorted(caps.items())))
        fn = self._core_cache.get(core_key)
        if fn is None:
            fn = self._build_core(caps)
            self._core_cache[core_key] = fn
            self.stats["traces"] += 1
        plan = _Plan(caps=caps, fn=fn)
        self._plans[sig] = plan
        return plan

    def _run_plan(self, plan: _Plan, sig, flat, fresh: bool):
        return _run_with_growth(plan, flat, self.stats,
                                lambda caps: self._install_plan(sig, caps),
                                fresh)

    # -- public --------------------------------------------------------------
    def execute(self, env: Dict[str, np.ndarray]) -> FiberTree:
        self.stats["calls"] += 1
        flat, sig = _pad_flat_arrays(self._raw_flat(env), self._level_meta)
        plan = self._plans.get(sig)
        fresh = plan is None
        if fresh:
            self.stats["plan_misses"] += 1
            plan = self._install_plan(sig, self._record_caps(flat))
        else:
            self.stats["plan_hits"] += 1
        out = self._run_plan(plan, sig, flat, fresh)
        if "scalar" in out:
            return FiberTree.from_dense(np.asarray(float(out["scalar"])), "")
        return coo_to_fibertree(out["keys"], out["vals"], out["valid"],
                                self._strides, self._out_shape,
                                self._out_fmt, self._mode_order)


class CompiledProgram:
    """A multi-assignment program compiled into executable units.

    Fused pipelines (``LoweredProgram.components`` with >1 stage) become
    one ``_FusedChain`` — one plan-cached callable, intermediates living
    on ``device``. Every other stage runs through its own process-wide
    engine from ``compile_expr`` (a ``CompiledExpr``, or a ``TiledExpr``
    when a memory budget tiles it), with dense materialization between
    units.

    Calling the program returns one ``FiberTree`` per MATERIALIZED stage
    output; fused-away intermediates are never built and do not appear.
    """

    def __init__(self, lp, *, use_kernels: bool = True, device=None,
                 mem_budget=None, sparsity=None):
        self.device = co.resolve_device(device)
        self.lp = lp
        self.cache_key = program_cache_key(lp)
        self.mem_budget = mem_budget
        segsum = intersect = coo_levels = None
        if use_kernels:
            segsum = kops.sam_primitive("keyed_segment_sum", self.device)
            intersect = kops.sam_primitive("sorted_intersect", self.device)
            coo_levels = kops.sam_primitive("coo_to_levels", self.device)
        self.units: List[Tuple[str, List[int], Any]] = []
        for comp in lp.components():
            if len(comp) == 1:
                # a memory budget routes over-sized stages through the
                # tiled engine; fused chains keep their own working sets
                # (tiling a stage forbids fusing it, docs/TILING.md)
                stg = lp.stages[comp[0]]
                eng = compile_expr(stg.assign, lp.fmt, stg.schedule,
                                   stg.dims, use_kernels=use_kernels,
                                   device=self.device, mem_budget=mem_budget,
                                   sparsity=sparsity)
                self.units.append(("expr", comp, eng))
            else:
                chain = _FusedChain([lp.stages[i] for i in comp],
                                    device=self.device, segsum=segsum,
                                    intersect=intersect,
                                    coo_levels=coo_levels)
                self.units.append(("chain", comp, chain))
        self.stats = {
            "calls": 0,
            "fused_stages": sum(len(c) for k, c, _ in self.units
                                if k == "chain"),
            "fused_intermediates": len(lp.fused_tensors),
            "materialized_handoffs": len(
                [d for d in lp.decisions if not d.fused]),
        }

    @property
    def decisions(self):
        return self.lp.decisions

    @property
    def inputs(self) -> Tuple[str, ...]:
        return self.lp.program.inputs

    def execute(self, arrays: Dict[str, np.ndarray]) -> Dict[str, FiberTree]:
        """Run the program; returns ``{lhs tensor: FiberTree}`` for every
        stage whose result materializes (fused intermediates excluded)."""
        return self(arrays)

    def __call__(self, arrays: Dict[str, np.ndarray]
                 ) -> Dict[str, FiberTree]:
        self.stats["calls"] += 1
        env = {k: np.asarray(v, dtype=float) for k, v in arrays.items()}
        results: Dict[str, FiberTree] = {}
        for kind, comp, unit in self.units:
            if kind == "expr":
                stg = self.lp.stages[comp[0]]
                ft = unit({t: env[t]
                           for t in stg.lowered.orig_assign.input_tensors})
                name = stg.name
            else:
                ft = unit.execute(env)
                name = unit.names[-1]
            results[name] = ft
            if self.lp.program.consumers(name):
                env[name] = ft.to_dense()   # materialized handoff
        return results


_COMPILED_PROGRAMS: Dict[Tuple, CompiledProgram] = {}


def compile_program(program, fmt: Format, schedules, dims: Dict[str, int],
                    *, use_kernels: bool = True, sparsity=None,
                    fuse: bool = True, mem_budget=None, device=None
                    ) -> CompiledProgram:
    """Compile a multi-assignment program once; plan-cached per cascade.

    Args:
        program: program text (``;``/newline-separated assignments), a
            ``program.Program``, or a sequence of assignments.
        fmt: per-tensor formats, intermediates included.
        schedules: ``"auto"`` (each stage resolved through the
            autoscheduler + persistent schedule cache), a dict keyed by
            stage lhs tensor, or a sequence aligned with the stages.
        dims: extent of every index variable used by any stage.
        use_kernels: route the hot primitives (the chain's segment sums
            and ``coo_to_levels``, every unit's reduces) through the
            ``kernels/ops`` dispatch table (the CUDA kernels on a GPU).
        sparsity: density hint for ``schedules="auto"`` and, with a
            budget, the per-stage memory estimates.
        fuse: set False to force materialization between all stages (the
            unfused comparison baseline).
        mem_budget: peak-device-allocation budget in bytes (int or
            ``"64MB"``-style string); unfused stages whose untiled
            estimate exceeds it execute through a ``TiledExpr``
            (docs/TILING.md). Fused chains are not tiled: pass
            ``fuse=False`` with a budget for a fully tiled program.
        device: where the program runs; CUDA by default, and an error when
            there is no GPU (pass ``device="cpu"`` for the CPU).

    Returns:
        The process-wide ``CompiledProgram`` for this configuration: the
        key is the per-stage canonical expression keys PLUS the fusion
        plan (DESIGN.md §6), ``use_kernels``, ``device``, the budget and,
        when a budget is set, the density hint, so a fused and an unfused
        build of the same program are distinct engines.

    >>> import numpy as np
    >>> from repro_torch.core.schedule import Format, Schedule
    >>> cp = compile_program(
    ...     "T(i,k) = B(i,j) * C(j,k); x(i) = T(i,k) * d(k)",
    ...     Format(default="c"),
    ...     {"T": Schedule(loop_order=("i", "j", "k")),
    ...      "x": Schedule(loop_order=("i", "k"))},
    ...     {"i": 2, "j": 2, "k": 2}, device="cpu")
    >>> out = cp({"B": np.eye(2), "C": np.eye(2), "d": np.ones(2)})
    >>> sorted(out), out["x"].to_dense().tolist()
    (['x'], [1.0, 1.0])
    """
    if mem_budget is not None:
        mem_budget = tiling.parse_budget(mem_budget)
    dev = co.resolve_device(device)
    lp = lower_program(program, fmt, schedules, dims, sparsity=sparsity,
                       fuse=fuse)
    # with a budget, the sparsity hint steers the per-stage tiling
    # decision, so it joins the key (without one it only feeds "auto"
    # resolution, which the program key already reflects); canonicalized
    # so dict order and numpy scalars cannot split the cache
    if mem_budget is None or sparsity is None:
        skey = None
    elif isinstance(sparsity, dict):
        skey = tuple(sorted((k, float(v)) for k, v in sparsity.items()))
    else:
        skey = float(sparsity)
    key = (program_cache_key(lp), use_kernels, str(dev), mem_budget, skey)
    hit = _COMPILED_PROGRAMS.get(key)
    if hit is None:
        hit = CompiledProgram(lp, use_kernels=use_kernels, device=dev,
                              mem_budget=mem_budget, sparsity=sparsity)
        _COMPILED_PROGRAMS[key] = hit
    return hit


def clear_program_cache() -> None:
    _COMPILED_PROGRAMS.clear()
