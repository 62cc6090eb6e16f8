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
  The sizes each stream really needed come back to the host in ONE
  transfer per run, and a capacity overflow grows the plan and re-runs.

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

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP.md slice: ``split``/``parallelize`` lanes and batches, tiles and
``mem_budget``, and ``schedule="auto"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from . import coord_ops as co
from . import graph as g
from .bsr_bridge import BsrEngine, bsr_pattern
from .custard import expr_cache_key, lower
from .einsum import Assignment, Term, parse
from .fibertree import BITVECTOR, COMPRESSED, DENSE, FiberTree, canonical_tree
from .program import lower_program, program_cache_key
from .schedule import Format, Schedule, build_inputs

PAD = co.PAD_KEY

# what each unported path waits for: its entry in ROADMAP.md's list of
# what is still to port
_LANES_SLICE = "ROADMAP.md, still to port #1: split, lanes and batches"
_AUTO_SLICE = ("ROADMAP.md, still to port #2: `auto` with simulator and "
               "autoschedule")
_TILES_SLICE = "ROADMAP.md, still to port #3: tiles"


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
                base = pk[co._clip(self.parent_idx, 0, pk.shape[0] - 1)]
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
    vals: torch.Tensor
    valid: torch.Tensor
    # provenance of a multiply: ``(a_vals, b_vals)`` with
    # ``vals == a_vals * b_vals``; lets the final collapse hand the
    # un-multiplied streams to the fused multiply-reduce kernel
    pair: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


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
                 mul_reduce: Optional[Callable] = None):
        self.g = graph_
        self.t = tensors
        self.dims = dims
        self.result_vars = result_vars
        self.device = torch.device(device)
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
        cs = CanonStream(var=node.params["var"], crd=crd, parent_idx=sid,
                         valid=valid, dim=lv.dim, parent=r.stream)
        out = {"crd": cs, "ref": RefStream(cs, ref, valid)}
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

    def _repeat(self, node, ins):
        r: RefStream = ins["ref"]
        cs: CanonStream = ins["crd"]
        if r.stream is None:
            ref = r.ref[0].expand(cs.crd.shape)
            ok = r.valid[0].expand(cs.crd.shape) & cs.valid
        else:
            ref = r.ref[cs.parent_idx]
            ok = r.valid[cs.parent_idx] & cs.valid
        return {"ref": RefStream(cs, ref, ok)}

    def _array(self, node, ins):
        t = self.t[node.params["tensor"]]
        r: RefStream = ins["ref"]
        if t.vals.shape[0] == 0:   # tensor with no stored values
            vals = torch.zeros(r.ref.shape, dtype=torch.float32,
                               device=self.device)
            return {"val": ValStream(r.stream, vals, r.valid)}
        idx = co._clip(r.ref, 0, t.vals.shape[0] - 1)
        vals = torch.where(r.valid, t.vals[idx], 0.0)
        return {"val": ValStream(r.stream, vals, r.valid)}

    def _alu(self, node, ins):
        a: ValStream = ins["a"]
        b: ValStream = ins["b"]
        op = node.params["op"]
        f = {"mul": torch.mul, "add": torch.add, "sub": torch.sub}[op]
        if a.vals.shape != b.vals.shape:
            raise ValueError("ALU operands misaligned in PyTorch backend")
        pair = (a.vals, b.vals) if op == "mul" else None
        return {"val": ValStream(a.stream, f(a.vals, b.vals),
                                 a.valid | b.valid, pair=pair)}

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
        key = torch.zeros(cs.size, dtype=torch.int64, device=self.device)
        mult = 1
        idx = torch.arange(cs.size, device=self.device)
        valid = v.valid & cs.valid
        for s in chain:
            if s.var in self.result_vars:
                key = key + s.crd[idx].to(torch.int64) * mult
                strides.append((s.var, self.dims[s.var]))
                mult *= self.dims[s.var]
            valid = valid & s.valid[idx]
            if s.parent is not None:
                idx = s.parent_idx[idx]
        strides.reverse()                # outer -> inner
        if self.out_cap is None:
            need = int(torch.sum(valid))
            cap = self._cap(need)
            self.caps_record["out"] = need
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
        if self.out_cap is not None:
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
        for node in self.g.topo_order():
            outs = handlers[node.kind](node, self._ins(node))
            for port, val in outs.items():
                self.env[(node.id, port)] = val

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


def _run_with_growth(plan: _Plan, flat, stats: Dict[str, int],
                     reinstall: Callable[[Dict[str, int]], _Plan]):
    """Run a plan, growing bucketed capacities on overflow and retrying.

    Each retry can reveal larger downstream needs (truncation hid
    elements), so loop to a fixpoint. The required sizes are stacked on
    the device and reach the host in ONE transfer per run (a transfer per
    capacity would synchronize once per stream).
    """
    for _ in range(32):
        out, required = plan.fn(flat)
        names = list(required)
        needs = (torch.stack([required[k].reshape(()).to(torch.int64)
                              for k in names]).cpu().tolist()
                 if names else [])
        grow = {k: _bucket_cap(n) for k, n in zip(names, needs)
                if n > plan.caps[k]}
        if not grow:
            return out
        stats["overflow_retries"] += 1
        plan = reinstall({**plan.caps, **grow})
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


def _refuse_unported(schedule: Schedule) -> None:
    if schedule.split or schedule.parallelize:
        raise NotImplementedError(
            f"split/parallelize schedules are not ported yet ({_LANES_SLICE})")
    if schedule.tile:
        raise NotImplementedError(
            f"tiled schedules are not ported yet ({_TILES_SLICE})")


class CompiledExpr:
    """A Custard expression lowered once into plan-cached executables.

    Lifecycle per call:

    1. operands -> concordant fibertrees -> coordinate arrays, padded to
       power-of-two **input buckets** (the plan key stays stable while nnz
       wobbles inside a bucket), uploaded to ``device``;
    2. plan lookup by input signature. A miss runs the eager backend once
       as a **capacity-recording pass** and buckets every intermediate
       stream capacity (``stats["traces"]`` counts plan builds);
    3. the plan runs every term and fuses them with one keyed union
       reduce; it also returns the true required sizes, so a **capacity
       overflow** grows the plan and re-runs — results are never silently
       truncated;
    4. the COO result is decoded host-side into an output FiberTree.

    ``device`` defaults to CUDA; with no GPU, pass ``device="cpu"`` to run
    the plain PyTorch fallbacks.
    """

    def __init__(self, expr, fmt: Format, schedule: Schedule,
                 dims: Dict[str, int], *, use_kernels: bool = True,
                 device=None):
        self.device = co.resolve_device(device)
        _refuse_unported(schedule)
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
        self.graph_hashes = tuple(G.structural_hash() for G in self.graphs)
        self.rvars = low.result_vars
        self._scalar = not self.rvars
        writer = _val_writer_node(self.graphs[0])
        self._out_shape = writer.params.get("shape", ())
        self._out_fmt = (writer.params.get("format")
                         or "c" * len(self.rvars))
        self._mode_order = writer.params.get("mode_order")
        self._strides = [(v, low.dims[v]) for v in self.rvars]
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
        self.stats = {"traces": 0, "plan_hits": 0, "plan_misses": 0,
                      "overflow_retries": 0, "calls": 0, "batch_calls": 0,
                      "lane_dispatches": 0, "sharded_dispatches": 0}

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
    def _needs_fused(self) -> bool:
        return not self._scalar and len(self.graphs) > 1

    def _backend(self, ti: int, tensors, **caps) -> TorchBackend:
        return TorchBackend(self.graphs[ti], tensors, self.low.dims,
                            self.rvars, device=self.device,
                            segsum=self._segsum, intersect=self._intersect,
                            mul_reduce=self._mul_reduce, **caps)

    def _record_caps(self, flat) -> Dict[str, int]:
        """Eager capacity-recording pass over one concrete padded operand
        set; returns bucketed capacities. It runs through the same
        dispatch entries as the plans, so on the GPU its reduces are the
        kernels too."""
        tensors = self._tensors_from_flat(flat)
        caps: Dict[str, int] = {}
        fused_need = 0
        for ti in range(len(self.graphs)):
            be = self._backend(ti, tensors)
            v = be.run_streams()
            caps.update({f"t{ti}.{k}": _bucket_cap(n)
                         for k, n in be.caps_record.items()})
            if isinstance(v, COOResult):
                fused_need += int(torch.sum(v.valid))
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

        def core(flat):
            tensors = self._tensors_from_flat(flat)
            required: Dict[str, torch.Tensor] = {}
            outs = []                      # per term: COOResult or scalar
            for ti in range(len(self.graphs)):
                be = self._backend(ti, tensors, scan_caps=scan_caps[ti],
                                   out_cap=out_caps[ti])
                outs.append(be.run_streams())
                for k, r in be.required.items():
                    required[f"t{ti}.{k}"] = r
            if self._scalar:
                total = signs[0] * outs[0]
                for s, v in zip(signs[1:], outs[1:]):
                    total = total + s * v
                return {"scalar": total}, required
            if len(outs) == 1:
                coo = outs[0]
                vals = coo.vals if signs[0] == 1 else signs[0] * coo.vals
                return {"keys": coo.keys, "vals": vals,
                        "valid": coo.valid}, required
            # term merge: ONE keyed union reduce combines every term's
            # partial result (sums commute; signs fold into the values)
            keys = torch.cat([c.keys for c in outs])
            vals = torch.cat([c.vals if s == 1 else s * c.vals
                              for s, c in zip(signs, outs)])
            valid = torch.cat([c.valid for c in outs])
            uk, uv, uvalid, count = union_reduce(
                keys, vals, valid, caps["fused"], self._segsum,
                key_bound=bound)
            required["fused"] = count
            return {"keys": uk, "vals": uv, "valid": uvalid}, required

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

    def _run_plan(self, plan: _Plan, sig, flat):
        return _run_with_growth(
            plan, flat, self.stats,
            lambda caps: self._install_plan(sig, caps))

    # -- output assembly ---------------------------------------------------
    def _assemble_out(self, out) -> FiberTree:
        if "scalar" in out:
            return FiberTree.from_dense(np.asarray(float(out["scalar"])), "")
        return coo_to_fibertree(out["keys"], out["vals"], out["valid"],
                                self._strides, self._out_shape,
                                self._out_fmt, self._mode_order)

    @property
    def orig_result_order(self) -> List[str]:
        """The result variables in storage (loop) order — the column
        order of ``execute_coo`` coordinates."""
        return list(self.rvars)

    # -- public execution --------------------------------------------------
    def execute(self, arrays: Dict[str, np.ndarray]) -> FiberTree:
        """Execute one operand set through the plan cache.

        Args:
            arrays: dense numpy array per input tensor name (concordant
                fibertrees are built internally per the schedule).

        Returns:
            The result ``FiberTree``. Equivalent to ``eng(arrays)``.

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

    def _dispatch_out(self, flat, sig):
        """One plan-cached execution; returns the raw keyed-COO ``out``."""
        self.stats["calls"] += 1
        plan = self._plans.get(sig)
        if plan is None:
            self.stats["plan_misses"] += 1
            plan = self._install_plan(sig, self._record_caps(flat))
        else:
            self.stats["plan_hits"] += 1
        return self._run_plan(plan, sig, flat)

    def __call__(self, arrays: Dict[str, np.ndarray]) -> FiberTree:
        flat, sig = self._pad_flat(self._raw_flat(arrays))
        return self._assemble_out(self._dispatch_out(flat, sig))

    def execute_coo(self, arrays: Dict[str, np.ndarray], *, hints=None
                    ) -> Tuple[Optional[np.ndarray], Any]:
        """Execute one operand set, returning the live result as a COO.

        Returns ``(coords, vals)``: ``coords`` is ``(nnz, k)`` int64 with
        one column per ``orig_result_order`` variable; scalar expressions
        return ``(None, float)``. ``hints`` overrides the per-level input
        buckets (``{tensor: [bucket per level]}``) so related operand sets
        share one input signature and therefore one plan.
        """
        flat, sig = self._pad_flat(self._raw_flat(arrays), hints)
        out = self._dispatch_out(flat, sig)
        if "scalar" in out:
            return None, float(out["scalar"])
        return decode_live_coo(out["keys"], out["vals"], out["valid"],
                               self._strides)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def compile_expr(expr, fmt: Format, schedule, dims: Dict[str, int], *,
                 use_kernels: bool = True, device=None, mem_budget=None
                 ) -> "CompiledExpr | BsrEngine":
    """Compile an expression once into a plan-cached engine.

    Args:
        expr: tensor index notation text or a parsed ``Assignment``.
        fmt: per-tensor level formats.
        schedule: a ``Schedule`` (``"auto"`` is not ported yet).
        dims: extent of every index variable.
        use_kernels: route the hot primitives through the
            ``kernels/ops`` dispatch table (the CUDA kernels on a GPU).
        device: where the engine runs; CUDA by default, and an error when
            there is no GPU (pass ``device="cpu"`` for the CPU).
        mem_budget: the reference's out-of-core budget; not ported yet.

    Returns:
        The process-wide engine for this configuration: repeated calls
        with the same (expression, formats, schedule, dims, use_kernels,
        device) return the SAME engine, so its plans are shared. A
        block-sparse contraction that ``bsr_pattern`` recognizes gets a
        ``BsrEngine``, shared by (expression, formats, schedule, dims,
        device).

    >>> import numpy as np
    >>> from repro_torch.core.schedule import Format, Schedule
    >>> eng = compile_expr("x(i) = B(i,j) * c(j)",
    ...                    Format({"B": "cc", "c": "c"}),
    ...                    Schedule(loop_order=("i", "j")), {"i": 2, "j": 3},
    ...                    device="cpu")
    >>> eng({"B": np.eye(2, 3), "c": np.ones(3)}).to_dense()
    array([1., 1.])
    """
    if isinstance(schedule, str):
        if schedule != "auto":
            raise ValueError(
                f"schedule must be a Schedule or 'auto', got {schedule!r}")
        raise NotImplementedError(
            f"schedule='auto' is not ported yet ({_AUTO_SLICE})")
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

    if mem_budget is not None:
        raise NotImplementedError(
            f"mem_budget routes through tiles, not ported yet "
            f"({_TILES_SLICE})")
    _refuse_unported(schedule)
    key = (expr_cache_key(assign, fmt, schedule, dims), use_kernels, str(dev))
    eng = _COMPILED.get(key)
    if eng is None:
        eng = CompiledExpr(assign, fmt, schedule, dims,
                           use_kernels=use_kernels, device=dev)
        _COMPILED[key] = eng
    return eng


def clear_compile_cache() -> None:
    _COMPILED.clear()
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

    def _run_plan(self, plan: _Plan, sig, flat):
        return _run_with_growth(plan, flat, self.stats,
                                lambda caps: self._install_plan(sig, caps))

    # -- public --------------------------------------------------------------
    def execute(self, env: Dict[str, np.ndarray]) -> FiberTree:
        self.stats["calls"] += 1
        flat, sig = _pad_flat_arrays(self._raw_flat(env), self._level_meta)
        plan = self._plans.get(sig)
        if plan is None:
            self.stats["plan_misses"] += 1
            plan = self._install_plan(sig, self._record_caps(flat))
        else:
            self.stats["plan_hits"] += 1
        out = self._run_plan(plan, sig, flat)
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
    ``CompiledExpr``, with dense materialization between units.

    Calling the program returns one ``FiberTree`` per MATERIALIZED stage
    output; fused-away intermediates are never built and do not appear.
    """

    def __init__(self, lp, *, use_kernels: bool = True, device=None):
        self.device = co.resolve_device(device)
        self.lp = lp
        self.cache_key = program_cache_key(lp)
        segsum = intersect = coo_levels = None
        if use_kernels:
            segsum = kops.sam_primitive("keyed_segment_sum", self.device)
            intersect = kops.sam_primitive("sorted_intersect", self.device)
            coo_levels = kops.sam_primitive("coo_to_levels", self.device)
        self.units: List[Tuple[str, List[int], Any]] = []
        for comp in lp.components():
            if len(comp) == 1:
                stg = lp.stages[comp[0]]
                eng = compile_expr(stg.assign, lp.fmt, stg.schedule,
                                   stg.dims, use_kernels=use_kernels,
                                   device=self.device)
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
        schedules: a dict keyed by stage lhs tensor, or a sequence aligned
            with the stages (``"auto"`` is not ported yet).
        dims: extent of every index variable used by any stage.
        use_kernels: route the hot primitives (the chain's segment sums
            and ``coo_to_levels``, every unit's reduces) through the
            ``kernels/ops`` dispatch table (the CUDA kernels on a GPU).
        sparsity: the reference's density hint for ``"auto"``; unused
            until the autoscheduler is ported.
        fuse: set False to force materialization between all stages (the
            unfused comparison baseline).
        mem_budget: the reference's out-of-core budget; not ported yet.
        device: where the program runs; CUDA by default, and an error when
            there is no GPU (pass ``device="cpu"`` for the CPU).

    Returns:
        The process-wide ``CompiledProgram`` for this configuration: the
        key is the per-stage canonical expression keys PLUS the fusion
        plan (DESIGN.md §6), ``use_kernels`` and ``device``, so a fused
        and an unfused build of the same program are distinct engines.
        (The reference also keys on the budget, and on the density hint
        when a budget is set; both must be None here.)

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
        raise NotImplementedError(
            f"mem_budget routes through tiles, not ported yet "
            f"({_TILES_SLICE})")
    dev = co.resolve_device(device)
    lp = lower_program(program, fmt, schedules, dims, sparsity=sparsity,
                       fuse=fuse)
    key = (program_cache_key(lp), use_kernels, str(dev))
    hit = _COMPILED_PROGRAMS.get(key)
    if hit is None:
        hit = CompiledProgram(lp, use_kernels=use_kernels, device=dev)
        _COMPILED_PROGRAMS[key] = hit
    return hit


def clear_program_cache() -> None:
    _COMPILED_PROGRAMS.clear()
