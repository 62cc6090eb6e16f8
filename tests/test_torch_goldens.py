"""The port's legs of the golden wire-stream tests.

* ``tests/test_split_golden.py``: every Table-1 expression lowered with
  ``split={outer: 2}, parallelize={outer: 2}`` and simulated per lane by
  the port's simulator; the per-lane WRITER token streams, decoded,
  mapped back from the split coordinate space and merged with their term
  signs, equal the unsplit schedule's golden writer tokens, and those
  goldens equal the reference simulator's.
* ``tests/test_fused_golden.py``: the port's ``CompiledExpr`` runs the
  same split schedules with the GPU dispatch entries injected (the
  workspace union reduce and the fused multiply-reduce, whose kernel
  wrappers take their plain versions on CPU tensors), and its merged
  result equals the goldens and, bit for bit, the ``coord_ops`` path.
* ``test_tiled_partials_merge_to_golden_streams``: per-tile partial COOs
  of the port's ``TiledExpr``, merged through the same union-reduce entry,
  reproduce the goldens too.

Integer-valued data, so every comparison is exact.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

from test_custard_table1 import CASES, DIMS, oracle  # noqa: E402
from test_fused_golden import _as_dict  # noqa: E402
from test_torch_engine import make_arrays  # noqa: E402

from repro.core.custard import lower as rlower  # noqa: E402
from repro.core.schedule import Format as RFormat  # noqa: E402
from repro.core.schedule import Schedule as RSchedule  # noqa: E402
from repro.core.simulator import Simulator as RSimulator  # noqa: E402
from test_split_golden import decode_writer_tokens as rdecode  # noqa: E402
from repro_torch.core import streams as st  # noqa: E402
from repro_torch.core.custard import lower  # noqa: E402
from repro_torch.core.einsum import parse  # noqa: E402
from repro_torch.core.schedule import Format, Schedule  # noqa: E402
from repro_torch.core.simulator import Simulator, simulate_expr  # noqa: E402
from repro_torch.core.torch_backend import CompiledExpr, TiledExpr  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

CPU = "cpu"


def decode_writer_tokens(res, lhs: str, rvars):
    """The port's copy of ``test_split_golden.decode_writer_tokens``: a
    simulation's writer WIRE tokens decoded into {coords: value}, read
    through the port's ``streams`` (its token classes are its own)."""
    out = {}
    if not rvars:                       # scalar result: a depth-0 stream
        v = st.tokens_to_nested(res.edge_tokens(f"{lhs}_vals", "val"),
                                depth=0)
        if v not in (None, []) and float(v) != 0.0:
            out[()] = float(v)
        return out
    crds = [st.tokens_to_nested(res.edge_tokens(f"{lhs}_{v}", "crd"),
                                depth=i + 1)
            for i, v in enumerate(rvars)]
    vals = st.tokens_to_nested(res.edge_tokens(f"{lhs}_vals", "val"),
                               depth=len(rvars))

    def walk(cs, v, prefix):
        if len(cs) == 1:
            for c, val in zip(cs[0], v):
                if c is None or val is None or float(val) == 0.0:
                    continue
                key = prefix + (int(c),)
                out[key] = out.get(key, 0.0) + float(val)
            return
        for i, c in enumerate(cs[0]):
            walk([cc[i] for cc in cs[1:]], v[i],
                 prefix + (int(c) if c is not None else -1,))

    walk(crds, vals, ())
    return {k: v for k, v in out.items() if v != 0.0}


def unsplit_coords(key, rvars_split, split_of, dims_split):
    """Merge adjacent (vo, vi) coordinate pairs back to vo*chunk + vi."""
    out, i = [], 0
    while i < len(rvars_split):
        v = rvars_split[i]
        if (v.endswith("o") and v[:-1] in split_of
                and i + 1 < len(rvars_split)
                and rvars_split[i + 1] == v[:-1] + "i"):
            out.append(key[i] * dims_split[v[:-1] + "i"] + key[i + 1])
            i += 2
        else:
            out.append(key[i])
            i += 1
    return tuple(out)


def _golden(expr, fmts, order, arrays):
    """The unsplit port simulator's writer tokens, keyed by LHS
    coordinates; held equal to the reference simulator's."""
    assign = parse(expr)
    low = lower(expr, Format(dict(fmts)), Schedule(loop_order=tuple(order)),
                DIMS)
    tok = decode_writer_tokens(Simulator(low.graph,
                                         low.build_inputs(arrays)).run(),
                               assign.lhs.tensor, low.result_vars)
    rlow = rlower(expr, RFormat(dict(fmts)),
                  RSchedule(loop_order=tuple(order)), DIMS)
    rtok = rdecode(RSimulator(rlow.graph, rlow.build_inputs(arrays)).run(),
                   assign.lhs.tensor, rlow.result_vars)
    assert tok == rtok
    out = {}
    for key, v in tok.items():
        out[tuple(key[low.result_vars.index(w)]
                  for w in assign.lhs.vars)] = v
    # sanity: golden streams carry exactly the dense oracle
    terms = [(t.sign, [(f.tensor, "".join(f.vars)) for f in t.factors])
             for t in assign.terms]
    want = oracle(terms, arrays, "".join(assign.result_vars), DIMS)
    for key, v in out.items():
        assert want[key] == v, (expr, key)
    return out


def _lanes(order):
    outer = order[0]
    return Schedule(loop_order=tuple(order), split={outer: 2},
                    parallelize={outer: 2})


@pytest.mark.parametrize("name,expr,order,fmts,expected", CASES,
                         ids=[c[0] for c in CASES])
def test_split_lane_streams_merge_to_golden_tokens(name, expr, order, fmts,
                                                   expected):
    assign = parse(expr)
    arrays = make_arrays(expr, DIMS, seed=len(name) + 100)
    golden = _golden(expr, fmts, order, arrays)
    lhs = assign.lhs.tensor
    sch2 = _lanes(order)
    sim2 = simulate_expr(expr, Format(dict(fmts)), sch2, arrays, DIMS)
    low2 = lower(expr, Format(dict(fmts)), sch2, DIMS)
    rvars2 = low2.result_vars
    merged, term_lanes = {}, {}
    for ls in sim2.lanes:
        lane_out = decode_writer_tokens(ls.result, lhs, rvars2)
        if ls.lane is not None:
            term_lanes.setdefault(ls.term, []).append(set(lane_out))
        for key, v in lane_out.items():
            okey = unsplit_coords(key, rvars2, low2.split_of, low2.dims)
            okey = tuple(okey[low2.orig_result_vars.index(w)]
                         for w in assign.lhs.vars)
            merged[okey] = merged.get(okey, 0.0) + ls.sign * v
    merged = {k: v for k, v in merged.items() if v != 0.0}
    assert merged == golden, f"{name}: merged lane streams differ"
    # a parallelized RESULT variable partitions each term's wire streams
    # into disjoint coordinate chunks (the concat-merge topology)
    if low2.merge_kind == "concat":
        for sets in term_lanes.values():
            for a in range(len(sets)):
                for b in range(a + 1, len(sets)):
                    assert not (sets[a] & sets[b]), (
                        f"{name}: concat-merge lanes overlap")


def _inject_kernel_entries(eng):
    """Put the engine's merge slots on the GPU dispatch entries; on CPU
    tensors their kernel wrappers run the plain versions."""
    eng._union_reduce = kops._keyed_union_reduce_cuda
    eng._mul_reduce = kops._mul_reduce_cuda
    return eng


@pytest.mark.parametrize("name,expr,order,fmts,expected", CASES,
                         ids=[c[0] for c in CASES])
def test_fused_engine_merges_to_golden_streams(name, expr, order, fmts,
                                               expected):
    assign = parse(expr)
    fmt = Format(dict(fmts))
    arrays = make_arrays(expr, DIMS, seed=len(name) + 200)
    rank = len(assign.lhs.vars)
    golden = _golden(expr, fmts, order, arrays)
    fused = _inject_kernel_entries(CompiledExpr(expr, fmt, _lanes(order),
                                                DIMS, device=CPU))
    got_fused = _as_dict(fused(arrays), rank)
    assert got_fused == golden, f"{name}: fused engine diverges from golden"
    unfused = CompiledExpr(expr, fmt, _lanes(order), DIMS, device=CPU)
    unfused._mul_reduce = None
    unfused._union_reduce = None
    assert _as_dict(unfused(arrays), rank) == got_fused, (
        f"{name}: fused != unfused bitwise")


def test_tiled_partials_merge_to_golden_streams():
    """Per-tile partial COOs accumulated through the workspace union
    reduce entry reproduce the unsplit golden token streams."""
    name, expr, order, fmts, _ = next(c for c in CASES
                                      if c[0].startswith("SpMSpM"))
    assign = parse(expr)
    arrays = make_arrays(expr, DIMS, seed=300)
    golden = _golden(expr, fmts, order, arrays)
    red = [v for v in order if v not in assign.lhs.vars][0]
    eng = TiledExpr(expr, Format(dict(fmts)),
                    Schedule(loop_order=tuple(order), tile={red: 2}), DIMS,
                    device=CPU)
    eng._union_reduce = kops._keyed_union_reduce_cuda
    assert eng.n_tiles > 1 and eng._key_bound is not None
    assert _as_dict(eng(arrays), len(assign.lhs.vars)) == golden
