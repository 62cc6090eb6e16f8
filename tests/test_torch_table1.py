"""Table 1, first half: the port's engine against the reference, the
simulator and numpy.

On each Table-1 case, ``repro_torch``'s ``CompiledExpr`` on the CPU returns
the same FiberTree (``seg``, ``crd``, ``vals``) as the reference
``CompiledExpr``, both plain and with its Pallas kernels injected in
interpret mode (the ``_inject_pallas`` pattern of
``tests/test_fused_golden.py``); the port routed through the dispatch
table's CUDA entries (their plain versions on CPU tensors) gives the same
tree; and it equals the unsplit simulator's writer tokens and numpy.
Integer-valued data: equality, not tolerance. The cases are split over two
files (see ``test_torch_table1_more.py``) to keep each file short.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

from test_custard_table1 import CASES, DIMS  # noqa: E402
from test_fused_golden import _as_dict, _golden  # noqa: E402
from test_torch_engine import (assert_same_tree, inject_cuda_entries,  # noqa: E402
                               make_arrays, want_of)

from repro.core.einsum import parse  # noqa: E402
from repro.core.jax_backend import CompiledExpr as RCompiledExpr  # noqa: E402
from repro.core.schedule import Format as RFormat  # noqa: E402
from repro.core.schedule import Schedule as RSchedule  # noqa: E402
from repro.kernels import ops as rkops  # noqa: E402
from repro_torch.core.schedule import Format, Schedule  # noqa: E402
from repro_torch.core.torch_backend import CompiledExpr  # noqa: E402

CPU = "cpu"
HALF = len(CASES) // 2


def check_table1_case(name, expr, order, fmts):
    arrays = make_arrays(expr, DIMS, seed=len(name))
    sch = tuple(order)
    got = CompiledExpr(expr, Format(dict(fmts)), Schedule(loop_order=sch),
                       DIMS, device=CPU)(arrays)

    ref = RCompiledExpr(expr, RFormat(dict(fmts)),
                        RSchedule(loop_order=sch), DIMS)
    assert_same_tree(ref(arrays), got, f"{name} vs reference")
    pallas = RCompiledExpr(expr, RFormat(dict(fmts)),
                           RSchedule(loop_order=sch), DIMS)
    pallas._union_reduce = rkops._keyed_union_reduce_pallas
    pallas._mul_reduce = rkops._mul_reduce_pallas
    assert_same_tree(pallas(arrays), got, f"{name} vs reference + Pallas")

    via_entries = inject_cuda_entries(
        CompiledExpr(expr, Format(dict(fmts)), Schedule(loop_order=sch),
                     DIMS, device=CPU))
    assert_same_tree(got, via_entries(arrays), f"{name} via cuda entries")

    rank = len(parse(expr).lhs.vars)
    assert _as_dict(got, rank) == _golden(expr, RFormat(dict(fmts)), order,
                                          arrays), name
    np.testing.assert_array_equal(got.to_dense(),
                                  want_of(expr, arrays, DIMS))


@pytest.mark.parametrize("name,expr,order,fmts,expected", CASES[:HALF],
                         ids=[c[0] for c in CASES[:HALF]])
def test_table1_matches_reference_simulator_and_numpy(name, expr, order,
                                                      fmts, expected):
    check_table1_case(name, expr, order, fmts)
