"""The port's legs of the reference's differential conformance suites.

* ``test_random_einsum_conformance``: hypothesis-generated random einsums
  x ``d``/``c``/``b`` formats x loop orders x schedule modes (plain,
  split, split + parallelize), as in ``tests/test_conformance.py``. The
  port's simulator equals numpy on every case, and the port's compiled
  engine (``execute_expr`` on the CPU) equals both wherever no operand is
  bitvector-stored (those run on the simulator only, as in the
  reference).
* ``test_random_tiled_conformance``: random einsums x RANDOM tile grids
  (the out-of-core layer), as in ``tests/test_conformance.py``: the
  port's tiled simulation, its tiled engine (a ``TiledExpr`` through
  ``execute_expr`` on the CPU), its untiled engine and numpy all agree.
* ``test_random_format_conformance``: the ``_check`` of
  ``tests/test_format_conformance.py`` on random (expression, per-level
  ``d``/``c``/``s``/``h``/``m`` format, loop order) draws: simulator ==
  engine == numpy.

Integer-valued data, so every comparison is exact.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

try:
    from hypothesis import given, settings, strategies as hst
except ImportError:  # clean checkout: deterministic stub keeps tests running
    from _hypothesis_stub import given, settings, strategies as hst

from test_conformance import conformance_case, tiled_case  # noqa: E402
from test_format_conformance import CHARS, RANDOM_POOL, rand  # noqa: E402

from repro_torch.core.einsum import parse  # noqa: E402
from repro_torch.core.schedule import Format, Schedule  # noqa: E402
from repro_torch.core.simulator import simulate_expr  # noqa: E402
from repro_torch.core.torch_backend import execute_expr  # noqa: E402

CPU = "cpu"


@settings(max_examples=25, deadline=None)
@given(conformance_case())
def test_random_einsum_conformance(case):
    (accesses, out_vars, loop_order, dims, fmts, mode, split_var, factor,
     seed) = case
    rng = np.random.default_rng(seed)
    lhs = "X(" + ",".join(out_vars) + ")" if out_vars else "X"
    expr = lhs + " = " + " * ".join(
        f"{n}({','.join(tv)})" for n, tv in accesses)
    arrays = {n: ((rng.random(tuple(dims[v] for v in tv)) < 0.5)
                  * rng.integers(1, 5, tuple(dims[v] for v in tv))
                  ).astype(float)
              for n, tv in accesses}
    fmt = Format(dict(fmts))
    sch = Schedule(
        loop_order=loop_order,
        split={split_var: factor} if mode else {},
        parallelize={split_var: factor} if mode == 2 else {})
    spec = (",".join("".join(tv) for _, tv in accesses)
            + "->" + "".join(out_vars))
    want = np.einsum(spec, *[arrays[n] for n, _ in accesses])

    sim = simulate_expr(expr, fmt, sch, arrays, dims)
    np.testing.assert_array_equal(sim.dense, want,
                                  err_msg=f"sim: {expr} {sch}")
    if "b" in "".join(fmts.values()):
        return  # bitvector operands execute on the simulator only
    got = execute_expr(expr, fmt, sch, arrays, dims, device=CPU).to_dense()
    np.testing.assert_array_equal(got, want, err_msg=f"engine: {expr} {sch}")


@settings(max_examples=15, deadline=None)
@given(tiled_case())
def test_random_tiled_conformance(case):
    accesses, out_vars, loop_order, dims, tile, seed = case
    rng = np.random.default_rng(seed)
    lhs = "X(" + ",".join(out_vars) + ")" if out_vars else "X"
    expr = lhs + " = " + " * ".join(
        f"{n}({','.join(tv)})" for n, tv in accesses)
    arrays = {n: ((rng.random(tuple(dims[v] for v in tv)) < 0.5)
                  * rng.integers(1, 5, tuple(dims[v] for v in tv))
                  ).astype(float)
              for n, tv in accesses}
    fmt = Format({n: "c" * len(tv) for n, tv in accesses})
    tiled = Schedule(loop_order=loop_order, tile=tile)
    spec = (",".join("".join(tv) for _, tv in accesses)
            + "->" + "".join(out_vars))
    want = np.einsum(spec, *[arrays[n] for n, _ in accesses])

    sim = simulate_expr(expr, fmt, tiled, arrays, dims)
    np.testing.assert_array_equal(sim.dense, want,
                                  err_msg=f"tiled sim: {expr} tile={tile}")
    got = execute_expr(expr, fmt, tiled, arrays, dims, device=CPU).to_dense()
    np.testing.assert_array_equal(got, want,
                                  err_msg=f"tiled engine: {expr} {tile}")
    untiled = execute_expr(expr, fmt, Schedule(loop_order=loop_order),
                           arrays, dims, device=CPU).to_dense()
    np.testing.assert_array_equal(got, untiled,
                                  err_msg=f"tiled != untiled: {expr} {tile}")


@hst.composite
def format_case(draw):
    expr, shapes, dims = RANDOM_POOL[draw(hst.integers(0, len(RANDOM_POOL)
                                                       - 1))]
    fmts = {t: "".join(CHARS[draw(hst.integers(0, len(CHARS) - 1))]
                       for _ in sh) for t, sh in shapes.items()}
    order = tuple(draw(hst.permutations(sorted(dims))))
    seeds = {t: draw(hst.integers(0, 2 ** 30)) for t in shapes}
    return expr, shapes, dims, fmts, order, seeds


@settings(max_examples=25, deadline=None)
@given(format_case())
def test_random_format_conformance(case):
    expr, shapes, dims, fmts, order, seeds = case
    arrays = {t: rand(sh, seeds[t]) for t, sh in shapes.items()}
    fmt = Format(dict(fmts))
    sch = Schedule(loop_order=order)
    assign = parse(expr)
    spec = (",".join("".join(a.vars) for t in assign.terms
                     for a in t.factors)
            + "->" + "".join(assign.lhs.vars))
    want = np.einsum(spec, *[arrays[a.tensor] for t in assign.terms
                             for a in t.factors])
    sim = simulate_expr(expr, fmt, sch, arrays, dims)
    np.testing.assert_array_equal(sim.dense, want,
                                  err_msg=f"sim: {expr} {fmts} {order}")
    got = execute_expr(expr, fmt, sch, arrays, dims, device=CPU).to_dense()
    np.testing.assert_array_equal(got, want,
                                  err_msg=f"engine: {expr} {fmts} {order}")
