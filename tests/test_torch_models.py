"""The port's model blocks against the reference's, on the CPU.

* Configs: every registered arch's ``CFG`` and ``REDUCED`` equal the
  reference's field by field, with equal parameter counts and shape
  support; ``pdtype``/``cdtype`` are torch dtypes.
* ``routing_tensors`` (a copy) equals the reference's exactly, and the
  ``docs/MODELS.md`` case drops 2 pairs.
* ``route_topk``: weights within 1e-6; ids equal wherever the gap between
  the k-th and the (k+1)-th gate exceeds 1e-5 (``torch.topk`` and
  ``jax.lax.top_k`` order near-ties differently, and the two softmaxes may
  differ by an ulp).
* ``moe_dense_dispatch``, ``moe_sam_dispatch`` and ``apply_moe`` (shared
  experts) on the reference's ``init_moe`` parameters carried over by
  ``params_from_numpy``: within 1e-5 of the reference's output, relative
  to its largest magnitude, in float32 and 1e-2 in bfloat16; the
  dispatches also on the reference's own ``(w, ids)``.
* ``compile_moe_block``: the reference's fusion decisions, and on integer
  data every output of the port equal to ``moe_linear_reference``, fused
  and staged, and the fused outputs to the reference engine's; the port's
  leg of
  ``test_moe_dispatch_chain_conformance``.

``MoEBlock``, ``PrunedTransformer`` and the examples have a file of
their own (``tests/test_torch_model_blocks.py``). About 50 s serially,
most of it the reference's XLA compiles of the MoE program (its first
fused ``compile_moe_block`` call alone takes about 23 s).
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

try:
    from hypothesis import given, settings
except ImportError:  # clean checkout: deterministic stub keeps tests running
    from _hypothesis_stub import given, settings

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_conformance import moe_chain_case  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import moe_blocks as ref_mb  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core.schedule import Format, Schedule  # noqa: E402
from repro_torch.models import moe, moe_blocks  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402

CPU = "cpu"
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


# -- configs -------------------------------------------------------------

@pytest.mark.parametrize("arch", base.list_archs())
def test_configs_equal_the_reference(arch):
    assert base.list_archs() == ref_base.list_archs()
    for reduced in (False, True):
        mine = base.get_config(arch, reduced=reduced)
        ref = ref_base.get_config(arch, reduced=reduced)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.n_params() == ref.n_params()
        assert mine.n_active_params() == ref.n_active_params()
        assert mine.resolved_head_dim == ref.resolved_head_dim
        for shape in base.SHAPES:
            assert (base.supports_shape(mine, shape)
                    == ref_base.supports_shape(ref, shape))
        assert mine.pdtype == getattr(torch, ref.param_dtype)
        assert mine.cdtype == getattr(torch, ref.compute_dtype)
    assert ({k: dataclasses.asdict(v) for k, v in base.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in ref_base.SHAPES.items()})


# -- routing -------------------------------------------------------------

def test_routing_tensors_docs_case_drops_two():
    weights = np.ones((4, 2))
    ids = np.array([[0, 1], [0, 1], [0, 2], [1, 2]])
    G, S, dropped = moe_blocks.routing_tensors(weights, ids, n_experts=3,
                                               capacity=2)
    assert G.shape == (3, 2, 4) and S.shape == (4, 3, 2)
    assert dropped == 2


@pytest.mark.parametrize("cap", [1, 3, 8])
def test_routing_tensors_equal_the_reference(cap):
    rng = np.random.default_rng(cap)
    t, k, e = 12, 2, 5
    ids = np.stack([rng.choice(e, k, replace=False) for _ in range(t)])
    w = rng.random((t, k))
    mine = moe_blocks.routing_tensors(w, ids, e, cap)
    ref = ref_mb.routing_tensors(w, ids, e, cap)
    for a, b in zip(mine[:2], ref[:2]):
        np.testing.assert_array_equal(a, b)
    assert mine[2] == ref[2]


def _gap_ok(gates: np.ndarray, k: int, tol: float = 1e-5) -> np.ndarray:
    """Rows whose k-th and (k+1)-th largest gates differ by more than tol."""
    top = -np.sort(-gates, axis=1)
    return top[:, k - 1] - top[:, k] > tol


def test_route_topk_matches_the_reference():
    rng = np.random.default_rng(0)
    t, d, e, k = 64, 16, 8, 2
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) * 0.5).astype(np.float32)
    w, ids = moe.route_topk(torch.as_tensor(router), torch.as_tensor(x), k)
    rw, rids = ref_moe.route_topk(jnp.asarray(router), jnp.asarray(x), k)
    assert ids.dtype == torch.int32 and w.dtype == torch.float32
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), atol=1e-6)
    logits = x.astype(np.float64) @ router.astype(np.float64)
    gates = np.exp(logits - logits.max(1, keepdims=True))
    ok = _gap_ok(gates / gates.sum(1, keepdims=True), k)
    assert ok.sum() >= t - 2
    np.testing.assert_array_equal(ids.numpy()[ok], np.asarray(rids)[ok])


# -- the dispatches ------------------------------------------------------

D, DFF, E, K, T = 16, 32, 8, 2, 48


def _moe_case(n_shared=0, seed=0):
    p = ref_moe.init_moe(jax.random.PRNGKey(seed), D, DFF, E,
                         n_shared=n_shared, dtype=jnp.float32)
    x = np.array(jax.random.normal(jax.random.PRNGKey(seed + 1), (T, D),
                                   jnp.float32))
    return p, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dispatch", ["dense", "sam", "sam_drops"])
def test_dispatch_matches_the_reference(dispatch, dtype):
    p, x = _moe_case()
    cf = 0.5 if dispatch == "sam_drops" else 8.0
    mine_p = params_from_numpy(jax.tree_util.tree_map(np.asarray, p), CPU)
    xt = torch.as_tensor(x)
    if dispatch == "dense":
        got = moe.moe_dense_dispatch(mine_p, xt, k=K,
                                     compute_dtype=getattr(torch, dtype))
        want = ref_moe.moe_dense_dispatch(p, jnp.asarray(x), k=K,
                                          compute_dtype=getattr(jnp, dtype))
    else:
        got = moe.moe_sam_dispatch(mine_p, xt, k=K, capacity_factor=cf,
                                   compute_dtype=getattr(torch, dtype))
        want = ref_moe.moe_sam_dispatch(p, jnp.asarray(x), k=K,
                                        capacity_factor=cf,
                                        compute_dtype=getattr(jnp, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert _rel(_np(got), np.asarray(want, np.float32)) <= TOL[dtype]


@pytest.mark.parametrize("dispatch", ["dense", "sam"])
def test_dispatch_on_the_reference_routing(dispatch, monkeypatch):
    """Both dispatches fed the reference's own ``(w, ids)``: the port's
    result equals the reference's to float32 resolution, whatever
    ``torch.topk`` would have picked at a near-tie."""
    p, x = _moe_case(seed=3)
    rw, rids = ref_moe.route_topk(p["router"], jnp.asarray(x), K)
    monkeypatch.setattr(moe, "route_topk", lambda *a, **kw: (
        torch.tensor(np.asarray(rw)), torch.tensor(np.asarray(rids))))
    mine_p = params_from_numpy(jax.tree_util.tree_map(np.asarray, p), CPU)
    fn = moe.moe_dense_dispatch if dispatch == "dense" else \
        moe.moe_sam_dispatch
    ref_fn = ref_moe.moe_dense_dispatch if dispatch == "dense" else \
        ref_moe.moe_sam_dispatch
    kw = {} if dispatch == "dense" else {"capacity_factor": 0.75}
    got = fn(mine_p, torch.as_tensor(x), k=K, compute_dtype=torch.float32,
             **kw)
    want = ref_fn(p, jnp.asarray(x), k=K, compute_dtype=jnp.float32, **kw)
    assert _rel(_np(got), np.asarray(want)) <= TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_moe_with_shared_experts_matches_the_reference(dtype):
    p, x = _moe_case(n_shared=2, seed=5)
    assert "shared" in p
    mine_p = params_from_numpy(jax.tree_util.tree_map(np.asarray, p), CPU)
    xb = x.reshape(2, T // 2, D)
    for dispatch in ("sam", "dense"):
        got = moe.apply_moe(mine_p, torch.as_tensor(xb), k=K,
                            dispatch=dispatch, capacity_factor=8.0,
                            compute_dtype=getattr(torch, dtype))
        want = ref_moe.apply_moe(p, jnp.asarray(xb), k=K, dispatch=dispatch,
                                 capacity_factor=8.0,
                                 compute_dtype=getattr(jnp, dtype))
        assert got.shape == (2, T // 2, D)
        assert _rel(_np(got), np.asarray(want, np.float32)) <= TOL[dtype]


def test_init_moe_shapes_and_params_from_numpy():
    g = torch.Generator(device=CPU).manual_seed(0)
    p = moe.init_moe(g, D, DFF, E, n_shared=2)
    ref = ref_moe.init_moe(jax.random.PRNGKey(0), D, DFF, E, n_shared=2)
    def shapes(tree):
        return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)

    assert shapes(p) == shapes(ref)
    carried = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref), CPU,
                                dtype=torch.bfloat16)
    assert carried["shared"]["w_up"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params_from_numpy({"a": np.arange(3)}, CPU)["a"].numpy(),
        np.arange(3))


# -- the MoE programs ----------------------------------------------------

@pytest.mark.parametrize("fuse", [True, False])
def test_compile_moe_block_equals_the_reference_exactly(fuse):
    e, cap, t, d, f = 3, 2, 5, 3, 4
    rng = np.random.default_rng(7)
    ids = np.stack([rng.choice(e, 2, replace=False) for _ in range(t)])
    G, S, dropped = moe_blocks.routing_tensors(
        rng.integers(1, 3, (t, 2)).astype(float), ids, e, cap)
    assert dropped > 0
    arrays = {"G": G, "S": S,
              "X": rng.integers(-3, 4, (t, d)).astype(float),
              "Wu": rng.integers(-2, 3, (e, d, f)).astype(float),
              "Wd": rng.integers(-2, 3, (e, f, d)).astype(float)}
    cp = moe_blocks.compile_moe_block(e, cap, t, d, f, fuse=fuse, device=CPU)
    ref_cp = ref_mb.compile_moe_block(e, cap, t, d, f, fuse=fuse)
    assert ([x.fused for x in cp.decisions]
            == [x.fused for x in ref_cp.decisions]
            == ([True, True, False] if fuse else [False] * 3))
    got = cp(arrays)
    lin = moe_blocks.moe_linear_reference(
        G, S, arrays["X"], arrays["Wu"], arrays["Wd"])
    assert sorted(got) == (["O", "Z"] if fuse else ["H", "O", "Y", "Z"])
    for name in got:
        np.testing.assert_array_equal(got[name].to_dense(), lin[name])
    if fuse:
        # the reference's engine once (its first call compiles for ~23 s
        # on the CPU; the staged units' outputs equal the oracle's above)
        want = ref_cp(arrays)
        assert sorted(want) == sorted(got)
        for name in got:
            np.testing.assert_array_equal(got[name].to_dense(),
                                          want[name].to_dense())


@settings(max_examples=8, deadline=None)
@given(moe_chain_case())
def test_moe_dispatch_chain_conformance(case):
    """The port's leg of the reference's model-block acceptance test: the
    port's simulator and compiled program equal the dense numpy oracle
    for 'c'/'d' intermediate formats and split schedules."""
    from repro_torch.core.program import numpy_reference, simulate_program
    from repro_torch.core.torch_backend import compile_program

    seed, e, cap, t, d, f, fmt_int, mode, factor = case
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, e, (t, 2))
    w = np.ones((t, 2))
    G, S, _ = moe_blocks.routing_tensors(w, ids, e, cap)
    arrays = {"G": G, "S": S,
              "X": rng.integers(-3, 4, (t, d)).astype(float),
              "Wu": rng.integers(-2, 3, (e, d, f)).astype(float),
              "Wd": rng.integers(-2, 3, (e, f, d)).astype(float)}
    fmt_map = dict(moe_blocks.moe_formats().formats)
    for name in ("Y", "H", "Z"):
        fmt_map[name] = fmt_int
    sch = {k: Schedule(loop_order=v.loop_order)
           for k, v in moe_blocks.moe_schedules().items()}
    if mode == 1:
        sch["Y"] = Schedule(loop_order=sch["Y"].loop_order,
                            split={"t": factor})
    elif mode == 2:
        sch["O"] = Schedule(loop_order=sch["O"].loop_order,
                            split={"g": factor})
    dims = moe_blocks.moe_dims(e, cap, t, d, f)
    ref = numpy_reference(moe_blocks.MOE_PROGRAM, arrays)
    sim = simulate_program(moe_blocks.MOE_PROGRAM, Format(fmt_map), sch,
                           dims, arrays)
    np.testing.assert_array_equal(sim.dense["O"], ref["O"])
    out = compile_program(moe_blocks.MOE_PROGRAM, Format(fmt_map), sch, dims,
                          device=CPU)(arrays)
    np.testing.assert_array_equal(out["O"].to_dense(), ref["O"])
    for name in ("Y", "H", "Z"):
        if name in out:
            np.testing.assert_array_equal(out[name].to_dense(), ref[name])
