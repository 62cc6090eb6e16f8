"""The port's SAM-program model blocks and their examples, on the CPU.

* ``MoEBlock`` against the reference's ``MoEBlock``: within 1e-5
  (relative to the largest magnitude) and the same ``last_dropped``,
  routed by each side (on data without near-ties) and on the
  reference's routing; and within 1e-5 of ``moe_swiglu_reference``.
* ``PrunedTransformer`` at the ``docs/MODELS.md`` shape (qwen3-0.6b's
  ``REDUCED``, seq 16, block 4): weights bit-equal to the reference's,
  output within 1e-5 of the reference's forward and of ``reference()``
  (relative to the largest magnitude), and the same server and FFN
  counts (8 attention requests in 2 dispatches, one FFN call a layer).
* ``examples/torch_pruned_transformer.py`` and
  ``examples/torch_moe_sam_dispatch.py`` with ``--device cpu`` in a
  subprocess, each asserting what the reference's example asserts.

About 60 s serially (the reference's ``MoEBlock`` programs and forward
compile for about 15 s each).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.models import moe, moe_blocks

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _gap_ok(gates: np.ndarray, k: int, tol: float = 1e-5) -> np.ndarray:
    """Rows whose k-th and (k+1)-th largest gates differ by more than tol."""
    top = -np.sort(-gates, axis=1)
    return top[:, k - 1] - top[:, k] > tol


# -- MoEBlock -------------------------------------------------------------

@pytest.mark.parametrize("routing", ["own", "reference"])
def test_moe_block_matches_the_reference(routing, monkeypatch):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import moe as ref_moe
    from repro.models import moe_blocks as ref_mb

    e, cap, t, d, f, k = 4, 2, 6, 5, 3, 2
    rng = np.random.default_rng(11)
    p = {"router": rng.standard_normal((d, e)).astype(np.float32),
         "w_gate": rng.standard_normal((e, d, f)),
         "w_up": rng.standard_normal((e, d, f)),
         "w_down": rng.standard_normal((e, f, d))}
    x = rng.standard_normal((t, d))
    ref_block = ref_mb.MoEBlock(e, cap, t, d, f)
    want = ref_block(p, x, k=k)
    if routing == "reference":
        rw, rids = ref_moe.route_topk(jnp.asarray(p["router"]),
                                      jnp.asarray(x, jnp.float32), k)
        monkeypatch.setattr(moe, "route_topk", lambda *a, **kw: (
            torch.tensor(np.asarray(rw)),
            torch.tensor(np.asarray(rids))))
    else:
        logits = x @ p["router"].astype(np.float64)
        gates = np.exp(logits - logits.max(1, keepdims=True))
        assert _gap_ok(gates / gates.sum(1, keepdims=True), k).all()
    block = moe_blocks.MoEBlock(e, cap, t, d, f, device=CPU)
    got = block(p, x, k=k)
    assert block.last_dropped == ref_block.last_dropped
    assert block.last_dropped > 0
    assert _rel(got, want) <= 1e-5
    G, S, _ = moe_blocks.routing_tensors(
        *ref_moe.route_topk(jnp.asarray(p["router"]),
                            jnp.asarray(x, jnp.float32), k), e, cap)
    assert _rel(got, moe_blocks.moe_swiglu_reference(p, x, G, S)) <= 1e-5


# -- the pruned transformer ----------------------------------------------

@pytest.fixture
def schedule_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("SAM_SCHEDULE_CACHE", str(tmp_path / "sched.json"))


def test_pruned_transformer_matches_the_reference(schedule_cache):
    pytest.importorskip("jax")
    from repro.configs.qwen3_0_6b import REDUCED as REF_REDUCED
    from repro.models.pruned_transformer import (
        PrunedTransformer as RefPrunedTransformer)
    from repro_torch.configs.qwen3_0_6b import REDUCED
    from repro_torch.models.pruned_transformer import PrunedTransformer

    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, REDUCED.d_model)).astype(np.float32)
    kw = {"seq_len": 16, "block": 4, "window_blocks": 2, "ffn_density": 0.5}
    with PrunedTransformer(REDUCED, device=CPU, **kw) as model:
        y = model(x)
        ref = model.reference(x)
        stats = model.stats()
        layers = model.layers
    with RefPrunedTransformer(REF_REDUCED, **kw) as ref_model:
        y_ref = ref_model(x)
        assert len(layers) == len(ref_model.layers) == 2
        for mine, theirs in zip(layers, ref_model.layers):
            assert sorted(mine) == sorted(theirs)
            for name in mine:
                assert mine[name].dtype == theirs[name].dtype
                np.testing.assert_array_equal(mine[name], theirs[name])
    assert y.dtype == np.float32 and y.shape == x.shape
    assert _rel(y, ref) < 1e-5
    assert _rel(y, y_ref) < 1e-5
    assert stats["server"]["completed"] == 8
    assert stats["server"]["dispatches"] == 2
    assert stats["ffn_up_calls"] == 2 and stats["ffn_down_calls"] == 2


# -- the examples --------------------------------------------------------

@pytest.mark.parametrize("example", ["torch_pruned_transformer.py",
                                     "torch_moe_sam_dispatch.py"])
def test_example_runs_on_the_cpu(example, tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "SAM_SCHEDULE_CACHE": str(tmp_path / "sched.json")}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / example), "--device", CPU],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "OK" in out.stdout
