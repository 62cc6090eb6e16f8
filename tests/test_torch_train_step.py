"""The port's optimizer, train step, data pipeline and input specs
against the reference's, on the CPU.

* ``lr_at`` over a grid of steps: within 1e-6 relative.
* ``adamw_update``, 3 steps on fixed synthetic gradient trees (the same
  gradients on both sides; clipping on and off; a 1-D leaf, which is not
  decayed, and a stacked ``(L, d)`` leaf, which is, as in the
  reference): parameters within 1e-6 relative, the bfloat16 moments
  equal.
* ``quantize_int8`` with error feedback over 5 rounds: bit-identical.
* ``make_train_step`` with ``n_micro`` 1 and 2 and ``compress_grads`` off
  and on, 2 steps at qwen3-0.6b's reduced config in float32 compute on
  the reference's parameters and batches: the loss within 1e-5 and
  ``grad_norm`` within 1e-4 (relative); the parameters within
  ``2 * lr * steps`` elementwise (a gradient near zero can take another
  sign in the other package, and Adam's normalized step then moves that
  element by about ``lr`` the other way), and at least 99% of the
  elements within 1e-5 of the reference's largest magnitude in their
  leaf. The step changes none of its inputs.
* ``batch_for_step`` and ``decode_batch``: the reference's keys, shapes,
  dtypes and ranges per frontend; the same batch for the same (seed,
  step, host); other batches for another step or host.
* ``launch.specs.input_specs``: the reference's shapes and dtypes for a
  train, a prefill and a decode shape, every architecture, nothing
  allocated.
* A train step leaves no tensor in a reference cycle.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_train_loss import (as_np, leaves, ref_params,  # noqa: E402
                                   rel)

from repro.configs import ShapeConfig as RefShape  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import train_step as ref_ts  # noqa: E402
from repro_torch.configs import (ShapeConfig, get_config,  # noqa: E402
                                 list_archs)
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402
from repro_torch.models.model import tree_map  # noqa: E402
from repro_torch.train import optimizer as opt_mod  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

CPU = torch.device("cpu")


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return params_from_numpy(tree, device=CPU)


def test_lr_at_equals_the_reference():
    for warm, total in ((0, 50), (10, 100), (100, 10000), (5, 5)):
        cfg = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=warm,
                                  total_steps=total)
        rcfg = ref_opt.AdamWConfig(lr=1e-3, warmup_steps=warm,
                                   total_steps=total)
        steps = np.array(sorted({0, 1, 2, warm, warm + 1, total // 2,
                                 total - 1, total, total + 7, 3 * total}),
                         np.int32)
        got = opt_mod.lr_at(cfg, torch.tensor(steps))
        want = ref_opt.lr_at(rcfg, jnp.asarray(steps))
        assert got.dtype == torch.float32
        assert rel(got, want) <= 1e-6


def _synthetic(seed):
    """A parameter tree and three gradient trees: a matrix, a 1-D bias, a
    stacked (L, d) norm scale and a list of leaves, float32."""
    rng = np.random.default_rng(seed)

    def tree(scale):
        return {"w": (rng.normal(size=(6, 5)) * scale).astype(np.float32),
                "b": (rng.normal(size=(5,)) * scale).astype(np.float32),
                "layers": {"ln": (1 + rng.normal(size=(3, 5)) * scale
                                  ).astype(np.float32)},
                "blocks": [{"r": (rng.normal(size=(2, 3, 4)) * scale
                                  ).astype(np.float32)}]}
    return tree(1.0), [tree(s) for s in (0.5, 3.0, 0.01)]


@pytest.mark.parametrize("clip", [None, 1.0])
def test_adamw_update_equals_the_reference(clip):
    kw = dict(lr=1e-2, weight_decay=0.1, warmup_steps=2, total_steps=10,
              clip_norm=clip)
    cfg, rcfg = opt_mod.AdamWConfig(**kw), ref_opt.AdamWConfig(**kw)
    params, grads = _synthetic(0)
    tp, rp = _to_torch(params), _to_jax(params)
    tstate = opt_mod.init_opt_state(cfg, tp)
    rstate = ref_opt.init_opt_state(rcfg, rp)
    for g in grads:
        tp, tstate = opt_mod.adamw_update(cfg, tp, _to_torch(g), tstate)
        rp, rstate = ref_opt.adamw_update(rcfg, rp, _to_jax(g), rstate)
    assert int(tstate["step"]) == int(rstate["step"]) == 3
    assert tstate["step"].dtype == torch.int32
    got, want = leaves(tp), leaves(jax.tree.map(np.asarray, rp))
    for k in want:
        assert rel(got[k], want[k]) <= 1e-6, k
    for name in ("m", "v"):
        got = leaves(tstate[name])
        want = leaves(jax.tree.map(np.asarray, rstate[name]))
        for k in want:
            assert got[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(as_np(got[k]),
                                          want[k].astype(np.float32))


def test_adamw_decays_leaves_of_two_or_more_dims_only():
    """With zero gradients, only decoupled weight decay moves a leaf: the
    1-D bias stays, the matrix and the stacked (L, d) scale shrink, as in
    the reference (its ``p.ndim >= 2`` rule)."""
    cfg = opt_mod.AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=0,
                              total_steps=10)
    params, _ = _synthetic(1)
    tp = _to_torch(params)
    zero = tree_map(torch.zeros_like, tp)
    new, _ = opt_mod.adamw_update(cfg, tp, zero,
                                  opt_mod.init_opt_state(cfg, tp))
    assert torch.equal(new["b"], tp["b"])
    assert (new["w"].abs() < tp["w"].abs()).all()
    assert (new["layers"]["ln"].abs() < tp["layers"]["ln"].abs()).all()


def test_quantize_int8_with_error_feedback_is_bit_identical():
    rng = np.random.default_rng(0)
    g = (rng.normal(size=(257,)) * 1e-3).astype(np.float32)
    # a scale of exactly 2**-7, so three scaled values are ties (2.5,
    # 3.5, -0.5), which both packages round to even
    g[:4] = np.array([127.0, 2.5, 3.5, -0.5], np.float32) * 2.0 ** -7
    first = ts.quantize_int8(torch.tensor(g), torch.zeros(257))[0]
    assert (first[1:4] * 2 ** 7).tolist() == [2.0, 4.0, -0.0]
    terr, rerr = torch.zeros(257), jnp.zeros(257, jnp.float32)
    for _ in range(5):
        tq, terr = ts.quantize_int8(torch.tensor(g), terr)
        rq, rerr = ref_ts.quantize_int8(jnp.asarray(g), rerr)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(terr.numpy(), np.asarray(rerr))


@functools.lru_cache(maxsize=None)
def _ref_train(n_micro, compress, steps=2):
    """The reference's 2 steps on qwen3-0.6b reduced (float32 compute):
    its metrics and its parameters after each step, as numpy."""
    rcfg = dataclasses.replace(ref_config("qwen3-0.6b", reduced=True),
                               compute_dtype="float32")
    opt = ref_opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = jax.jit(ref_ts.make_train_step(rcfg, opt, remat="dots",
                                          n_micro=n_micro,
                                          compress_grads=compress))
    p = jax.tree.map(jnp.asarray, ref_params("qwen3-0.6b"))
    o = ref_opt.init_opt_state(opt, p)
    shape = RefShape("t", 16, 4, "train")
    out = []
    for s in range(steps):
        batch = jax.tree.map(np.asarray, ref_pipeline.batch_for_step(
            rcfg, shape, s))
        p, o, m = step(p, o, jax.tree.map(jnp.asarray, batch))
        out.append((batch, {k: float(v) for k, v in m.items()},
                    jax.tree.map(np.asarray, p)))
    return out


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("compress", [False, True])
def test_make_train_step_equals_the_reference(n_micro, compress):
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              compute_dtype="float32")
    opt = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = ts.make_train_step(cfg, opt, remat="dots", n_micro=n_micro,
                              compress_grads=compress)
    p = _to_torch(ref_params("qwen3-0.6b"))
    o = opt_mod.init_opt_state(opt, p)
    ref = _ref_train(n_micro, compress)
    for i, (batch, want_m, want_p) in enumerate(ref):
        tb = {k: torch.tensor(v) for k, v in batch.items()}
        before = {k: v.clone() for k, v in leaves((p, o, tb)).items()}
        p2, o2, m = step(p, o, tb)
        # the step is functional: its inputs are unchanged
        for k, v in leaves((p, o, tb)).items():
            assert torch.equal(v, before[k]), k
        p, o = p2, o2
        assert int(m["step"]) == want_m["step"] == i + 1
        assert rel(m["loss"], want_m["loss"]) <= 1e-5
        assert rel(m["grad_norm"], want_m["grad_norm"]) <= 1e-4
        assert ("err" in o) == compress
        got, want = leaves(p), leaves(want_p)
        close = total = 0
        for k in want:
            d = np.abs(as_np(got[k]).astype(np.float64) - want[k])
            assert d.max() <= 2 * opt.lr * (i + 1), k
            close += int((d <= 1e-5 * max(np.abs(want[k]).max(),
                                          1e-30)).sum())
            total += d.size
        assert close >= 0.99 * total, close / total


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "musicgen-large",
                                  "paligemma-3b"])
@pytest.mark.parametrize("num_hosts", [1, 2])
def test_batch_for_step_matches_the_reference_layout(arch, num_hosts):
    cfg = get_config(arch, reduced=True)
    rcfg = ref_config(arch, reduced=True)
    shape = ShapeConfig("t", 12, 4, "train")
    want = ref_pipeline.batch_for_step(rcfg, RefShape("t", 12, 4, "train"),
                                       3, host=num_hosts - 1,
                                       num_hosts=num_hosts, seed=5)
    got = pipeline.batch_for_step(cfg, shape, 3, host=num_hosts - 1,
                                  num_hosts=num_hosts, seed=5, device=CPU)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).replace("torch.", "") == str(v.dtype), k
        assert got[k].device == CPU
    if "tokens" in got:
        assert torch.equal(got["tokens"][:, 1:], got["labels"][:, :-1])
    for k in ("tokens", "labels"):
        if k in got:
            assert 0 <= int(got[k].min()) and int(got[k].max()) < cfg.vocab
    again = pipeline.batch_for_step(cfg, shape, 3, host=num_hosts - 1,
                                    num_hosts=num_hosts, seed=5, device=CPU)
    assert all(torch.equal(again[k], got[k]) for k in got)
    for other in (dict(step=4, host=num_hosts - 1),
                  dict(step=3, host=num_hosts % 2), dict(step=3, seed=6)):
        kw = dict(host=num_hosts - 1, num_hosts=2, seed=5)
        kw.update({k: v for k, v in other.items() if k != "step"})
        b = pipeline.batch_for_step(cfg, shape, other["step"], device=CPU,
                                    **kw)
        mine = pipeline.batch_for_step(cfg, shape, 3, host=num_hosts - 1,
                                       num_hosts=2, seed=5, device=CPU)
        assert any(not torch.equal(b[k], mine[k]) for k in b), other


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "musicgen-large",
                                  "paligemma-3b"])
def test_decode_batch_matches_the_reference_layout(arch):
    cfg = get_config(arch, reduced=True)
    want = ref_pipeline.decode_batch(ref_config(arch, reduced=True), 3)
    got = pipeline.decode_batch(cfg, 3, device=CPU)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape
        assert str(got[k].dtype).replace("torch.", "") == str(v.dtype)


def _shapes(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in leaves(tree).items()}


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_input_specs_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for name, seq, batch, kind in (("t", 4096, 256, "train"),
                                   ("p", 1024, 4, "prefill"),
                                   ("d", 2048, 8, "decode")):
        got = specs.input_specs(cfg, ShapeConfig(name, seq, batch, kind))
        want = ref_specs.input_specs(rcfg, RefShape(name, seq, batch, kind))
        assert got.keys() == want.keys()
        assert all(t.device.type == "meta" for t in leaves(got).values())
        for k in got:
            assert _shapes(got[k]) == _shapes(want[k]), (arch, kind, k)


def test_train_step_leaves_no_tensor_in_a_reference_cycle():
    """A step's tensors are freed when it returns, not when Python's cycle
    collector next runs (a recursive closure in the tree helpers once kept
    each step's gradient list alive that way)."""
    import gc

    cfg = get_config("qwen3-0.6b", reduced=True)
    opt = opt_mod.AdamWConfig()
    step = ts.make_train_step(cfg, opt, remat="none", n_micro=2,
                              compress_grads=True)
    p = _to_torch(ref_params("qwen3-0.6b"))
    o = opt_mod.init_opt_state(opt, p)
    batch = pipeline.batch_for_step(cfg, ShapeConfig("t", 16, 4, "train"), 0,
                                    device=CPU)
    gc.collect()
    gc.disable()
    try:
        out = step(p, o, batch)
        del out
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cyclic = [x for x in gc.garbage if isinstance(x, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
        gc.collect()
    assert not cyclic, [tuple(t.shape) for t in cyclic][:5]
