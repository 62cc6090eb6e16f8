"""The port's language models against the reference's, on the CPU.

For every registered architecture at its reduced configuration:

* ``init_params``'s tree has the reference's paths, shapes and dtypes
  (``jax.eval_shape`` of the reference's), at the reduced and at the full
  configuration (the port's tree as meta tensors: ``gen=None``);
* on the reference's parameters carried across, ``forward`` over 8
  tokens, then a cached prefill of 6 and two ``decode_step``s, give the
  reference's logits: within ``TOL["float32"]`` (1e-5) of the reference's
  largest logit in float32 compute with float32 caches, and within
  ``TOL["bfloat16"]`` (3e-2) in the configs' bfloat16 compute with
  bfloat16 caches (bfloat16 keeps 8 significant bits, so one rounding is
  up to 0.4% of a value; the two packages round different partial
  results, and 1.8% of the largest logit was the largest gap seen at
  these sizes). The caches after the last step are held to the same
  bounds. The stub frontends get the batch ``tests/test_arch_smoke.py``
  builds: frames, or patches with every step.

Also: a MoE stack of zero layers (deepseek with only its dense layer),
``remat`` refused as the training slice's, and token ids outside the
vocabulary refused. The reference's functions are jitted once per
architecture and shape.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402

B, S, PREFILL, MAX_SEQ = 2, 8, 6, 64
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _leaves(tree, prefix=""):
    """{path: leaf} of nested dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}"))
    return out


def _flat(tree):
    """{path: (shape, dtype name)} of a tree of arrays or tensors."""
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _leaves(tree).items()}


def _rel(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def make_batch(cfg, s, seed=0):
    """``tests/test_arch_smoke.py``'s batch (without labels), as numpy."""
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.frontend == "encodec_stub":
        b["frames"] = rng.normal(size=(B, s, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    if cfg.frontend == "siglip_stub":
        b["patches"] = rng.normal(
            size=(B, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
    return b


def _steps(batch):
    """The prefill's batch, then each decode step's (the stubs' patches
    go with every step)."""
    seq = {k: v for k, v in batch.items() if k != "patches"}
    fixed = {k: v for k, v in batch.items() if k == "patches"}
    cuts = [(0, PREFILL)] + [(i, i + 1) for i in range(PREFILL, S)]
    return [dict({k: v[:, lo:hi] for k, v in seq.items()}, **fixed)
            for lo, hi in cuts]


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = ref_config(arch, reduced=True)
    return jax.tree.map(np.asarray, jax.jit(functools.partial(
        RM.init_params, cfg))(jax.random.PRNGKey(0)))


def _trees_rel(got, want) -> float:
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    return max((_rel(got[k], want[k]) for k in want
                if np.asarray(want[k]).dtype.kind == "f"), default=0.0)


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("reduced", [True, False])
def test_init_params_tree_equals_the_reference(arch, reduced):
    cfg = get_config(arch, reduced=reduced)
    want = _flat(jax.eval_shape(
        lambda k: RM.init_params(ref_config(arch, reduced=reduced), k),
        jax.random.PRNGKey(0)))
    if reduced:
        tree = TM.init_params(cfg, torch.Generator().manual_seed(0))
        assert all(t.device.type == "cpu" for t in _leaves(tree).values())
    else:
        tree = TM.init_params(cfg, None)           # meta: shapes only
    assert _flat(tree) == want


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_forward_and_decode_equal_the_reference(arch, compute):
    rcfg = dataclasses.replace(ref_config(arch, reduced=True),
                               compute_dtype=compute)
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype=compute)
    rp = _ref_params(arch)
    tp = params_from_numpy(rp, device="cpu")
    batch = make_batch(cfg, S)
    to_j = lambda b: {k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731
    to_t = lambda b: {k: torch.tensor(v) for k, v in b.items()}  # noqa: E731
    tol = TOL[compute]

    want, _ = jax.jit(functools.partial(RM.forward, rcfg))(rp, to_j(batch))
    got, none = TM.forward(cfg, tp, to_t(batch))
    assert none is None and got.dtype == cfg.cdtype
    assert _rel(got.float(), want) <= tol

    rc = RM.init_caches(rcfg, B, MAX_SEQ, dtype=getattr(jnp, compute))
    tc = TM.init_caches(cfg, B, MAX_SEQ, dtype=getattr(torch, compute),
                        device="cpu")
    ref_fwd = jax.jit(lambda p, b, c: RM.forward(rcfg, p, b, c))
    ref_dec = jax.jit(lambda p, c, b: RM.decode_step(rcfg, p, c, b))
    steps = _steps(batch)
    want, rc = ref_fwd(rp, to_j(steps[0]), rc)
    got, tc = TM.forward(cfg, tp, to_t(steps[0]), tc)
    assert _rel(got.float(), want) <= tol
    for step in steps[1:]:
        want, rc = ref_dec(rp, rc, to_j(step))
        got, tc = TM.decode_step(cfg, tp, tc, to_t(step))
        assert got.shape == (B, cfg.vocab)
        assert _rel(got.float(), want) <= tol
    assert _trees_rel(tc, jax.tree.map(np.asarray, rc)) <= tol


def test_moe_stack_of_zero_layers():
    """deepseek with its one dense layer and no MoE layer: the empty stack
    is built, run and cached, as the reference's."""
    rcfg = dataclasses.replace(ref_config("deepseek-v3-671b", reduced=True),
                               n_layers=1, compute_dtype="float32")
    cfg = dataclasses.replace(get_config("deepseek-v3-671b", reduced=True),
                              n_layers=1, compute_dtype="float32")
    rp = jax.tree.map(np.asarray, jax.jit(functools.partial(
        RM.init_params, rcfg))(jax.random.PRNGKey(0)))
    assert _flat(TM.init_params(cfg, torch.Generator())) == _flat(rp)
    tp = params_from_numpy(rp, device="cpu")
    assert tp["layers"]["moe"]["w_gate"].shape[0] == 0
    tokens = make_batch(cfg, S)["tokens"]
    want, _ = jax.jit(functools.partial(RM.forward, rcfg))(
        rp, {"tokens": jnp.asarray(tokens)})
    got, _ = TM.forward(cfg, tp, {"tokens": torch.tensor(tokens)})
    assert _rel(got, want) <= TOL["float32"]
    tc = TM.init_caches(cfg, B, MAX_SEQ, device="cpu")
    assert tc["layers"]["c_kv"].shape[0] == 0
    _, tc2 = TM.forward(cfg, tp, {"tokens": torch.tensor(tokens)}, tc)
    assert tc2["layers"]["c_kv"].shape[0] == 0
    assert tc2["dense_layers"]["pos"].tolist() == [[S, S]]


def test_remat_and_out_of_range_tokens_are_refused():
    cfg = get_config("qwen3-0.6b", reduced=True)
    tp = TM.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="training slice"):
        TM.forward(cfg, tp, {"tokens": tokens}, remat="full")
    TM.forward(cfg, tp, {"tokens": tokens}, remat="none")
    for bad in (-1, cfg.vocab):
        with pytest.raises(ValueError, match="token ids"):
            TM.forward(cfg, tp, {"tokens": tokens + bad})
