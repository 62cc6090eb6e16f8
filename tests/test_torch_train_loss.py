"""The port's loss and gradients against the reference's, on the CPU.

* ``cross_entropy`` with and without a mask: within 1e-6 (relative).
* ``loss_fn`` and its gradients with respect to every parameter, for
  each registered architecture at its reduced configuration, on the
  reference's own parameters (``params_from_numpy``) and one batch of
  (2, 16) tokens (frames or patches for the stubs) drawn with numpy. In
  float32 compute: the loss within ``F32_LOSS`` (1e-5) relative, each
  gradient leaf within ``F32_GRAD`` (1e-4) of that leaf's largest
  magnitude. In the configs' bfloat16 compute: the loss and the global
  gradient norm within ``BF16`` (3e-2) relative (bfloat16 keeps 8
  significant bits; the packages round different partial results, as in
  ``tests/test_torch_lm_model.py``).
* ``remat`` ``"none"``, ``"dots"`` and ``"full"`` give the port
  bit-identical losses and gradients, one architecture of each family
  (xlstm's loop is never checkpointed; each layer recomputes the same
  operations on the same inputs), and under ``"dots"`` and ``"full"``
  qwen3-0.6b's are held to the reference's under the same policy, at the
  same tolerances.

Half the architectures are here, half in
``tests/test_torch_train_loss_more.py``, so that neither file holds a
worker for long; each reference gradient is jitted and computed once.
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
from repro.models import common as RC  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.train.optimizer import global_norm as ref_global_norm  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402
from repro_torch.train.optimizer import global_norm  # noqa: E402
from repro_torch.train.train_step import (remat_loss_fn,  # noqa: E402
                                          value_and_grad)

B, S = 2, 16
F32_LOSS, F32_GRAD, BF16 = 1e-5, 1e-4, 3e-2
ARCHS = sorted(list_archs())
HALF = ARCHS[:len(ARCHS) // 2]


def leaves(tree, prefix=""):
    """{path: leaf} of nested dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(leaves(v, f"{prefix}/{k}"))
    return out


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    return np.asarray(x)


def rel(got, want) -> float:
    got, want = as_np(got).astype(np.float64), as_np(want).astype(np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def cfgs(arch, compute):
    return (dataclasses.replace(ref_config(arch, reduced=True),
                                compute_dtype=compute),
            dataclasses.replace(get_config(arch, reduced=True),
                                compute_dtype=compute))


def make_batch(cfg, b=B, s=S, seed=0):
    """A training batch as numpy: tokens (frames for the audio stub),
    patches for the vision stub, labels."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "encodec_stub":
        out["frames"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.frontend == "siglip_stub":
        out["patches"] = rng.normal(
            size=(b, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
    out["labels"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return out


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    cfg = ref_config(arch, reduced=True)
    return jax.tree.map(np.asarray, jax.jit(functools.partial(
        RM.init_params, cfg))(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def ref_value_and_grad(arch, compute, remat=None):
    """The reference's (loss, gradient tree) as numpy, computed once."""
    rcfg, _ = cfgs(arch, compute)
    batch = {k: jnp.asarray(v) for k, v in make_batch(rcfg).items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: RM.loss_fn(rcfg, p, batch, remat=remat)))(ref_params(arch))
    return float(loss), float(ref_global_norm(grads)), \
        jax.tree.map(np.asarray, grads)


def port_value_and_grad(arch, compute, remat=None):
    """The port's (loss, {path: gradient}) on the reference's parameters."""
    _, cfg = cfgs(arch, compute)
    params = params_from_numpy(ref_params(arch), device="cpu")
    batch = {k: torch.tensor(v) for k, v in make_batch(cfg).items()}
    loss, grads = value_and_grad(remat_loss_fn(cfg, remat), params, batch)
    return loss, leaves(grads)


def check_against_reference(arch, compute, remat=None):
    want_loss, want_norm, want = ref_value_and_grad(arch, compute, remat)
    loss, grads = port_value_and_grad(arch, compute, remat)
    want = leaves(want)
    assert grads.keys() == want.keys()
    if compute == "float32":
        assert loss.dtype == torch.float32
        assert rel(loss, want_loss) <= F32_LOSS
        errs = {k: rel(grads[k], want[k]) for k in want}
        worst = max(errs, key=errs.get)
        assert errs[worst] <= F32_GRAD, (worst, errs[worst])
    else:
        assert rel(loss, want_loss) <= BF16
        assert rel(global_norm(list(grads.values())), want_norm) <= BF16
    return loss, grads


@pytest.mark.parametrize("with_mask", [False, True])
def test_cross_entropy_equals_the_reference(with_mask):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.5).astype(np.float32) if with_mask \
        else None
    want = RC.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    got = TC.cross_entropy(torch.tensor(logits), torch.tensor(labels),
                           None if mask is None else torch.tensor(mask))
    assert got.dtype == torch.float32
    assert rel(got, want) <= 1e-6
    # bfloat16 logits are taken to float32 first; an empty mask divides by 1
    got16 = TC.cross_entropy(torch.tensor(logits).bfloat16(),
                             torch.tensor(labels))
    want16 = RC.cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                              jnp.asarray(labels))
    assert rel(got16, want16) <= 1e-6
    zero = TC.cross_entropy(torch.tensor(logits), torch.tensor(labels),
                            torch.zeros((3, 7)))
    assert float(zero) == 0.0


@pytest.mark.parametrize("arch", HALF)
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_loss_and_gradients_equal_the_reference(arch, compute):
    check_against_reference(arch, compute)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "paligemma-3b",
                                  "musicgen-large", "moonshot-v1-16b-a3b",
                                  "deepseek-v3-671b", "xlstm-125m",
                                  "zamba2-2.7b"])
def test_remat_policies_are_bit_identical(arch):
    loss, grads = port_value_and_grad(arch, "float32", "none")
    for remat in ("dots", "full"):
        loss2, grads2 = port_value_and_grad(arch, "float32", remat)
        assert torch.equal(loss2, loss), remat
        for k, g in grads.items():
            assert torch.equal(grads2[k], g), (remat, k)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_equals_the_reference_under_the_same_policy(remat):
    check_against_reference("qwen3-0.6b", "float32", remat)


def test_unknown_remat_policy_is_refused():
    _, cfg = cfgs("qwen3-0.6b", "float32")
    params = params_from_numpy(ref_params("qwen3-0.6b"), device="cpu")
    batch = {k: torch.tensor(v) for k, v in make_batch(cfg).items()}
    with pytest.raises(ValueError, match="offload"):
        TM.loss_fn(cfg, params, batch, remat="offload")
