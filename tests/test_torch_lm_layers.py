"""The port's language-model layers against the reference's, on the CPU.

Parameters are the reference's own ``init_*`` draws carried across with
``params_from_numpy``; inputs are drawn from a numpy seed. Every layer
runs in float32 compute here, and its output must lie within ``TOL``
(1e-5) of the reference's, relative to the reference's largest
magnitude; the recurrences' states within the same bound of theirs.
Covered: ``rms_norm`` (with the Gemma offset), ``rope_angles`` and
``apply_rope``; attention with a sliding window, a prefix-LM mask and a
soft cap, with and without a cache; MLA with and without its latent
cache; ``chunked_gated_recurrence`` with S not a multiple of the chunk
and with ``h0``; ``gated_recurrence_step``; ``mamba2``, ``mlstm`` and
``slstm`` with and without a cache (a cached prefill, then one token).
A cache write past ``max_seq`` raises ``ValueError`` where the
reference's scatter would drop it. ``params_from_numpy`` carries lists
(xlstm's sLSTM layers). ``roofline.analysis`` gives the reference's
records when both get the same peaks.
"""
import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as ref_attn  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import mamba2 as ref_mamba  # noqa: E402
from repro.models import mla as ref_mla  # noqa: E402
from repro.models import ssm_common as ref_ssm  # noqa: E402
from repro.models import xlstm as ref_xlstm  # noqa: E402
from repro.roofline import analysis as ref_roof  # noqa: E402
from repro_torch.models import attention, common, mamba2, mla  # noqa: E402
from repro_torch.models import ssm_common, xlstm  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402
from repro_torch.roofline import analysis as roof  # noqa: E402

TOL = 1e-5
F32 = jnp.float32
KEY = jax.random.PRNGKey(0)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, np.float64)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _trees_close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _trees_close(got[k], want[k])
    else:
        _close(got, want)


def _carry(ref_params):
    return params_from_numpy(jax.tree.map(np.asarray, ref_params),
                             device="cpu")


def _jit(fn, **kw):
    """The reference's ``fn`` with its keyword arguments fixed, jitted (one
    XLA compile a shape, not one a primitive)."""
    return jax.jit(functools.partial(fn, **kw))


def _pair(rng, shape):
    """One float32 array as (jax, torch)."""
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a), torch.tensor(a)


# -- common ------------------------------------------------------------------

@pytest.mark.parametrize("offset", [False, True])
def test_rms_norm(offset):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, (3, 5, 16))
    wj, wt = _pair(rng, (16,))
    _close(common.rms_norm(xt, wt, add_unit_offset=offset),
           ref_common.rms_norm(xj, wj, add_unit_offset=offset))
    got = common.rms_norm(xt.bfloat16(), wt, add_unit_offset=offset)
    assert got.dtype == torch.bfloat16


def test_rope_rotates_halves():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    cj, sj = ref_common.rope_angles(jnp.asarray(pos), 32, 1e6)
    ct, st = common.rope_angles(torch.tensor(pos), 32, 1e6)
    _close(ct, cj)
    _close(st, sj)
    xj, xt = _pair(rng, (2, 7, 3, 32))
    _close(common.apply_rope(xt, ct, st), ref_common.apply_rope(xj, cj, sj))


# -- attention ---------------------------------------------------------------

ATTN_KW = dict(n_heads=4, n_kv=2, head_dim=16, rope_theta=1e4)


@pytest.mark.parametrize("qk_norm,window,prefix_len,soft_cap", [
    (False, None, None, None),
    (True, 5, None, None),
    (False, None, 4, None),
    (True, 6, 3, 30.0),
])
def test_attention_without_cache(qk_norm, window, prefix_len, soft_cap):
    rp = ref_attn.init_attention(KEY, 32, 4, 2, 16, F32, qk_norm=qk_norm)
    tp = _carry(rp)
    xj, xt = _pair(np.random.default_rng(2), (2, 11, 32))
    kw = dict(ATTN_KW, qk_norm=qk_norm, window=window, prefix_len=prefix_len,
              soft_cap=soft_cap)
    want, _ = _jit(ref_attn.attention, compute_dtype=F32, **kw)(rp, xj)
    got, cache = attention.attention(tp, xt, compute_dtype=torch.float32,
                                     **kw)
    assert cache is None
    _close(got, want)


@pytest.mark.parametrize("window,soft_cap", [(None, None), (4, 20.0)])
def test_attention_with_cache(window, soft_cap):
    """A cached prefill of 5 tokens, then two single tokens: outputs and
    caches as the reference's."""
    rp = ref_attn.init_attention(KEY, 32, 4, 2, 16, F32, qk_norm=True)
    tp = _carry(rp)
    kw = dict(ATTN_KW, qk_norm=True, window=window, soft_cap=soft_cap)
    xj, xt = _pair(np.random.default_rng(3), (2, 7, 32))
    rc = ref_attn.init_kv_cache(2, 12, 2, 16, F32)
    tc = attention.init_kv_cache(2, 12, 2, 16, torch.float32, device="cpu")
    ref = _jit(ref_attn.attention, compute_dtype=F32, **kw)
    for lo, hi in ((0, 5), (5, 6), (6, 7)):
        want, rc = ref(rp, xj[:, lo:hi], cache=rc)
        got, tc = attention.attention(tp, xt[:, lo:hi],
                                      compute_dtype=torch.float32, cache=tc,
                                      **kw)
        _close(got, want)
        _trees_close(tc, rc)
        assert tc["pos"].dtype == torch.int32


def test_cache_write_past_the_end_raises():
    tp = _carry(ref_attn.init_attention(KEY, 32, 4, 2, 16, F32))
    tc = attention.init_kv_cache(2, 6, 2, 16, device="cpu")
    x = torch.zeros((2, 4, 32))
    _, tc = attention.attention(tp, x, cache=tc, **ATTN_KW)
    with pytest.raises(ValueError, match="holds 6 tokens"):
        attention.attention(tp, x, cache=tc, **ATTN_KW)
    mc = mla.init_mla_cache(2, 3, 16, 8, device="cpu")
    mp = _carry(ref_mla.init_mla(KEY, 32, 4, q_lora_rank=24, kv_lora_rank=16,
                                 qk_nope_dim=8, rope_dim=8, v_head_dim=8))
    with pytest.raises(ValueError, match="holds 3 tokens"):
        mla.mla_attention(mp, x, n_heads=4, qk_nope_dim=8, rope_dim=8,
                          v_head_dim=8, kv_lora_rank=16, cache=mc)


# -- MLA ---------------------------------------------------------------------

MLA_DIMS = dict(qk_nope_dim=8, rope_dim=8, v_head_dim=12, kv_lora_rank=16)


@pytest.mark.parametrize("cached", [False, True])
def test_mla(cached):
    rp = ref_mla.init_mla(KEY, 32, 4, q_lora_rank=24, dtype=F32, **MLA_DIMS)
    tp = _carry(rp)
    xj, xt = _pair(np.random.default_rng(4), (2, 6, 32))
    kw = dict(n_heads=4, rope_theta=1e4, **MLA_DIMS)
    if not cached:
        want, _ = _jit(ref_mla.mla_attention, compute_dtype=F32,
                       **kw)(rp, xj)
        got, cache = mla.mla_attention(tp, xt, compute_dtype=torch.float32,
                                       **kw)
        assert cache is None
        _close(got, want)
        return
    rc = ref_mla.init_mla_cache(2, 10, 16, 8, F32)
    tc = mla.init_mla_cache(2, 10, 16, 8, torch.float32, device="cpu")
    ref = _jit(ref_mla.mla_attention, compute_dtype=F32, **kw)
    for lo, hi in ((0, 4), (4, 5), (5, 6)):
        want, rc = ref(rp, xj[:, lo:hi], cache=rc)
        got, tc = mla.mla_attention(tp, xt[:, lo:hi],
                                    compute_dtype=torch.float32, cache=tc,
                                    **kw)
        _close(got, want)
        _trees_close(tc, rc)


# -- the gated recurrence ----------------------------------------------------

def _recurrence_inputs(seed, s, h=3, dk=5, dv=4):
    rng = np.random.default_rng(seed)
    q, k = rng.normal(size=(2, 2, s, h, dk)).astype(np.float32)
    v = rng.normal(size=(2, s, h, dv)).astype(np.float32)
    log_decay = -rng.uniform(0, 1, (2, s, h)).astype(np.float32)
    beta = rng.uniform(0, 1, (2, s, h)).astype(np.float32)
    h0 = rng.normal(size=(2, h, dk, dv)).astype(np.float32)
    return q, k, v, log_decay, beta, h0


@pytest.mark.parametrize("s,chunk,with_h0", [(19, 8, False), (19, 8, True),
                                             (16, 8, True), (5, 64, False)])
def test_chunked_gated_recurrence(s, chunk, with_h0):
    *args, h0 = _recurrence_inputs(5, s)
    want_y, want_h = _jit(ref_ssm.chunked_gated_recurrence, chunk=chunk)(
        *map(jnp.asarray, args), h0=jnp.asarray(h0) if with_h0 else None)
    got_y, got_h = ssm_common.chunked_gated_recurrence(
        *map(torch.tensor, args), chunk=chunk,
        h0=torch.tensor(h0) if with_h0 else None)
    assert got_y.dtype == got_h.dtype == torch.float32
    _close(got_y, want_y)
    _close(got_h, want_h)


def test_gated_recurrence_step():
    q, k, v, log_decay, beta, h0 = _recurrence_inputs(6, 1)
    args = (h0, q[:, 0], k[:, 0], v[:, 0], log_decay[:, 0], beta[:, 0])
    want_y, want_h = ref_ssm.gated_recurrence_step(*map(jnp.asarray, args))
    got_y, got_h = ssm_common.gated_recurrence_step(*map(torch.tensor, args))
    _close(got_y, want_y)
    _close(got_h, want_h)


# -- SSM blocks --------------------------------------------------------------

def _block_case(name):
    """(reference fn, port fn, reference params, keyword args, reference
    cache, port cache) of one SSM block at reduced widths."""
    if name == "mamba2":
        kw = dict(expand=2, headdim=8, d_state=8, chunk=4)
        rp = ref_mamba.init_mamba2(KEY, 16, expand=2, headdim=8, d_state=8)
        # the reference starts A_log and dt_bias at zero; move them so the
        # decay differs between heads
        rng = np.random.default_rng(7)
        rp = dict(rp, A_log=jnp.asarray(rng.normal(size=4), F32),
                  dt_bias=jnp.asarray(rng.normal(size=4), F32))
        return (ref_mamba.mamba2, mamba2.mamba2, rp, kw,
                ref_mamba.init_mamba2_cache(2, 16, expand=2, headdim=8,
                                            d_state=8, dtype=F32),
                mamba2.init_mamba2_cache(2, 16, expand=2, headdim=8,
                                         d_state=8, dtype=torch.float32,
                                         device="cpu"))
    if name == "mlstm":
        rp = ref_xlstm.init_mlstm(KEY, 16, 2)
        return (ref_xlstm.mlstm, xlstm.mlstm, rp, dict(n_heads=2, chunk=4),
                ref_xlstm.init_mlstm_cache(2, 16, 2),
                xlstm.init_mlstm_cache(2, 16, 2, device="cpu"))
    rp = ref_xlstm.init_slstm(KEY, 16, 2)
    return (ref_xlstm.slstm, xlstm.slstm, rp, dict(n_heads=2),
            ref_xlstm.init_slstm_cache(2, 16, 2),
            xlstm.init_slstm_cache(2, 16, 2, device="cpu"))


@pytest.mark.parametrize("name", ["mamba2", "mlstm", "slstm"])
@pytest.mark.parametrize("cached", [False, True])
def test_ssm_block(name, cached):
    ref_fn, fn, rp, kw, rc, tc = _block_case(name)
    tp = _carry(rp)
    xj, xt = _pair(np.random.default_rng(8), (2, 10, 16))
    ref = _jit(ref_fn, compute_dtype=F32, **kw)
    if not cached:
        want, _ = ref(rp, xj)
        got, cache = fn(tp, xt, compute_dtype=torch.float32, **kw)
        assert cache is None
        _close(got, want)
        return
    # a cached prefill of 7 (not a whole number of chunks), then tokens
    for lo, hi in ((0, 7), (7, 8), (8, 9)):
        want, rc = ref(rp, xj[:, lo:hi], cache=rc)
        got, tc = fn(tp, xt[:, lo:hi], compute_dtype=torch.float32,
                     cache=tc, **kw)
        _close(got, want)
        _trees_close(tc, rc)


# -- carrying trees, roofline ------------------------------------------------

def test_params_from_numpy_carries_lists_and_dicts():
    tree = {"a": np.ones((2, 3), np.float32),
            "l": [{"w": np.zeros(4, np.float32)}, {"w": np.arange(3)}]}
    got = params_from_numpy(tree, device="cpu", dtype=torch.float64)
    assert isinstance(got["l"], list) and len(got["l"]) == 2
    assert got["a"].dtype == got["l"][0]["w"].dtype == torch.float64
    assert got["l"][1]["w"].dtype == torch.int64          # ints kept
    assert torch.equal(got["l"][1]["w"], torch.arange(3))


@pytest.mark.parametrize("flops,nbytes,peak,bw", [
    (2e9, 1e6, 989e12, 3.35e12), (1e6, 5e9, 67e12, 3.35e12),
    (0.0, 0.0, 165e12, 3.35e12), (3e12, 0.0, 197e12, 819e9)])
def test_kernel_roofline_equals_the_reference(flops, nbytes, peak, bw):
    assert roof.kernel_roofline(flops, nbytes, peak_flops=peak,
                                hbm_bw=bw) == ref_roof.kernel_roofline(
        flops, nbytes, peak_flops=peak, hbm_bw=bw)
    for kind in ("train", "decode", "prefill"):
        assert roof.model_flops(751_632_384, 64, kind) == \
            ref_roof.model_flops(751_632_384, 64, kind)
    assert roof.H100_3XTF32_FLOPS == 165e12
