"""The port's block-sparse (``b``-format) path against the reference's.

* The pattern half of ``core/bsr_bridge`` (``bsr_pattern``, ``_blockify``,
  ``_mask_block_size``, ``_kv_index``) and the BCSR bookkeeping of
  ``kernels/ops`` (``bsr_from_block_coords``, ``sliding_window_kv_idx``)
  equal the reference's exactly, so both packages feed their kernels the
  same arrays.
* Each kernel's plain PyTorch version (what its wrapper runs on a CPU
  tensor) matches the reference Pallas kernel in interpret mode, with the
  tolerances of ``tests/test_kernels.py`` (float32 and bfloat16, causal,
  block sizes 1 to 32, extents that are not multiples of 128).
* ``compile_expr(..., device="cpu")`` routes the three patterns to a
  ``BsrEngine`` whose results equal the reference ``compile_expr``'s:
  exactly for integer-valued SpMM and SDDMM (float32 through the kernels'
  plain versions, float64 through the numpy fallback), within 1e-5 for
  attention. A ``b``-format expression that matches no pattern is refused
  by both.
* A query row whose every kv block is masked comes out as zeros in the
  port, in ``repro/kernels/ref.py`` and in the reference's float64
  fallback; the reference's float32 kernel path returns the mean of V's
  last kv block there instead (ROADMAP.md, queue 3).

The CUDA kernels themselves are held against their plain versions on the
card in ``test_torch_gpu.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import bsr_bridge as rbb  # noqa: E402
from repro.core import jax_backend as rjb  # noqa: E402
from repro.core.einsum import parse as rparse  # noqa: E402
from repro.core.schedule import Format as RFormat  # noqa: E402
from repro.core.schedule import Schedule as RSchedule  # noqa: E402
from repro.kernels import ops as rkops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.core import bsr_bridge as bb  # noqa: E402
from repro_torch.core import torch_backend as tb  # noqa: E402
from repro_torch.core.einsum import parse  # noqa: E402
from repro_torch.core.schedule import Format, Schedule  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.bsr_attention import bsr_flash_attention  # noqa: E402
from repro_torch.kernels.sddmm_bsr import sddmm_bsr  # noqa: E402
from repro_torch.kernels.spmm_bsr import spmm_bsr  # noqa: E402

SPMM = "x(i,k) = B(i,j) * C(j,k)"
SDDMM = "X(i,j) = M(i,j) * A(i,k) * C(j,k)"
ATTN = "O(i,d) = M(i,j) * Q(i,e) * K(j,e) * V(j,d)"
TORCH_DT = {np.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def close(ref, got, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)


# -- the pattern half -------------------------------------------------------

PATTERNS = [  # (expression, formats); four of them match no pattern
    (SPMM, {"B": "bb"}),
    ("x(i,k) = B(i,j) * C(k,j)", {"B": "bb"}),
    ("x(i,k) = B(i,j) * C(j,k)", {"B": "bb", "C": "dc"}),
    (SDDMM, {"M": "bb"}),
    ("X(i,j) = M(i,j) * A(k,i) * C(k,j)", {"M": "bb"}),
    (ATTN, {"M": "bb"}),
    ("O(i,d) = M(i,j) * Q(e,i) * K(e,j) * V(d,j)", {"M": "bb"}),
    (SPMM, {"B": "cc"}),
    ("x(i) = B(i,j) * c(j)", {"B": "bb"}),
    ("X(i,j) = B(i,j) + C(i,j)", {"B": "bb"}),
    (SPMM, {"B": "bb", "C": "bb"}),
    ("X(i,j) = M(i,j) * A(i,k) * C(k,j)", {"M": "bb"}),
]


@pytest.mark.parametrize("expr,fmts", PATTERNS)
def test_bsr_pattern_equals_reference(expr, fmts):
    want = rbb.bsr_pattern(rparse(expr), RFormat(dict(fmts)))
    got = bb.bsr_pattern(parse(expr), Format(dict(fmts)))
    if want is None:
        assert got is None
    else:
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("shape,bs,density,seed", [
    ((16, 24), 8, 0.3, 0), ((12, 20), 4, 0.5, 1), ((7, 5), 1, 0.4, 2),
    ((32, 32), 16, 0.0, 3)])
def test_blockify_and_block_maps_equal_reference(shape, bs, density, seed):
    rng = np.random.default_rng(seed)
    nb = (shape[0] // bs, shape[1] // bs)
    keep = rng.random(nb) < density
    m = np.kron(keep, rng.integers(1, 4, (bs, bs))).astype(np.float32)
    m[0, 0] = 0.0           # a block that is not uniform, where kept
    for a, b in zip(rbb._blockify(m, bs), bb._blockify(m, bs)):
        np.testing.assert_array_equal(a, b)
    assert bb._mask_block_size(m) == rbb._mask_block_size(m)
    assert (bb._pow2_divisor(np.gcd(*shape), 128)
            == rbb._pow2_divisor(np.gcd(*shape), 128))
    rows, cols, blocks = bb._blockify(m, bs)
    np.testing.assert_array_equal(bb._kv_index(rows, cols, *nb),
                                  rbb._kv_index(rows, cols, *nb))
    for a, b in zip(rkops.bsr_from_block_coords(rows, cols, blocks, nb[0]),
                    kops.bsr_from_block_coords(rows, cols, blocks, nb[0])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_q,n_kv,window,causal", [
    (8, 8, 3, True), (8, 8, 4, False), (5, 9, 2, True), (64, 64, 32, True)])
def test_sliding_window_kv_idx_equals_reference(n_q, n_kv, window, causal):
    np.testing.assert_array_equal(
        kops.sliding_window_kv_idx(n_q, n_kv, window, causal),
        rkops.sliding_window_kv_idx(n_q, n_kv, window, causal))


# -- each plain kernel version against the Pallas kernel --------------------

RNG = np.random.default_rng(3)


def random_bsr(n_brow, n_bcol, bs, density):
    mask = RNG.random((n_brow, n_bcol)) < density
    rows, cols = np.nonzero(mask)
    if len(rows) == 0:
        rows, cols = np.array([0]), np.array([0])
    return rows, cols, RNG.normal(size=(len(rows), bs, bs)).astype(np.float32)


@pytest.mark.parametrize("bs,n_brow,n_bcol,n,dtype", [
    (8, 4, 3, 128, np.float32),
    (16, 3, 5, 256, np.float32),
    (8, 2, 2, 128, jnp.bfloat16),
    (32, 5, 4, 128, np.float32),
    (1, 9, 7, 96, np.float32),          # 1x1 blocks, N not a multiple of 128
    (8, 3, 4, 40, jnp.bfloat16),
])
def test_spmm_plain_matches_pallas(bs, n_brow, n_bcol, n, dtype):
    rows, cols, blocks = random_bsr(n_brow, n_bcol, bs, 0.5)
    blocks = np.asarray(jnp.asarray(blocks, dtype))
    c = np.asarray(jnp.asarray(RNG.normal(size=(n_bcol * bs, n)), dtype))
    bm, ci, bp = kops.bsr_from_block_coords(rows, cols, blocks, n_brow)
    want = rkops.spmm_bsr(bm, ci, bp, c, n_tile=bb._pow2_divisor(n, 128),
                          interpret=True)
    tdt = TORCH_DT[dtype]
    got = spmm_bsr(t(bm), t(ci), t(bp.astype(np.float32)).to(tdt),
                   t(c.astype(np.float32)).to(tdt))
    assert got.dtype == tdt and got.shape == want.shape
    close(want, got, 1e-5 if dtype == np.float32 else 2e-2)


@pytest.mark.parametrize("bs,m_blk,n_blk,k,dtype", [
    (8, 3, 4, 128, np.float32),
    (16, 2, 2, 256, np.float32),
    (8, 4, 3, 128, jnp.bfloat16),
    (1, 6, 5, 24, np.float32),          # 1x1 blocks, K not a multiple of 128
    (32, 2, 3, 80, np.float32),
])
def test_sddmm_plain_matches_pallas(bs, m_blk, n_blk, k, dtype):
    mask = RNG.random((m_blk, n_blk)) < 0.6
    rows, cols = np.nonzero(mask)
    if len(rows) == 0:
        rows, cols = np.array([0]), np.array([0])
    a = np.asarray(jnp.asarray(RNG.normal(size=(m_blk * bs, k)), dtype))
    b = np.asarray(jnp.asarray(RNG.normal(size=(n_blk * bs, k)), dtype))
    want = rkops.sddmm_bsr(rows.astype(np.int32), cols.astype(np.int32), a,
                           b, bs, k_tile=bb._pow2_divisor(k, 128),
                           interpret=True)
    tdt = TORCH_DT[dtype]
    got = sddmm_bsr(t(rows.astype(np.int32)), t(cols.astype(np.int32)),
                    t(a.astype(np.float32)).to(tdt),
                    t(b.astype(np.float32)).to(tdt), bs)
    assert got.dtype == tdt and got.shape == want.shape
    close(want, got, 1e-4 if dtype == np.float32 else 5e-2)


def random_kv_idx(n_blk, causal):
    """A random block mask with the diagonal, so no row is fully masked
    (the reference kernel differs from its oracle there)."""
    kv_idx = np.full((n_blk, n_blk), n_blk, dtype=np.int32)
    for qi in range(n_blk):
        hi = qi + 1 if causal else n_blk
        picks = sorted(set([qi] + list(RNG.choice(hi, size=min(2, hi),
                                                  replace=False))))
        kv_idx[qi, :len(picks)] = picks
    return kv_idx


@pytest.mark.parametrize("bq,s,d,causal,dtype", [
    (8, 64, 32, False, np.float32),
    (8, 64, 32, True, np.float32),
    (16, 128, 64, True, np.float32),
    (8, 64, 32, True, jnp.bfloat16),
    (1, 12, 8, True, np.float32),       # 1-row blocks
    (32, 96, 20, False, np.float32),
])
def test_attention_plain_matches_pallas(bq, s, d, causal, dtype):
    bh = 2
    q, k, v = (np.asarray(jnp.asarray(RNG.normal(size=(bh, s, d)), dtype))
               for _ in range(3))
    kv_idx = random_kv_idx(s // bq, causal)
    want = rkops.bsr_flash_attention(q, k, v, kv_idx, bq=bq, bkv=bq,
                                     causal=causal, interpret=True)
    tdt = TORCH_DT[dtype]
    got = bsr_flash_attention(*(t(x.astype(np.float32)).to(tdt)
                                for x in (q, k, v)), t(kv_idx), bq=bq,
                              bkv=bq, causal=causal)
    assert got.dtype == tdt
    close(want, got, 2e-5 if dtype == np.float32 else 3e-2)


# -- compile_expr end to end --------------------------------------------------

def _case(kind, dtype, seed):
    """(expression, formats, dims, arrays) with integer values for SpMM and
    SDDMM and a block-causal mask for attention."""
    rng = np.random.default_rng(seed)
    if kind == "spmm":
        b = (rng.integers(-3, 4, (16, 24)) * np.kron(
            rng.random((4, 6)) < 0.4, np.ones((4, 4)))).astype(dtype)
        arrays = {"B": b, "C": rng.integers(-3, 4, (10, 24)).astype(dtype)}
        return ("x(i,k) = B(i,j) * C(k,j)", {"B": "bb", "x": "dd"},
                {"i": 16, "j": 24, "k": 10}, arrays)
    if kind == "sddmm":
        m = (rng.integers(1, 4, (16, 32)) * np.kron(
            rng.random((2, 4)) < 0.6, np.ones((8, 8)))).astype(dtype)
        arrays = {"M": m, "A": rng.integers(-3, 4, (16, 12)).astype(dtype),
                  "C": rng.integers(-3, 4, (32, 12)).astype(dtype)}
        return SDDMM, {"M": "bb", "X": "dd"}, {"i": 16, "j": 32, "k": 12}, \
            arrays
    s_q, s_kv, e = 32, 48, 8
    keep = np.tril(np.ones((4, 6)), k=2)
    arrays = {"M": np.kron(keep, np.ones((8, 8))).astype(dtype)}
    for name, rows in (("Q", s_q), ("K", s_kv), ("V", s_kv)):
        arrays[name] = rng.standard_normal((rows, e)).astype(dtype)
    return ATTN, {"M": "bb", "O": "dd"}, {"i": s_q, "j": s_kv, "e": e,
                                          "d": e}, arrays


def _engines(expr, fmts, dims):
    order = tuple(dims)
    ref = rjb.compile_expr(expr, RFormat(dict(fmts)),
                           RSchedule(loop_order=order), dims)
    got = tb.compile_expr(expr, Format(dict(fmts)),
                          Schedule(loop_order=order), dims, device="cpu")
    assert isinstance(ref, rbb.BsrEngine) and isinstance(got, bb.BsrEngine)
    return ref, got


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["spmm", "sddmm", "attention"])
def test_compile_expr_equals_reference(kind, dtype):
    expr, fmts, dims, arrays = _case(kind, dtype, seed=7)
    ref, got = _engines(expr, fmts, dims)
    before = got.stats["fallback_calls"]
    want = np.asarray(ref(arrays).to_dense())
    out = got(arrays)
    assert out.format_str == "dd"
    out = np.asarray(out.to_dense())
    assert out.dtype == want.dtype
    if kind == "attention":
        np.testing.assert_allclose(out, want, atol=1e-5, rtol=0)
    else:
        np.testing.assert_array_equal(out, want)
    assert set(got.stats) == set(ref.stats)
    for key in ("kernel", "block_size", "nnz_blocks"):
        assert got.stats[key] == ref.stats[key]
    assert got.stats["fallback_calls"] == before + (dtype != np.float32)
    assert tb.compile_expr(expr, Format(dict(fmts)),
                           Schedule(loop_order=tuple(dims)), dims,
                           device="cpu") is got


def test_f64_values_survive_the_bridge():
    tiny = 1.0 + 1e-12
    b = np.zeros((4, 4))
    b[0, 0] = b[2, 3] = tiny
    ref, got = _engines(SPMM, {"B": "bb"}, {"i": 4, "j": 4, "k": 4})
    arrays = {"B": b, "C": np.eye(4)}
    out = np.asarray(got(arrays).to_dense())
    assert out.dtype == np.float64
    np.testing.assert_array_equal(out, b)
    np.testing.assert_array_equal(out, ref(arrays).to_dense())


def test_attention_head_dims_that_differ_fall_back():
    rng = np.random.default_rng(4)
    dims = {"i": 16, "j": 16, "e": 4, "d": 6}
    arrays = {"M": np.kron(np.tril(np.ones((2, 2))), np.ones((8, 8))
                           ).astype(np.float32),
              "Q": rng.standard_normal((16, 4)).astype(np.float32),
              "K": rng.standard_normal((16, 4)).astype(np.float32),
              "V": rng.standard_normal((16, 6)).astype(np.float32)}
    ref, got = _engines(ATTN, {"M": "bb"}, dims)
    before = got.stats["fallback_calls"]
    np.testing.assert_allclose(got(arrays).to_dense(),
                               ref(arrays).to_dense(), atol=1e-6)
    assert got.stats["fallback_calls"] == before + 1


def test_unmatched_b_format_is_refused_by_both():
    fmt, dims = {"B": "bb"}, {"i": 8, "j": 8}
    arrays = {"B": np.eye(8), "c": np.ones(8)}
    ref = rjb.compile_expr("x(i) = B(i,j) * c(j)", RFormat(fmt),
                           RSchedule(loop_order=("i", "j")), dims)
    got = tb.compile_expr("x(i) = B(i,j) * c(j)", Format(fmt),
                          Schedule(loop_order=("i", "j")), dims,
                          device="cpu")
    assert not isinstance(got, bb.BsrEngine)
    for eng in (ref, got):
        with pytest.raises(NotImplementedError, match="not bitvector"):
            eng(arrays)


# -- the fully masked query block (ROADMAP.md, queue 3) ----------------------

def test_fully_masked_rows_are_zeros_where_the_reference_kernel_is_not():
    rng = np.random.default_rng(9)
    bh, s, d, bs = 1, 32, 16, 8
    q, k, v = (rng.standard_normal((bh, s, d)).astype(np.float32)
               for _ in range(3))
    kv_idx = random_kv_idx(s // bs, causal=False)
    kv_idx[0] = s // bs                             # q block 0: all sentinel
    got = bsr_flash_attention(t(q), t(k), t(v), t(kv_idx), bq=bs, bkv=bs)
    assert not got[0, :bs].any()
    oracle = np.asarray(rref.bsr_flash_attention_ref(q, k, v, kv_idx, bq=bs,
                                                     bkv=bs))
    np.testing.assert_array_equal(oracle[0, :bs], 0.0)
    np.testing.assert_allclose(got[0].numpy(), oracle[0], atol=2e-5)
    pallas = np.asarray(rkops.bsr_flash_attention(q, k, v, kv_idx, bq=bs,
                                                  bkv=bs, interpret=True))
    # the reference kernel: every row of the block = mean of V's last block
    np.testing.assert_allclose(
        pallas[0, :bs], np.broadcast_to(v[0, -bs:].mean(0), (bs, d)),
        atol=1e-5)
    np.testing.assert_allclose(pallas[0, bs:], oracle[0, bs:], atol=2e-5)

    # the same fault through compile_expr: a mask with an all-zero block
    # row, as from padded tokens
    m = np.ones((s, s))
    m[:bs] = 0.0
    dims = {"i": s, "j": s, "e": d, "d": d}
    arrays = {"M": m, "Q": q[0], "K": k[0], "V": v[0]}
    ref, eng = _engines(ATTN, {"M": "bb"}, dims)
    f64 = np.asarray(ref(arrays).to_dense())                # numpy fallback
    f32 = {n: a.astype(np.float32) for n, a in arrays.items()}
    ref32 = np.asarray(ref(f32).to_dense())                 # Pallas kernel
    for got in (eng(arrays), eng(f32)):
        got = np.asarray(got.to_dense())
        np.testing.assert_array_equal(got[:bs], 0.0)
        np.testing.assert_allclose(got, f64, atol=1e-5)
    np.testing.assert_array_equal(f64[:bs], 0.0)
    assert np.abs(ref32[:bs]).max() > 0.1
    np.testing.assert_allclose(ref32[bs:], f64[bs:], atol=1e-5)
