"""The float32 precision contract of the tensor-core kernels, on the CPU.

``sddmm_bsr`` and ``bsr_flash_attention`` run float32 products on the
card's tensor cores in 3xTF32 (``kernels/csrc/tensor_core.cuh``): each
operand splits into ``hi = tf32_rna(x)`` and ``lo = tf32_rna(x - hi)``, and
``lo*hi + hi*lo + hi*hi`` accumulates in float32. This file emulates that
arithmetic in plain torch (TF32 products are exact in float32, so a
float32 matmul of TF32-rounded operands gives what the tensor cores give,
up to summation order) and shows, at the shapes of the block-sparse path:

* 3xTF32 stays inside the per-element bound ``(3 * 2^-22 + K * 2^-24) *
  sum_k |a_k b_k|`` that ``chip_smoke.py`` and the GPU tests hold the
  kernel to, and attention through it stays within 2e-5 of float64;
* a single TF32 pass fails both, by far;
* integer data up to 2^11 splits with ``lo == 0`` and multiplies exactly.

``spmm_bsr`` runs the same contract over a block row: its live slots'
blocks times C's rows, one m16n8k8 step of 8 k at a time. An emulation
of that order stays inside the same bound with K the row's live slots times
the block size, and is exact on integers up to 2^11.

It also checks the register mapping the float32 attention kernel uses to
feed P from its score accumulators straight into the P V product, and the
wrappers' route choice, which depends on the shape alone.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bsr_attention as attn_mod
from repro_torch.kernels import ops as kops
from repro_torch.kernels import sddmm_bsr as sddmm_mod
from repro_torch.kernels import spmm_bsr as spmm_mod

K_H = 128          # (h)'s K, and the head dim of llama3.2-3b-bsr
ATTN_TOL = 2e-5    # a kernel against its plain version, float32


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 (10 mantissa bits), rounding half away from zero,
    as ``cvt.rna.tf32.f32``: adding half a unit of the dropped 13 bits to
    the sign-magnitude pattern rounds the magnitude, then they are
    cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x.float() - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in float32 on the tensor cores' 3xTF32: small terms first."""
    ah, al = split(a)
    bh, bl = split(b)
    acc = al @ bh
    acc = acc + ah @ bl
    return acc + ah @ bh


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32_rna(a) @ tf32_rna(b)


def worst_case_bound(a64: np.ndarray, b64: np.ndarray) -> np.ndarray:
    """(3 * 2^-22 + K * 2^-24) * sum_k |a_k b_k| for out = a @ b.T."""
    k = a64.shape[1]
    return (3 * 2.0 ** -22 + k * 2.0 ** -24) * (np.abs(a64) @ np.abs(b64).T)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_tf32_rna_rounds_half_away_from_zero():
    one = 1.0 + 2.0 ** -10                     # the TF32 neighbour of 1
    x = torch.tensor([1.0, 1.0 + 2.0 ** -12, 1.0 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 3.0, -0.0])
    want = torch.tensor([1.0, 1.0, one, -one, 3.0, -0.0])
    assert torch.equal(tf32_rna(x), want)
    y = tf32_rna(torch.as_tensor(_normal(0, 4096)))
    assert not (y.view(torch.int32) & 0x1FFF).any()       # 10 bits kept


@pytest.mark.parametrize("k", [K_H, 200])
def test_3xtf32_sddmm_stays_inside_the_worst_case_bound(k):
    a, b = _normal(1, 256, k), _normal(2, 192, k)
    exact = a.astype(np.float64) @ b.astype(np.float64).T
    bound = worst_case_bound(a.astype(np.float64), b.astype(np.float64))
    got = mm_3xtf32(torch.as_tensor(a), torch.as_tensor(b).T).double()
    ratio = np.abs(got.numpy() - exact) / bound
    assert ratio.max() <= 1.0
    # far inside it: rounding errors add like a random walk, not K-fold
    assert ratio.max() < 0.25


@pytest.mark.parametrize("k", [K_H, 200])
def test_single_pass_tf32_fails_the_bound(k):
    a, b = _normal(1, 256, k), _normal(2, 192, k)
    exact = a.astype(np.float64) @ b.astype(np.float64).T
    bound = worst_case_bound(a.astype(np.float64), b.astype(np.float64))
    got = mm_1xtf32(torch.as_tensor(a), torch.as_tensor(b).T).double()
    assert (np.abs(got.numpy() - exact) / bound).max() > 10


def _attention(q, k, v, allow, mm):
    """Masked softmax attention with both products through ``mm``, the
    softmax in float32 (as the kernel: scores scaled after the product,
    every row has an allowed key)."""
    s = mm(q, k.T) * (1.0 / q.shape[1] ** 0.5)
    s = s.masked_fill(~allow, float("-inf"))
    p = torch.exp(s - s.amax(dim=1, keepdim=True))
    return mm(p, v) / p.sum(dim=1, keepdim=True)


def _attention_case(seed=3, s_len=512, d=K_H, bs=64):
    q, k, v = (torch.as_tensor(_normal(seed + i, s_len, d)) for i in range(3))
    kv_idx = kops.sliding_window_kv_idx(s_len // bs, s_len // bs, 4)
    blk = np.zeros((s_len // bs, s_len // bs), bool)
    for qi, row in enumerate(kv_idx):
        blk[qi, row[row < s_len // bs]] = True
    allow = torch.as_tensor(np.kron(blk, np.ones((bs, bs), bool)))
    q64, k64, v64 = (x.double() for x in (q, k, v))
    sc = (q64 @ k64.T) / d ** 0.5
    sc = sc.masked_fill(~allow, float("-inf"))
    p = torch.exp(sc - sc.amax(dim=1, keepdim=True))
    oracle = (p / p.sum(dim=1, keepdim=True)) @ v64
    return q, k, v, allow, oracle


def test_3xtf32_attention_is_within_2e5_of_float64():
    q, k, v, allow, oracle = _attention_case()
    got = _attention(q, k, v, allow, mm_3xtf32).double()
    assert (got - oracle).abs().max() <= ATTN_TOL


def test_single_pass_tf32_attention_is_not():
    q, k, v, allow, oracle = _attention_case()
    got = _attention(q, k, v, allow, mm_1xtf32).double()
    assert (got - oracle).abs().max() > 10 * ATTN_TOL


def test_integers_up_to_2_11_split_exactly_and_multiply_bit_exact():
    ints = torch.arange(-2 ** 11, 2 ** 11 + 1, dtype=torch.float32)
    hi, lo = split(ints)
    assert torch.equal(hi, ints) and not lo.any()
    rng = np.random.default_rng(4)
    # K * 2^11 * 2^5 = 2^23: every float32 partial sum is an exact integer
    a = rng.integers(-2 ** 11, 2 ** 11 + 1, (96, K_H)).astype(np.float32)
    b = rng.integers(-2 ** 5, 2 ** 5 + 1, (80, K_H)).astype(np.float32)
    got = mm_3xtf32(torch.as_tensor(a), torch.as_tensor(b).T)
    want = a.astype(np.float64) @ b.astype(np.float64).T
    assert np.array_equal(got.double().numpy(), want)


def test_score_accumulators_feed_p_v_without_a_shuffle():
    """The float32 attention kernel hands lane (g, t) of the scores' C
    fragment (rows g, g+8; kv 2t, 2t+1 of an 8-wide tile) to the A
    fragment of an m16n8k8 step as (s0, s2, s1, s3), which maps k t -> kv
    2t and k t+4 -> kv 2t+1, and reads V's B fragment from kv rows 2t and
    2t+1. Rebuilding A and B from those registers by the PTX fragment
    layout must give P and V with the same k order."""
    rng = np.random.default_rng(5)
    p = rng.standard_normal((16, 8))
    v = rng.standard_normal((8, 8))
    a = np.zeros((16, 8))          # A as the mma reads it (row, k)
    b = np.zeros((8, 8))           # B as the mma reads it (k, n)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        c = [p[g, 2 * t], p[g, 2 * t + 1], p[g + 8, 2 * t],
             p[g + 8, 2 * t + 1]]                     # C fragment c0..c3
        regs = [c[0], c[2], c[1], c[3]]               # the kernel's a0..a3
        for (row, k), val in zip([(g, t), (g + 8, t), (g, t + 4),
                                  (g + 8, t + 4)], regs):
            a[row, k] = val
        b[t, g] = v[2 * t, g]                         # b0 (k t, n g)
        b[t + 4, g] = v[2 * t + 1, g]                 # b1 (k t+4, n g)
    np.testing.assert_allclose(a @ b, p @ v, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("bs,k,dtype,want", [
    (8, 128, torch.float32, "cuda_cores"),
    (16, 128, torch.float32, "tensor_cores"),
    (64, 200, torch.float32, "tensor_cores"),
    (128, 128, torch.float32, "tensor_cores"),
    (128, 130, torch.float32, "cuda_cores"),       # rows not 16-byte aligned
    (128, 132, torch.bfloat16, "cuda_cores"),
    (128, 136, torch.bfloat16, "tensor_cores"),
    (256, 128, torch.float32, "cuda_cores")])
def test_sddmm_route_depends_on_the_shape_alone(bs, k, dtype, want):
    assert sddmm_mod.route(bs, k, dtype) == want


@pytest.mark.parametrize("bq,bkv,d,want", [
    (128, 128, 128, "tensor_cores"),
    (16, 16, 64, "tensor_cores"),
    (64, 64, 40, "tensor_cores"),
    (128, 128, 100, "cuda_cores"),      # not a multiple of 8
    (64, 64, 256, "cuda_cores"),        # above the register budget
    (8, 8, 64, "cuda_cores"),
    (128, 8, 128, "cuda_cores")])
def test_attention_route_depends_on_the_shape_alone(bq, bkv, d, want):
    assert attn_mod.route(bq, bkv, d) == want


def _block_row_3xtf32(blocks, c_rows):
    """One block row of spmm_bsr as its tensor-core kernel sums it: the
    live slots in order, each block's k in steps of 8, every step adding
    lo*hi, hi*lo, hi*hi into float32 accumulators (each product of a step
    is exact in float32; the step's sum is a float32 matmul)."""
    a = torch.cat(list(blocks), dim=1)          # (bs, slots * bs)
    ah, al = split(a)
    bh, bl = split(c_rows)
    acc = torch.zeros((a.shape[0], c_rows.shape[1]))
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        acc = acc + al[:, ks] @ bh[ks]
        acc = acc + ah[:, ks] @ bl[ks]
        acc = acc + ah[:, ks] @ bh[ks]
    return acc


@pytest.mark.parametrize("bs,slots", [(128, 6), (64, 9), (16, 3)])
def test_3xtf32_spmm_block_row_stays_inside_the_worst_case_bound(bs, slots):
    rng = np.random.default_rng(bs + slots)
    blocks = rng.standard_normal((slots, bs, bs)).astype(np.float32)
    c_rows = rng.standard_normal((slots * bs, 96)).astype(np.float32)
    a64 = np.concatenate(list(blocks.astype(np.float64)), axis=1)
    exact = a64 @ c_rows.astype(np.float64)
    k = slots * bs                    # the row's live slots times bs
    bound = (3 * 2.0 ** -22 + k * 2.0 ** -24) * (np.abs(a64)
                                                 @ np.abs(c_rows))
    got = _block_row_3xtf32(torch.as_tensor(blocks), torch.as_tensor(c_rows))
    ratio = np.abs(got.double().numpy() - exact) / bound
    assert ratio.max() <= 1.0
    one_pass = (tf32_rna(torch.as_tensor(a64).float())
                @ tf32_rna(torch.as_tensor(c_rows))).double().numpy()
    # one TF32 pass breaks it (by less at large K, where the summation
    # term of the bound grows)
    assert (np.abs(one_pass - exact) / bound).max() > 1


def test_3xtf32_spmm_block_row_is_exact_on_integers_up_to_2_11():
    rng = np.random.default_rng(11)
    bs, slots = 128, 4
    # K * 2^11 * 2^4 = 2^24: every float32 partial sum is an exact integer
    blocks = rng.integers(-2 ** 11, 2 ** 11 + 1, (slots, bs, bs)
                          ).astype(np.float32)
    c_rows = rng.integers(-2 ** 4, 2 ** 4 + 1, (slots * bs, 64)
                          ).astype(np.float32)
    got = _block_row_3xtf32(torch.as_tensor(blocks), torch.as_tensor(c_rows))
    want = (np.concatenate(list(blocks.astype(np.float64)), axis=1)
            @ c_rows.astype(np.float64))
    assert np.array_equal(got.double().numpy(), want)


@pytest.mark.parametrize("bs,n,dtype,want", [
    (1, 4096, torch.float32, "cuda_cores"),
    (2, 4096, torch.float32, "cuda_cores"),
    (4, 4096, torch.bfloat16, "cuda_cores"),
    (8, 4096, torch.float32, "cuda_cores"),
    (16, 4096, torch.float32, "tensor_cores"),
    (32, 300, torch.float32, "tensor_cores"),
    (64, 4096, torch.bfloat16, "tensor_cores"),
    (128, 4096, torch.float32, "tensor_cores"),
    (256, 200, torch.bfloat16, "tensor_cores"),
    (128, 4098, torch.float32, "cuda_cores"),      # rows not 16-byte aligned
    (128, 301, torch.float32, "cuda_cores"),
    (128, 4100, torch.bfloat16, "cuda_cores"),
    (256, 4100, torch.float32, "tensor_cores")])
def test_spmm_route_depends_on_the_shape_alone(bs, n, dtype, want):
    assert spmm_mod.route(bs, n, dtype) == want


def test_cpu_calls_count_no_route():
    kops.reset_launch_counts()
    a = torch.ones((256, 128))
    sddmm_mod.sddmm_bsr(torch.zeros(1, dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32), a, a, 128)
    q = torch.ones((1, 256, 128))
    attn_mod.bsr_flash_attention(q, q, q, torch.zeros((2, 1),
                                                      dtype=torch.int32))
    spmm_mod.spmm_bsr(torch.zeros((2, 1), dtype=torch.int32),
                      torch.zeros((2, 1), dtype=torch.int32),
                      torch.ones((2, 128, 128)), a)
    assert kops.route_counts() == {
        "spmm_bsr": {"tensor_cores": 0, "cuda_cores": 0},
        "sddmm_bsr": {"tensor_cores": 0, "cuda_cores": 0},
        "bsr_attention": {"tensor_cores": 0, "cuda_cores": 0}}
