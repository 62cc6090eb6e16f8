"""Block-sparse flash attention: the fused SDDMM -> softmax -> SpMM.

Replaces ``repro/kernels/bsr_attention.py::bsr_flash_attention``. The TPU
kernel walks the grid (batch*head, q block, kv slot) in order with the
accumulator and the softmax statistics in VMEM. The CUDA kernels
(``csrc/bsr_attention.cu``) give one CTA up to 64 query rows of one q
block and let it stream the block's kv slots in chunks of kv positions
through shared memory, with an online softmax in float32.

It is bound by operations at the model's shapes (4 * D FLOPs per allowed
(query, key) pair). Two routes, chosen from the shape alone (``route``):

* ``"tensor_cores"`` for bq, bkv >= 16 and a head dim that is a multiple
  of 8 and at most 128: FlashAttention-2's shape on ``mma.sync``, with
  ``cp.async`` copies of K and V overlapping the products; float32 in
  3xTF32 (within ``3 * 2^-22`` of each exact product), bfloat16 in one
  bf16 pass (P rounded to bfloat16 for P V); softmax in float32;
* ``"cuda_cores"`` for every other shape (head dims up to 256): float32
  FMA, the first version.

Layout (as in the reference):
  q       : (BH, S_q, D) float32 or bfloat16
  k, v    : (BH, S_kv, D), the same dtype
  kv_idx  : (n_qblk, max_kv) int32 kv block per slot; a value outside
            [0, S_kv // bkv) (the sentinel S_kv // bkv) masks the slot
  out     : (BH, S_q, D) in q's dtype

``causal`` also masks q_pos < k_pos; ``scale`` defaults to 1/sqrt(D). A
query row with no allowed key writes zeros, as the reference's docstrings
and its plain oracle promise (its TPU kernel instead returns the mean of
V's last kv block there). ``bq`` and ``bkv`` are any powers of two, and D
is at most 256.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .spmm_bsr import _DTYPES, ROUTES, _aligned, _check_bs

MAX_HEAD_DIM = 256
TENSOR_CORE_MAX_HEAD_DIM = 128    # above it, O's fragments alone would
                                  # take 128 registers a thread


def route(bq: int, bkv: int, d: int) -> str:
    """The kernel a CUDA call with these shapes launches (module
    docstring): ``"tensor_cores"`` or ``"cuda_cores"``."""
    if (min(bq, bkv) >= 16 and d % 8 == 0
            and 0 < d <= TENSOR_CORE_MAX_HEAD_DIM):
        return "tensor_cores"
    return "cuda_cores"


def _scale(scale: Optional[float], d: int) -> float:
    return float(scale if scale is not None else 1.0 / d ** 0.5)


def bsr_flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, kv_idx: torch.Tensor, *,
                              bq: int, bkv: int,
                              scale: Optional[float] = None,
                              causal: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: dense masked softmax
    attention in float32, one batch*head at a time (which bounds the score
    matrix to S_q x S_kv), with fully masked rows set to zero."""
    bh, s_q, d = q.shape
    s_kv = k.shape[1]
    n_qblk, max_kv = kv_idx.shape
    n_kvblk = s_kv // bkv
    scale = _scale(scale, d)
    idx = kv_idx.long()
    ok = (idx >= 0) & (idx < n_kvblk)
    qblk = torch.arange(n_qblk, device=q.device)[:, None].expand_as(idx)
    allow = torch.zeros((n_qblk, n_kvblk), dtype=torch.bool, device=q.device)
    allow[qblk[ok], idx[ok]] = True
    allow = allow.repeat_interleave(bq, 0).repeat_interleave(bkv, 1)
    if causal:
        allow &= torch.ones_like(allow).tril()
    out = torch.empty_like(q)
    for h in range(bh):
        s = (q[h].float() @ k[h].float().T) * scale
        s = s.masked_fill(~allow, float("-inf"))
        m = s.amax(dim=1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)       # fully masked rows
        p = torch.exp(s - m)
        l = p.sum(dim=1, keepdim=True)
        o = p @ v[h].float()
        out[h] = torch.where(l > 0, o / l, 0.0).to(q.dtype)
    return out


def bsr_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_idx: torch.Tensor, *, bq: int = 128,
                        bkv: int = 128, scale: Optional[float] = None,
                        causal: bool = False) -> torch.Tensor:
    """Block-sparse attention over the kv blocks that ``kv_idx`` lists for
    each q block (module docstring for the layout).

    CPU tensors take the plain version; CUDA tensors launch the kernel of
    ``route``, counted in ``bsr_flash_attention.route_launches`` beside the
    total ``bsr_flash_attention.launches``.
    """
    args = (q, k, v, kv_idx)
    if all(t.device.type == "cpu" for t in args):
        return bsr_flash_attention_plain(q, k, v, kv_idx, bq=bq, bkv=bkv,
                                         scale=scale, causal=causal)
    if any(t.device != q.device for t in args) or q.device.type != "cuda":
        raise ValueError("bsr_flash_attention: every operand must be on one "
                         f"CUDA device, got {[str(t.device) for t in args]}")
    if k.dtype != q.dtype or v.dtype != q.dtype or q.dtype not in _DTYPES:
        raise TypeError(f"bsr_flash_attention takes float32 or bfloat16 q, "
                        f"k, v of one dtype, not {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    bh, s_q, d = q.shape
    n_qblk, max_kv = kv_idx.shape
    _check_bs(bq, "bsr_flash_attention")
    _check_bs(bkv, "bsr_flash_attention")
    if (k.shape[0] != bh or v.shape != k.shape or k.shape[2] != d
            or kv_idx.dim() != 2 or s_q != n_qblk * bq
            or k.shape[1] % bkv):
        raise ValueError(f"bsr_flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, kv_idx "
                         f"{tuple(kv_idx.shape)} with bq={bq}, bkv={bkv}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"bsr_flash_attention: head dim {d} is above "
                         f"{MAX_HEAD_DIM}")
    if bh > 65535:
        raise ValueError(f"bsr_flash_attention: {bh} batch*heads is above "
                         f"65535")
    idx = kv_idx.to(torch.int32).contiguous()
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    if out.numel():
        way = route(bq, bkv, d)
        entry = "sam_bsr_attention_" + ("tc_" if way == "tensor_cores"
                                        else "")
        _build.call(entry + _DTYPES[q.dtype], idx.data_ptr(), q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s_q,
                    k.shape[1], d, n_qblk, max_kv, bq, bkv,
                    _scale(scale, d), int(causal))
        bsr_flash_attention.launches += 1
        bsr_flash_attention.route_launches[way] += 1
    return out


bsr_flash_attention.launches = 0
bsr_flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
