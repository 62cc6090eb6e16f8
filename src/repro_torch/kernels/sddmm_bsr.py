"""Block-sampled dense-dense product: the SDDMM of the BSR bridge.

Replaces ``repro/kernels/sddmm_bsr.py::sddmm_bsr``. The TPU kernel runs
the grid (sampled block, K tile) in order into a VMEM accumulator. The CUDA
kernels (``csrc/sddmm_bsr.cu``) give each CTA a sampled block, or a tile of
one, and let it walk K itself through shared memory.

At the bridge's shapes the operations (2 * nnzb * bs^2 * K FLOPs) and the
output write bound it about equally. Two routes, chosen from the shape
alone (``route``):

* ``"tensor_cores"`` for 16 <= bs <= 128 when the rows of ``a`` and ``b``
  are 16-byte aligned (K a multiple of 4 for float32, of 8 for bfloat16):
  one CTA a block, ``mma.sync`` with a ``cp.async`` ring, float32 in
  3xTF32 (within ``3 * 2^-22`` of each exact product, so integers up to
  2^11 multiply exactly), bfloat16 in one bf16 pass;
* ``"cuda_cores"`` for every other shape: float32 FMA, the first version.

Layout (as in the reference):
  rows, cols : (nnzb,) int32 block coordinates of the sampled blocks
  a          : (M, K) float32 or bfloat16
  b          : (N, K), the same dtype  ->  out (nnzb, bs, bs) in that dtype

Sums accumulate in float32. ``bs`` is any power of two and K any extent
(the reference's ``K % k_tile == 0`` assert is gone).
"""
from __future__ import annotations

import torch

from . import _build
from .spmm_bsr import _DTYPES, ROUTES, _aligned, _check_bs


def route(bs: int, k_dim: int, dtype: torch.dtype) -> str:
    """The kernel a CUDA call with these shapes launches (module
    docstring): ``"tensor_cores"`` or ``"cuda_cores"``."""
    per_16_bytes = 16 // dtype.itemsize
    if 16 <= bs <= 128 and k_dim % per_16_bytes == 0:
        return "tensor_cores"
    return "cuda_cores"


def sddmm_bsr_plain(rows: torch.Tensor, cols: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, bs: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather each sampled block's
    rows of ``a`` and ``b`` and multiply them with ``bmm`` in float32."""
    off = torch.arange(bs, device=a.device)
    ra = rows.long()[:, None] * bs + off
    rb = cols.long()[:, None] * bs + off
    out = torch.bmm(a.float()[ra], b.float()[rb].transpose(1, 2))
    return out.to(a.dtype)


def sddmm_bsr(rows: torch.Tensor, cols: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, bs: int) -> torch.Tensor:
    """out[i] = a[rows[i]*bs : +bs] @ b[cols[i]*bs : +bs].T.

    CPU tensors take the plain version; CUDA tensors launch the kernel of
    ``route``, counted in ``sddmm_bsr.route_launches`` beside the total
    ``sddmm_bsr.launches``.
    """
    args = (rows, cols, a, b)
    if all(t.device.type == "cpu" for t in args):
        return sddmm_bsr_plain(rows, cols, a, b, bs)
    if any(t.device != a.device for t in args) or a.device.type != "cuda":
        raise ValueError("sddmm_bsr: every operand must be on one CUDA "
                         f"device, got {[str(t.device) for t in args]}")
    if b.dtype != a.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"sddmm_bsr takes float32 or bfloat16 a and b of "
                        f"one dtype, not {a.dtype} and {b.dtype}")
    if (rows.dim() != 1 or cols.shape != rows.shape or a.dim() != 2
            or b.dim() != 2 or a.shape[1] != b.shape[1]):
        raise ValueError(f"sddmm_bsr: shapes rows {tuple(rows.shape)}, cols "
                         f"{tuple(cols.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    _check_bs(bs, "sddmm_bsr")
    nnzb = rows.shape[0]
    r = rows.to(torch.int32).contiguous()
    c = cols.to(torch.int32).contiguous()
    a = _aligned(a)
    b = _aligned(b)
    out = torch.empty((nnzb, bs, bs), dtype=a.dtype, device=a.device)
    if nnzb:
        way = route(bs, a.shape[1], a.dtype)
        entry = "sam_sddmm_bsr_" + ("tc_" if way == "tensor_cores" else "")
        _build.call(entry + _DTYPES[a.dtype], r.data_ptr(), c.data_ptr(),
                    a.data_ptr(), b.data_ptr(), out.data_ptr(), nnzb, bs,
                    a.shape[1], a.shape[0], b.shape[0])
        sddmm_bsr.launches += 1
        sddmm_bsr.route_launches[way] += 1
    return out


sddmm_bsr.launches = 0
sddmm_bsr.route_launches = dict.fromkeys(ROUTES, 0)
