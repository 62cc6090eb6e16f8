"""Block-sampled dense-dense product: the SDDMM of the BSR bridge.

Replaces ``repro/kernels/sddmm_bsr.py::sddmm_bsr``. The TPU kernel runs
the grid (sampled block, K tile) in order into a VMEM accumulator. The CUDA
kernel (``csrc/sddmm_bsr.cu``) gives one CTA each tile of at most 64 x 64
of a sampled block and lets it walk K itself through shared memory.

It is bound by operations at the bridge's shapes (2 * nnzb * bs^2 * K
FLOPs). This first version runs float32 FMA on the CUDA cores.

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
from .spmm_bsr import _DTYPES, _check_bs


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

    CPU tensors take the plain version; CUDA tensors launch the kernel.
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
    a = a.contiguous()
    b = b.contiguous()
    out = torch.empty((nnzb, bs, bs), dtype=a.dtype, device=a.device)
    if nnzb:
        _build.call(f"sam_sddmm_bsr_{_DTYPES[a.dtype]}", r.data_ptr(),
                    c.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    nnzb, bs, a.shape[1], a.shape[0], b.shape[0])
        sddmm_bsr.launches += 1
    return out


sddmm_bsr.launches = 0
