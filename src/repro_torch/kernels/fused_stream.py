"""Fused sorted intersection x multiply x workspace reduce.

Replaces ``repro/kernels/fused_stream.py::fused_imr_workspace``: the
Gustavson inner loop in one pass. The TPU kernel probes with a ``(T, NB)``
membership matrix against the whole *b* stream in VMEM, because Mosaic has
no vector gather; the CUDA kernel (``csrc/fused_stream.cu``) gives each
element of *a* one thread that binary-searches the sorted *b* keys,
gathers, multiplies and adds ``[a*b, 1]`` into the workspace with
``atomicAdd``. Keys stay int64 (the reference narrows them to int32).

It is memory-bound on the card: *a*'s keys, values and output keys are
read once, *b* at least once, the workspace written once; the search adds
``log2(NB)`` dependent loads per element of *a*, mostly served by L2.

Contract (the dispatch wrapper in ``ops.py`` establishes it): invalid
rows of either stream are keyed ``PAD_KEY`` (int64 max), *b*'s keys are
sorted with its padding at the end, ``b_vals`` is 0 at invalid rows, and
``out_key`` lies in ``[0, num_slots)`` wherever *a* matches.

Layout:
  a_key/a_vals/out_key : (NA,)   b_key/b_vals : (NB,)
  out                  : (num_slots, 2) = [sums, hits]
"""
from __future__ import annotations

import torch

from . import _build

PAD_KEY = torch.iinfo(torch.int64).max


def fused_imr_workspace_plain(a_key, a_vals, out_key, b_key, b_vals, *,
                              num_slots: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch (searchsorted + index_add_)."""
    acc = _build.acc_dtype(a_vals.dtype, "fused_imr_workspace")
    out = torch.zeros((num_slots + 1, 2), dtype=acc, device=a_key.device)
    if b_key.shape[0] == 0 or a_key.shape[0] == 0:
        return out[:num_slots]
    a_key = a_key.to(torch.int64)
    b_key = b_key.to(torch.int64)
    idx = torch.clamp(torch.searchsorted(b_key, a_key), max=b_key.shape[0] - 1)
    hit = (b_key[idx] == a_key) & (a_key != PAD_KEY)
    prod = torch.where(hit, a_vals.to(acc) * b_vals.to(acc)[idx], 0.0)
    ids = torch.where(hit, out_key.to(torch.int64), num_slots)
    out.index_add_(0, ids, torch.stack([prod, hit.to(acc)], dim=1))
    return out[:num_slots]


def fused_imr_workspace(a_key, a_vals, out_key, b_key, b_vals, *,
                        num_slots: int) -> torch.Tensor:
    """Dense ``(num_slots, 2)`` = ``[sums, hits]`` workspace of the loop.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    tensors = (a_key, a_vals, out_key, b_key, b_vals)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_imr_workspace_plain(a_key, a_vals, out_key, b_key,
                                         b_vals, num_slots=num_slots)
    dev = a_key.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("fused_imr_workspace: every stream must be on one "
                         "CUDA device")
    na, nb = a_key.shape[0], b_key.shape[0]
    if (a_vals.shape != (na,) or out_key.shape != (na,)
            or b_vals.shape != (nb,)):
        raise ValueError("fused_imr_workspace: stream lengths do not match")
    acc = _build.acc_dtype(a_vals.dtype, "fused_imr_workspace")
    a_key = a_key.to(torch.int64).contiguous()
    out_key = out_key.to(torch.int64).contiguous()
    b_key = b_key.to(torch.int64).contiguous()
    a_vals = a_vals.to(acc).contiguous()
    b_vals = b_vals.to(acc).contiguous()
    out = torch.zeros((num_slots, 2), dtype=acc, device=dev)
    if na and nb:
        name = ("sam_fused_imr_f64" if acc == torch.float64
                else "sam_fused_imr_f32")
        _build.call(name, a_key.data_ptr(), a_vals.data_ptr(),
                    out_key.data_ptr(), b_key.data_ptr(), b_vals.data_ptr(),
                    out.data_ptr(), na, nb)
        fused_imr_workspace.launches += 1
    return out


fused_imr_workspace.launches = 0
