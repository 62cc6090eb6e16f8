"""Keyed segment sum: the inner sum of SAM's sort-merge reducer.

Replaces ``repro/kernels/segment_reduce.py::segment_reduce``. The TPU
kernel is a one-hot MXU product into an ``(S+1, 128)`` accumulator
resident in VMEM, which caps S; the CUDA kernel
(``csrc/segment_reduce.cu``) has each row add itself into its segment of a
device-memory output with atomics, so any S fits. A row a thread, a vector
atomic for float32 rows of two columns, and the rows of a warp that share
an id summed before one lane issues the atomic (see the source's header).

It is memory-bound on the card: ids and in-range values are read once and
the output written once. Atomics on one address serialize in L2, so the
callers in ``coord_ops`` give their padding rows the dropped id S rather
than one shared live segment.

Layout (as in the reference):
  vals : (N, D) float    seg_ids : (N,) int32 in [0, S]   (S is dropped)
  out  : (S, D) in vals' dtype, accumulated in float32 (float64 for
         float64 values, through a double instantiation of the kernel)

``segment_reduce_mul`` is the kernel's [a*b, 1] mode, the keyed reduce
over a bounded key space that ``kernels/ops.py`` runs: it reads the
engine's int64 keys, both value streams and the validity mask as they
are, and accumulates ``[a*b, 1]`` for a valid row whose key is in range.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build


def segment_reduce_plain(vals: torch.Tensor, seg_ids: torch.Tensor, *,
                         num_segments: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch (``index_add_``)."""
    acc = _build.acc_dtype(vals.dtype, "segment_reduce")
    ids = seg_ids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out = torch.zeros((num_segments + 1, vals.shape[1]), dtype=acc,
                      device=vals.device)
    out.index_add_(0, ids, vals.to(acc))
    return out[:num_segments].to(vals.dtype)


def segment_reduce_mul_plain(keys: torch.Tensor, a: torch.Tensor,
                             b: Optional[torch.Tensor], valid: torch.Tensor,
                             *, num_segments: int) -> torch.Tensor:
    """The [a*b, 1] mode in plain PyTorch: a valid row whose key lies in
    ``[0, num_segments)`` adds ``[a*b, 1]`` (``[a, 1]`` for ``b=None``) to
    its key's row; any other row adds nothing, whatever its values hold."""
    acc = _build.acc_dtype(a.dtype, "segment_reduce")
    live = valid & (keys >= 0) & (keys < num_segments)
    ids = torch.where(live, keys, num_segments)
    prod = a.to(acc) if b is None else a.to(acc) * b.to(acc)
    cols = torch.stack([torch.where(live, prod, 0.0), live.to(acc)], dim=1)
    out = torch.zeros((num_segments + 1, 2), dtype=acc, device=a.device)
    out.index_add_(0, ids, cols)
    return out[:num_segments]


def _on_cuda(name, *tensors) -> bool:
    """True for tensors on one CUDA device, False for CPU tensors; raises
    for anything else (mixed devices)."""
    dev = tensors[0].device
    if dev.type == "cpu" and not any(t.is_cuda for t in tensors):
        return False
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on "
                         f"{sorted({str(t.device) for t in tensors})}; all "
                         f"must be on one CUDA device")
    return True


def segment_reduce(vals: torch.Tensor, seg_ids: torch.Tensor, *,
                   num_segments: int) -> torch.Tensor:
    """out[s, :] = sum over i with seg_ids[i] == s of vals[i, :].

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if not _on_cuda("segment_reduce", vals, seg_ids):
        return segment_reduce_plain(vals, seg_ids, num_segments=num_segments)
    if (vals.dim() != 2 or seg_ids.dim() != 1
            or seg_ids.shape[0] != vals.shape[0]):
        raise ValueError(f"segment_reduce: vals {tuple(vals.shape)} and ids "
                         f"{tuple(seg_ids.shape)} do not match")
    if vals.shape[0] >= 2 ** 31:
        raise ValueError("segment_reduce: int32 ids address < 2**31 rows")
    acc = _build.acc_dtype(vals.dtype, "segment_reduce")
    ids = seg_ids.to(torch.int32).contiguous()
    v = vals.to(acc).contiguous()
    if v.data_ptr() % 16:       # the float2 loads want aligned rows
        v = v.clone()
    n, d = v.shape
    out = torch.zeros((num_segments, d), dtype=acc, device=v.device)
    if n and d:
        name = ("sam_segment_reduce_f64" if acc == torch.float64
                else "sam_segment_reduce_f32")
        _build.call(name, v.device, ids.data_ptr(), v.data_ptr(),
                    out.data_ptr(), n, d, num_segments)
        segment_reduce.launches += 1
    return out.to(vals.dtype)


def segment_reduce_mul(keys: torch.Tensor, a: torch.Tensor,
                       b: Optional[torch.Tensor], valid: torch.Tensor, *,
                       num_segments: int) -> torch.Tensor:
    """The [a*b, 1] mode: ``out[k] = [sum of a*b, count]`` over the valid
    rows whose int64 key is ``k`` in ``[0, num_segments)`` (``b=None``
    sums ``a``); an ``(num_segments, 2)`` workspace in the accumulation
    type (float32, or float64 for float64 values). A launch counts toward
    ``segment_reduce.launches``: it is the same kernel source.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    streams = [t for t in (keys, a, b, valid) if t is not None]
    if not _on_cuda("segment_reduce_mul", *streams):
        return segment_reduce_mul_plain(keys, a, b, valid,
                                        num_segments=num_segments)
    n = keys.shape[0]
    if any(t.dim() != 1 or t.shape[0] != n for t in streams):
        raise ValueError("segment_reduce_mul: keys, a, b and valid must be "
                         "1-D of one length")
    if keys.dtype != torch.int64 or valid.dtype != torch.bool:
        raise TypeError("segment_reduce_mul: int64 keys and a bool mask")
    if num_segments >= 2 ** 31:
        raise ValueError("segment_reduce_mul: < 2**31 segments")
    acc = _build.acc_dtype(a.dtype, "segment_reduce")
    keys, valid = keys.contiguous(), valid.contiguous()
    a = a.to(acc).contiguous()
    b = None if b is None else b.to(acc).contiguous()
    out = torch.zeros((num_segments, 2), dtype=acc, device=keys.device)
    if n:
        name = ("sam_segment_reduce_mul_f64" if acc == torch.float64
                else "sam_segment_reduce_mul_f32")
        _build.call(name, a.device, keys.data_ptr(), a.data_ptr(),
                    None if b is None else b.data_ptr(), valid.data_ptr(),
                    out.data_ptr(), n, num_segments)
        segment_reduce.launches += 1
    return out


segment_reduce.launches = 0
