"""Keyed segment sum: the inner sum of SAM's sort-merge reducer.

Replaces ``repro/kernels/segment_reduce.py::segment_reduce``. The TPU
kernel is a one-hot MXU product into an ``(S+1, 128)`` accumulator
resident in VMEM, which caps S; the CUDA kernel
(``csrc/segment_reduce.cu``) has each element add itself into its segment
of a device-memory output with ``atomicAdd``, so any S fits.

It is memory-bound on the card: values and ids are read once and the
output written once. Atomics on one address serialize in L2, so the
callers in ``coord_ops`` give their padding rows the dropped id S rather
than one shared live segment.

Layout (as in the reference):
  vals : (N, D) float    seg_ids : (N,) int32 in [0, S]   (S is dropped)
  out  : (S, D) in vals' dtype, accumulated in float32 (float64 for
         float64 values, through a double instantiation of the kernel)
"""
from __future__ import annotations

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


def segment_reduce(vals: torch.Tensor, seg_ids: torch.Tensor, *,
                   num_segments: int) -> torch.Tensor:
    """out[s, :] = sum over i with seg_ids[i] == s of vals[i, :].

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if vals.device.type == "cpu" and seg_ids.device.type == "cpu":
        return segment_reduce_plain(vals, seg_ids, num_segments=num_segments)
    if vals.device != seg_ids.device or vals.device.type != "cuda":
        raise ValueError(f"segment_reduce: vals on {vals.device}, ids on "
                         f"{seg_ids.device}; both must be on one CUDA device")
    if (vals.dim() != 2 or seg_ids.dim() != 1
            or seg_ids.shape[0] != vals.shape[0]):
        raise ValueError(f"segment_reduce: vals {tuple(vals.shape)} and ids "
                         f"{tuple(seg_ids.shape)} do not match")
    if vals.shape[0] >= 2 ** 31:
        raise ValueError("segment_reduce: int32 ids address < 2**31 rows")
    acc = _build.acc_dtype(vals.dtype, "segment_reduce")
    ids = seg_ids.to(torch.int32).contiguous()
    v = vals.to(acc).contiguous()
    n, d = v.shape
    out = torch.zeros((num_segments, d), dtype=acc, device=v.device)
    if n and d:
        name = ("sam_segment_reduce_f64" if acc == torch.float64
                else "sam_segment_reduce_f32")
        _build.call(name, ids.data_ptr(), v.data_ptr(), out.data_ptr(),
                    n, d, num_segments)
        segment_reduce.launches += 1
    return out.to(vals.dtype)


segment_reduce.launches = 0
