"""Dense-workspace scatter-add: the keyed merge of SAM's n>=1 reducer.

Replaces ``repro/kernels/scatter_workspace.py::scatter_workspace``. The
TPU kernel is a one-hot MXU product into a VMEM-resident workspace; the
CUDA kernel (``csrc/scatter_workspace.cu``) accumulates into a
device-memory workspace, so there is no slot limit.

It is memory-bound on the card: the ids and the in-range payload are read
once and the workspace written once, and atomics on a hot slot serialize
in L2. So a long input runs in tiles: a block takes a run of consecutive
rows and keeps a window of slots in shared memory across its tiles, adds
each row there, and sends each touched slot to the workspace with one
atomic when the window moves; the runs of keys the engine produces (an
expert's slots repeated under its inner loop, a token's row of an FFN)
thus cost one global atomic a slot a run instead of one a row. A tile
whose ids spread wider than the window, and a short input, add a row a
thread, a warp's rows of one id summed before one atomic. Rows aimed at
the dropped padding slot are skipped before their values are read.
Two float32 output columns go out as one vector atomic. See the source's
header for the design.

Layout (as in the reference):
  ids  : (N,) int32 in [0, num_slots]   (num_slots == dropped pad slot)
  cols : (N, C) float                   (mul_pair: C == 3, [a, b, hit])
  out  : (num_slots, C or 2) float32    (float64 for float64 cols)

float16/bfloat16 payloads accumulate through float32, as in the
reference; float64 runs a double instantiation of the same kernel.
"""
from __future__ import annotations

import torch

from . import _build


def scatter_workspace_plain(ids: torch.Tensor, cols: torch.Tensor, *,
                            num_slots: int,
                            mul_pair: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch (``index_add_``)."""
    cols = cols.to(_build.acc_dtype(cols.dtype, "scatter_workspace"))
    if mul_pair:
        mask = cols[:, 2] > 0
        prod = torch.where(mask, cols[:, 0] * cols[:, 1], 0.0)
        cols = torch.stack([prod, mask.to(cols.dtype)], dim=1)
    ids = ids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < num_slots), ids, num_slots)
    out = torch.zeros((num_slots + 1, cols.shape[1]), dtype=cols.dtype,
                      device=cols.device)
    out.index_add_(0, ids, cols)
    return out[:num_slots]


def scatter_workspace(ids: torch.Tensor, cols: torch.Tensor, *,
                      num_slots: int, mul_pair: bool = False) -> torch.Tensor:
    """out[s, c] = sum over i with ids[i] == s of cols[i, c].

    ``mul_pair=True`` treats ``cols`` as ``[a, b, hit]`` and accumulates
    ``[a*b, 1]`` where ``hit > 0`` (the fused multiply-reduce payload).
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if ids.device.type == "cpu" and cols.device.type == "cpu":
        return scatter_workspace_plain(ids, cols, num_slots=num_slots,
                                       mul_pair=mul_pair)
    if ids.device != cols.device or ids.device.type != "cuda":
        raise ValueError(f"scatter_workspace: ids on {ids.device}, cols on "
                         f"{cols.device}; both must be on one CUDA device")
    if ids.dim() != 1 or cols.dim() != 2 or cols.shape[0] != ids.shape[0]:
        raise ValueError(f"scatter_workspace: ids {tuple(ids.shape)} and "
                         f"cols {tuple(cols.shape)} do not match")
    if mul_pair and cols.shape[1] != 3:
        raise ValueError("mul_pair needs cols = [a, b, hit]")
    acc = _build.acc_dtype(cols.dtype, "scatter_workspace")
    ids = ids.to(torch.int32).contiguous()
    cols = cols.to(acc).contiguous()
    if cols.data_ptr() % 16:    # the float2 loads want aligned rows
        cols = cols.clone()
    n, c = cols.shape
    out = torch.zeros((num_slots, 2 if mul_pair else c), dtype=acc,
                      device=cols.device)
    if n:
        name = ("sam_scatter_workspace_f64" if acc == torch.float64
                else "sam_scatter_workspace_f32")
        _build.call(name, cols.device, ids.data_ptr(), cols.data_ptr(),
                    out.data_ptr(), n, c, num_slots, int(mul_pair))
        scatter_workspace.launches += 1
    return out


scatter_workspace.launches = 0
