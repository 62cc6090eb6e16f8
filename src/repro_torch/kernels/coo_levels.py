"""COO → compressed fibertree levels: the program-fusion handoff.

Replaces ``repro/kernels/coo_levels.py::coo_to_levels_pallas``. A fused
stage's keyed COO result (sorted ascending, unique, invalid rows keyed
``PAD_KEY``) becomes the ``(seg, crd)`` tensors the next stage's level
scanners read, on the card. The TPU kernel moves each level's stable
compaction through the f32 MXU as a one-hot scatter (exact below 2**24,
at most 4096 slots); the CUDA kernel (``csrc/coo_levels.cu``) ranks the
flagged rows with an integer prefix count, so any level extent and any
capacity is exact, and it equals ``coord_ops.coo_to_levels`` bit for bit,
overflowing capacities included.

It is memory-bound on the card: the function reads the keys and the
valid mask once and writes each level's ``crd`` and ``seg``; this kernel
reads the keys again at every level. Per level it launches four
kernels (tile counts, one-CTA scan of the tile counts, compaction with
each parent's ``seg`` at its first child, ``seg`` of childless parents),
and none of them synchronizes with the host: the live counts stay 0-d
device tensors for the caller's one transfer.

Layout (as in the reference):
  keys  : (N,) int64, sorted and unique over the valid rows
  valid : (N,) bool
  dims_list, caps : per-level extents and capacities (host ints)
  -> segs[l] (caps[l-1] + 1,) int32 (2 for the root level),
     crds[l] (caps[l],) int32, counts[l] 0-d int64
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from ..core import coord_ops as _co
from . import _build

# rows per CTA of the compaction passes; the kernel refuses any other value
_TILE = 1024
_INT64_MAX = (1 << 63) - 1

# the kernel's function in plain PyTorch is the engine's own primitive
coo_to_levels_plain = _co.coo_to_levels


def _strides(dims_list: Sequence[int]) -> List[int]:
    """stride_l = prod(dims[l+1:])."""
    out, s = [], 1
    for d in reversed(dims_list):
        out.append(s)
        s *= d
    return out[::-1]


def coo_to_levels(keys: torch.Tensor, valid: torch.Tensor,
                  dims_list: Sequence[int], caps: Sequence[int]
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                             List[torch.Tensor]]:
    """``coord_ops.coo_to_levels`` on the card: returns (segs, crds,
    counts) as described in the module docstring.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if keys.device.type == "cpu" and valid.device.type == "cpu":
        return coo_to_levels_plain(keys, valid, dims_list, caps)
    if keys.device != valid.device or keys.device.type != "cuda":
        raise ValueError(f"coo_to_levels: keys on {keys.device}, valid on "
                         f"{valid.device}; both must be on one CUDA device")
    if (keys.dtype != torch.int64 or valid.dtype != torch.bool
            or keys.dim() != 1 or valid.shape != keys.shape):
        raise ValueError(f"coo_to_levels: keys {keys.dtype} "
                         f"{tuple(keys.shape)} and valid {valid.dtype} "
                         f"{tuple(valid.shape)}; want int64 and bool of one "
                         f"length")
    dims_list = [int(d) for d in dims_list]
    caps = [int(c) for c in caps]
    if not dims_list or len(caps) != len(dims_list):
        raise ValueError(f"coo_to_levels: {len(dims_list)} level extents "
                         f"and {len(caps)} capacities")
    if min(dims_list) < 1 or min(caps) < 0 or max(caps) >= 2 ** 31:
        raise ValueError(f"coo_to_levels: extents {dims_list} must be >= 1 "
                         f"and capacities {caps} in [0, 2**31)")
    if math.prod(dims_list) > _INT64_MAX:
        raise ValueError(f"coo_to_levels: extents {dims_list} span more "
                         f"keys than int64 encodes")
    dev = keys.device
    n = keys.shape[0]
    keys = keys.contiguous()
    valid = valid.contiguous()
    n_tiles = max(-(-n // _TILE), 1)
    tile_counts = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    tile_offsets = torch.empty(n_tiles, dtype=torch.int64, device=dev)
    counts = torch.zeros(len(dims_list), dtype=torch.int64, device=dev)
    # every row's rank at the level above, double-buffered across levels
    ranks = [torch.empty(n, dtype=torch.int64, device=dev)
             for _ in range(min(len(dims_list) - 1, 2))]
    segs, crds = [], []
    rank_in = None
    parent_cap = 1
    for lvl, (stride, dim, cap) in enumerate(zip(_strides(dims_list),
                                                 dims_list, caps)):
        crd = torch.zeros(cap, dtype=torch.int32, device=dev)
        seg = torch.empty(parent_cap + 1, dtype=torch.int32, device=dev)
        par = torch.empty(cap, dtype=torch.int64, device=dev)
        rank_out = ranks[lvl % 2] if lvl < len(dims_list) - 1 else None
        _build.call("sam_coo_levels_level", keys.data_ptr(),
                    valid.data_ptr(), n, stride, dim,
                    rank_in.data_ptr() if rank_in is not None else None,
                    rank_out.data_ptr() if rank_out is not None else None,
                    crd.data_ptr(), cap, seg.data_ptr(), parent_cap,
                    counts[lvl].data_ptr(),
                    counts[lvl - 1].data_ptr() if lvl else None,
                    tile_counts.data_ptr(), tile_offsets.data_ptr(),
                    par.data_ptr(), _TILE)
        segs.append(seg)
        crds.append(crd)
        rank_in = rank_out
        parent_cap = cap
    coo_to_levels.launches += 1
    return segs, crds, [counts[lvl] for lvl in range(len(dims_list))]


coo_to_levels.launches = 0
