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
valid mask once and writes each level's ``crd`` and ``seg``. Flags are
nested across levels (a row that starts an entry at one level starts one
at every deeper level), so each row has one divergence level, and the
kernel handles all levels in one pass over the rows: a launch that reads
keys and valid once and writes each row's divergence level as a byte with
per-tile counts, a one-CTA scan of those counts, a launch that writes
every level's ``crd`` and ``seg``, and a search that runs only for levels
whose parent overflowed its capacity (known on the card; it returns at
once otherwise). Quotients by the level strides are shifts or 64-bit
multiply-shifts (``_divisor``), not int64 divisions. None of the launches
synchronizes with the host: the live counts stay 0-d device tensors for
the caller's one transfer.

Layout (as in the reference):
  keys  : (N,) int64, sorted and unique over the valid rows
  valid : (N,) bool
  dims_list, caps : per-level extents and capacities (host ints)
  -> segs[l] (caps[l-1] + 1,) int32 (2 for the root level),
     crds[l] (caps[l],) int32, counts[l] 0-d int64
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Sequence, Tuple

import torch

from ..core import coord_ops as _co
from . import _build
from .spmm_bsr import _aligned

_INT64_MAX = (1 << 63) - 1
# the kernel's limits (csrc/coo_levels.cu): levels a call (its plan holds
# 16, and pass 3 scans each level with one of its 16 warps) and rows a
# tile of passes 1 and 3
MAX_LEVELS = 16
_TILE = 4096

# the kernel's function in plain PyTorch is the engine's own primitive
coo_to_levels_plain = _co.coo_to_levels


def _divisor(d: int) -> Tuple[int, int]:
    """(magic, shift) with floor(k / d) = ((magic * k) >> 64) >> shift for
    every 0 <= k < 2**63, or magic 0 and floor(k / d) = k >> shift when d is
    a power of two: the round-up method of Granlund and Montgomery, which
    for 63-bit numerators keeps the magic below 2**64."""
    if not 1 <= d <= _INT64_MAX:
        raise ValueError(f"divisor {d} outside [1, 2**63)")
    if d & (d - 1) == 0:
        return 0, d.bit_length() - 1
    log = d.bit_length()                     # ceil(log2 d), d not a power
    return (1 << (63 + log)) // d + 1, log - 1


@functools.lru_cache(maxsize=64)
def _plan(n: int, dims: Tuple[int, ...], caps: Tuple[int, ...]):
    """The kernel's host plan for one shape, checked once: (int32 words of
    the outputs, bytes of the scratch, the int64 plan
    array the kernel reads, the sizes that split the outputs into pieces,
    and the piece of each level's crd and of each level's seg). The
    counts (int64) are the first piece."""
    dims = tuple(int(d) for d in dims)
    caps = tuple(int(c) for c in caps)
    levels = len(dims)
    if not dims or len(caps) != levels or levels > MAX_LEVELS:
        raise ValueError(f"coo_to_levels: {levels} level extents and "
                         f"{len(caps)} capacities (at most {MAX_LEVELS} "
                         f"levels)")
    if min(dims) < 1 or min(caps) < 0 or max(caps) >= 2 ** 31:
        raise ValueError(f"coo_to_levels: extents {list(dims)} must be >= 1 "
                         f"and capacities {list(caps)} in [0, 2**31)")
    if math.prod(dims) > _INT64_MAX:
        raise ValueError(f"coo_to_levels: extents {list(dims)} span more "
                         f"keys than int64 encodes")
    words = []
    for j in range(levels + 1):
        div = math.prod(dims[j:])
        magic, shift = _divisor(div)
        # the magic travels as the int64 of its 64 bits
        words += [magic - (1 << 64) if magic >> 63 else magic, shift, div]
    # outputs: int32 pieces back to back, the counts first
    sizes = [2 * levels]
    crd_pieces, seg_pieces, level_at = [], [], []
    parent_cap = 1
    for cap in caps:
        level_at.append((4 * sum(sizes), 4 * (sum(sizes) + cap)))
        crd_pieces.append(len(sizes))
        seg_pieces.append(len(sizes) + 1)
        sizes += [cap, parent_cap + 1]
        parent_cap = cap
    out_words = sum(sizes)
    # scratch: par of levels 1.., tile counts, tile offsets, a byte a row
    n_tiles = -(-n // _TILE)
    scratch_at = [0]
    for nbytes in [8 * cap for cap in caps[1:]] + [
            4 * levels * n_tiles, 8 * levels * n_tiles, n]:
        scratch_at.append(scratch_at[-1] + -(-nbytes // 16) * 16)
    for lvl, (dim, cap) in enumerate(zip(dims, caps)):
        words += [dim, cap, *level_at[lvl],
                  scratch_at[lvl - 1] if lvl else -1]
    words += [0, *scratch_at[levels - 1:-1]]
    array = (ctypes.c_longlong * len(words))(*words)
    return out_words, scratch_at[-1], array, sizes, crd_pieces, seg_pieces


def coo_to_levels(keys: torch.Tensor, valid: torch.Tensor,
                  dims_list: Sequence[int], caps: Sequence[int]
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                             List[torch.Tensor]]:
    """``coord_ops.coo_to_levels`` on the card: returns (segs, crds,
    counts) as described in the module docstring.

    CPU tensors take the plain version; CUDA tensors launch the kernels.
    Every level's ``crd`` and ``seg`` and the counts are views of one
    allocation. The kernel's scratch (``par``, 8 bytes a slot of every
    level below the root, tile counts, a byte a row) is a second one, so
    that the returned views do not keep it alive.
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
    n = keys.shape[0]
    (out_words, scratch_bytes, plan, sizes, crd_pieces,
     seg_pieces) = _plan(n, tuple(dims_list), tuple(caps))
    keys, valid = _aligned(keys), _aligned(valid)
    out = torch.empty(out_words, dtype=torch.int32, device=keys.device)
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8,
                          device=keys.device)
    _build.call("sam_coo_levels", keys.data_ptr(), valid.data_ptr(), n,
                len(crd_pieces), _TILE, plan, out.data_ptr(),
                scratch.data_ptr())
    coo_to_levels.launches += 1
    pieces = out.split(sizes)
    return ([pieces[i] for i in seg_pieces], [pieces[i] for i in crd_pieces],
            list(pieces[0].view(torch.int64).unbind()))


coo_to_levels.launches = 0
