"""SAM-primitive dispatch table: the engine's hot primitives by device.

The PyTorch counterpart of the table in ``repro/kernels/ops.py``. The
compiled engine resolves its hot primitives here:

  keyed_segment_sum    — the inner sum of ``coord_ops.keyed_union_reduce``;
      on the GPU the ``segment_reduce`` kernel, for any segment count.
  sorted_intersect     — sorted-key stream intersection; the searchsorted
      fallback everywhere (the reference has no kernel for it).
  keyed_union_reduce   — the keyed merge of multi-term results; on the GPU
      the ``scatter_workspace`` kernel for a declared key bound up to
      ``DENSE_REDUCE_BOUND``; up to ``SEGMENT_DENSE_BOUND`` the
      ``segment_reduce`` kernel's [a*b, 1] mode over the key space itself
      (a dense workspace of ``key_bound`` rows, no sort, nothing staged);
      beyond it the reference's sort-merge with ``segment_reduce`` as its
      inner sum.
  mul_reduce           — a mul-ALU product folded into the final keyed
      reduce; on the GPU ``scatter_workspace`` in ``mul_pair`` mode, or
      ``segment_reduce``'s [a*b, 1] mode over the key space (the product
      is formed inside either kernel), or the sort-merge, by key bound as
      above.
  intersect_mul_reduce — the whole Gustavson inner loop; on the GPU the
      ``fused_stream`` kernel. The engine does not resolve it (neither
      does the reference's).
  coo_to_levels        — the program-fusion COO→levels handoff of a fused
      program's intermediate; on the GPU the ``coo_levels`` kernel, for
      any level extent and capacity.

The block-sparse kernels (``spmm_bsr``, ``sddmm_bsr``,
``bsr_flash_attention``) are called by ``core/bsr_bridge.BsrEngine``
directly, not through the table. This module also keeps the port's numpy
copies of the reference's BCSR bookkeeping (``bsr_from_block_coords``,
``sliding_window_kv_idx``), because the reference module imports JAX.

Entries under ``"cuda"`` never return the plain PyTorch result for a CUDA
tensor: they launch a kernel or raise. (A CPU tensor handed to them takes
each kernel wrapper's plain version, which is how the CPU tests exercise
the entries.) The TPU's VMEM-sized guards do not carry over: the
workspace lives in device memory. float16/bfloat16 payloads go through
float32, as in the reference; float64 runs the kernels' double
instantiation.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core import coord_ops as _co
from . import _build
from .bsr_attention import bsr_flash_attention
from .coo_levels import coo_to_levels
from .fused_stream import fused_imr_workspace
from .scatter_workspace import scatter_workspace
from .sddmm_bsr import sddmm_bsr
from .segment_reduce import segment_reduce, segment_reduce_mul
from .spmm_bsr import spmm_bsr

_COUNTED = {"scatter_workspace": scatter_workspace,
            "segment_reduce": segment_reduce,
            "fused_imr": fused_imr_workspace,
            "spmm_bsr": spmm_bsr,
            "sddmm_bsr": sddmm_bsr,
            "bsr_attention": bsr_flash_attention,
            "coo_to_levels": coo_to_levels}


def _keyed_segment_sum_cuda(vals, seg_ids, num_segments: int):
    """1-D keyed segment-sum on the ``segment_reduce`` kernel."""
    return segment_reduce(vals[:, None], seg_ids,
                          num_segments=num_segments)[:, 0]


# Beyond the workspace kernel's bound, a key space up to this many slots
# still reduces densely on the card: ``segment_reduce``'s [a*b, 1] mode
# sums [value, 1] rows straight into a (key_bound, 2) workspace of
# [sums, hits] (at most 256 MiB in float32). The sort-merge it replaces sorts a plan's whole
# capacity, and a sort holds about 46 bytes a row on the card (keys,
# sorted keys, permutation and the sort's own buffers), the largest
# allocation of a tile. ``segment_reduce`` rather than a wider
# ``scatter_workspace`` keeps the keyed reduces of large key spaces on the
# kernel that ran them before (the sort-merge's inner sum).
SEGMENT_DENSE_BOUND = 1 << 25


def _dense(key_bound) -> bool:
    return key_bound is not None and int(key_bound) <= _co.DENSE_REDUCE_BOUND


def _segment_dense(key_bound) -> bool:
    return key_bound is not None and int(key_bound) <= SEGMENT_DENSE_BOUND


def _workspace_ids(keys, valid, nseg: int):
    """``scatter_workspace``'s int32 slot of each row, the dropped slot
    ``nseg`` where the row is masked (built in place: a stream-sized int32
    array and a mask's negation, nothing wider)."""
    return keys.to(torch.int32).masked_fill_(~valid, nseg)


def _segment_workspace(keys, valid, cap: int, key_bound, a_vals,
                       b_vals=None):
    """A keyed reduce over a bounded key space in one ``segment_reduce``
    launch in its [a*b, 1] mode: each valid row adds [value, 1] into its
    key's row of a dense workspace, which compacts like
    ``scatter_workspace``'s (a live key with sum 0 keeps its slot). The
    value is ``a_vals``, or ``a_vals * b_vals`` formed inside the kernel.
    The kernel reads the keys, values and mask as they are and skips a
    masked row before its (possibly garbage) values: nothing is staged."""
    ws = segment_reduce_mul(keys, a_vals, b_vals, valid,
                            num_segments=max(int(key_bound), 1))
    return _co.dense_workspace_result(ws[:, 0], ws[:, 1], cap)


def _keyed_union_reduce_cuda(keys, vals, valid, cap: int,
                             segment_sum_impl=None, key_bound=None):
    """Keyed merge: one ``scatter_workspace`` pass produces the sums and
    the appearance counts (a live key with sum 0 keeps its slot). Up to
    ``SEGMENT_DENSE_BOUND`` keys, ``segment_reduce`` over the key space;
    beyond it, the sort-merge with the ``segment_reduce`` kernel as its
    inner sum (``segment_sum_impl`` is ignored: on a CUDA tensor the
    inner sum is always the kernel)."""
    if not _dense(key_bound) and _segment_dense(key_bound):
        return _segment_workspace(keys, valid, cap, key_bound, vals)
    if not _dense(key_bound):
        return _co.keyed_union_reduce(keys, vals, valid, cap,
                                      _keyed_segment_sum_cuda,
                                      key_bound=key_bound)
    nseg = max(int(key_bound), 1)
    acc = _build.acc_dtype(vals.dtype, "keyed_union_reduce")
    cols = torch.empty((valid.shape[0], 2), dtype=acc, device=valid.device)
    cols[:, 0] = vals
    cols[:, 1] = valid
    ws = scatter_workspace(_workspace_ids(keys, valid, nseg), cols,
                           num_slots=nseg)
    return _co.dense_workspace_result(ws[:, 0], ws[:, 1], cap)


def _mul_reduce_cuda(keys, a_vals, b_vals, valid, cap: int, *,
                     key_bound=None, segment_sum_impl=None):
    """Fused multiply × keyed reduce: the product is formed inside the
    workspace kernel (``mul_pair``), so the engine's deferred mul-ALU
    never materializes a product stream. Beyond the dense bound,
    ``segment_reduce`` over the key space up to ``SEGMENT_DENSE_BOUND``
    keys, else the sort-merge over the product with the ``segment_reduce``
    kernel."""
    if not _dense(key_bound) and _segment_dense(key_bound):
        return _segment_workspace(keys, valid, cap, key_bound, a_vals,
                                  b_vals)
    if not _dense(key_bound):
        return _co.mul_reduce(keys, a_vals, b_vals, valid, cap,
                              key_bound=key_bound,
                              segment_sum_impl=_keyed_segment_sum_cuda)
    nseg = max(int(key_bound), 1)
    acc = _build.acc_dtype(a_vals.dtype, "mul_reduce")
    cols = torch.empty((valid.shape[0], 3), dtype=acc, device=valid.device)
    cols[:, 0] = a_vals
    cols[:, 1] = b_vals
    cols[:, 2] = valid
    ws = scatter_workspace(_workspace_ids(keys, valid, nseg), cols,
                           num_slots=nseg, mul_pair=True)
    return _co.dense_workspace_result(ws[:, 0], ws[:, 1], cap)


def _fused_imr_cuda(a_key, a_valid, a_vals, b_key, b_valid, b_vals,
                    out_key, cap: int, *, key_bound=None,
                    segment_sum_impl=None):
    """The whole Gustavson inner loop as one kernel (``fused_stream``).
    The streams must be level-scanner shaped: valid keys strictly
    increase within each stream and *b* is prefix-valid. Beyond the dense
    bound, the composition with the ``segment_reduce`` kernel as the
    inner sum."""
    if not _dense(key_bound):
        return _co.fused_intersect_mul_reduce(
            a_key, a_valid, a_vals, b_key, b_valid, b_vals, out_key, cap,
            key_bound=key_bound, segment_sum_impl=_keyed_segment_sum_cuda)
    nseg = max(int(key_bound), 1)
    ak = torch.where(a_valid, a_key, _co.PAD_KEY)
    bk = torch.where(b_valid, b_key, _co.PAD_KEY)
    bv = torch.where(b_valid, b_vals, 0.0)
    ws = fused_imr_workspace(ak, a_vals, torch.clamp(out_key, 0, nseg - 1),
                             bk, bv, num_slots=nseg)
    return _co.dense_workspace_result(ws[:, 0], ws[:, 1], cap)


SAM_PRIMITIVES = {
    "keyed_segment_sum": {
        "cuda": _keyed_segment_sum_cuda,
        "fallback": _co.default_segment_sum,
    },
    "sorted_intersect": {
        "fallback": _co.intersect_keys,
    },
    "keyed_union_reduce": {
        "cuda": _keyed_union_reduce_cuda,
        "fallback": _co.keyed_union_reduce,
    },
    "mul_reduce": {
        "cuda": _mul_reduce_cuda,
        "fallback": _co.mul_reduce,
    },
    "intersect_mul_reduce": {
        "cuda": _fused_imr_cuda,
        "fallback": _co.fused_intersect_mul_reduce,
    },
    "coo_to_levels": {
        "cuda": coo_to_levels,
        "fallback": _co.coo_to_levels,
    },
}


def sam_primitive(name: str, device=None):
    """Resolve a SAM primitive to the implementation for ``device``
    (default CUDA): the ``"cuda"`` entry for a CUDA device where there
    is one, else the fallback."""
    impls = SAM_PRIMITIVES[name]
    backend = _co.resolve_device(device).type
    return impls.get(backend, impls["fallback"])


def register_primitive(name: str, backend: str, impl) -> None:
    """Register (or override) one implementation of a SAM primitive.

    The entry must match the fallback's calling convention exactly. A
    backend entry is refused until the primitive has a fallback, so
    ``sam_primitive`` always resolves.
    """
    if backend != "fallback" and "fallback" not in SAM_PRIMITIVES.get(
            name, {}):
        raise ValueError(f"primitive {name!r} needs a fallback "
                         f"implementation before backend entries")
    SAM_PRIMITIVES.setdefault(name, {})[backend] = impl


def launch_counts() -> dict:
    """Launch counters of every kernel wrapper, by kernel name."""
    return {name: fn.launches for name, fn in _COUNTED.items()}


def route_counts() -> dict:
    """Launches by route (``"tensor_cores"``, ``"cuda_cores"``) of the
    wrappers that choose between two kernels, by kernel name."""
    return {name: dict(fn.route_launches) for name, fn in _COUNTED.items()
            if hasattr(fn, "route_launches")}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0
        if hasattr(fn, "route_launches"):
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)


# -- BCSR bookkeeping (numpy copies of ``repro/kernels/ops.py``) -------------

def bsr_from_block_coords(rows: np.ndarray, cols: np.ndarray,
                          blocks: np.ndarray, n_brow: int
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO block coordinates -> padded per-row slot maps for spmm_bsr.

    Returns (blk_map, col_idx, blocks_padded); pad slots point at the
    appended all-zero block.
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    nnzb = len(rows)
    counts = np.bincount(rows, minlength=n_brow)
    max_nnz = max(int(counts.max(initial=0)), 1)
    blk_map = np.full((n_brow, max_nnz), nnzb, dtype=np.int32)
    col_idx = np.zeros((n_brow, max_nnz), dtype=np.int32)
    if nnzb:
        # slot of block b = its rank within its row, in input order: a
        # stable sort by row groups the blocks, and position-minus-
        # row-start inside the sorted order is the rank
        order = np.argsort(rows, kind="stable")
        row_start = np.zeros(n_brow, dtype=np.int64)
        row_start[1:] = np.cumsum(counts)[:-1]
        slot = np.empty(nnzb, dtype=np.int64)
        slot[order] = np.arange(nnzb) - row_start[rows[order]]
        blk_map[rows, slot] = np.arange(nnzb)
        col_idx[rows, slot] = cols
    zeros = np.zeros((1,) + blocks.shape[1:], blocks.dtype)
    return blk_map, col_idx, np.concatenate([blocks, zeros], axis=0)


def sliding_window_kv_idx(n_qblk: int, n_kvblk: int, window_blocks: int,
                          causal: bool = True) -> np.ndarray:
    """BCSR mask for sliding-window attention: each q block attends to the
    ``window_blocks`` kv blocks at/before it. Padded with the
    out-of-range sentinel ``n_kvblk``."""
    idx = np.full((n_qblk, window_blocks), n_kvblk, dtype=np.int32)
    for qi in range(n_qblk):
        hi = qi if causal else min(qi + window_blocks // 2, n_kvblk - 1)
        lo = max(0, hi - window_blocks + 1)
        w = list(range(lo, hi + 1))
        idx[qi, :len(w)] = w
    return idx
