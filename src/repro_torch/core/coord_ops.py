"""Coordinate-array primitives: the SAM blocks as PyTorch tensor ops.

The PyTorch counterpart of ``repro.core.coord_ops``. Each SAM stream is a
fixed-capacity coordinate/value tensor plus a validity mask and a
``parent`` index tensor that encodes the hierarchical stop-token structure
(element i's fiber is identified by ``parent[i]``). Every op below keeps
its output shapes independent of the data, so a plan's capacities fix
every allocation:

  scan_level      — Def 3.1 level scanner: expand (seg, crd) fibers of the
                    selected parent references (vectorized ragged expand)
  intersect_keys  — Def 3.2 intersecter: sorted-key membership via
                    searchsorted
  union_keys      — Def 3.3 unioner: merge + dedup with per-side hole masks
  repeat is a gather:  out = ref[parent_idx]  (Def 3.4; no op needed)
  segment_sum     — Def 3.7 reducer (n=0): one sum per parent fiber
  keyed_union_reduce — Def 3.7 reducer (n>=1): dense workspace or
                    sort-by-key + boundary detection + segment-sum
  compact         — level writer / final construction (Def 3.8)
  locate_keys     — Def 4.1 locator: a probe inside the parent's fiber

Dtypes follow the reference array by array: int32 for ``seg``, ``crd``,
``ref`` and ``parent_idx``; int64 for keys (``PAD_KEY`` is the int64
maximum); float32 for values; bool for masks.

Indexing differs from JAX in one way that shapes this module: JAX clamps
an out-of-range gather and ``jax.ops.segment_sum`` drops an out-of-range
id, while PyTorch raises (or trips a device-side assert). Every gather
here indexes with a clamped position, and every segment sum goes through
``index_add_`` on a buffer with one spare slot that swallows the
out-of-range ids and is sliced off.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

I32 = torch.int32
I64 = torch.int64
PAD_KEY = torch.iinfo(torch.int64).max  # sorts after every real key

# keyed_union_reduce switches from sort-merge to a dense scatter-add
# workspace when the caller-declared key space fits this many slots
DENSE_REDUCE_BOUND = 1 << 20


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when CUDA is asked for (the default) and there is no GPU: the
    port never carries on silently on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def _clip(x, lo, hi):
    """``jnp.clip`` semantics: ``min(max(x, lo), hi)`` (hi wins if lo > hi)."""
    return torch.clamp(torch.clamp(x, min=lo), max=hi)


def _first_flags(sk):
    """True at the first element of every run of equal sorted keys."""
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    return first


def exclusive_cumsum(x):
    out = torch.zeros_like(x)
    out[1:] = torch.cumsum(x, 0)[:-1]
    return out


def compact(mask: torch.Tensor, arrays: Tuple[torch.Tensor, ...], cap: int,
            fill=0) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Stable compaction of ``arrays`` rows where ``mask``, into ``cap`` rows.

    Returns (compacted arrays, count). Rows beyond ``count`` hold ``fill``.
    Gather-side, like the reference: output slot ``i`` binary-searches
    the mask's running count for the ``i+1``-th marked row, so the count
    never has to reach the host.
    """
    dev = mask.device
    if mask.shape[0] == 0:
        outs = tuple(torch.full((cap,) + tuple(a.shape[1:]), fill,
                                dtype=a.dtype, device=dev) for a in arrays)
        return outs, torch.zeros((), dtype=I32, device=dev)
    csum = torch.cumsum(mask.to(I64), 0)
    count = csum[-1]
    src = torch.searchsorted(
        csum, torch.arange(1, cap + 1, dtype=I64, device=dev))
    src = _clip(src, 0, mask.shape[0] - 1)
    live = torch.arange(cap, device=dev) < count
    outs = []
    for a in arrays:
        lv = live.reshape((cap,) + (1,) * (a.dim() - 1))
        outs.append(torch.where(lv, a[src],
                                torch.tensor(fill, dtype=a.dtype, device=dev)))
    return tuple(outs), count.to(I32)


def scan_level(seg: torch.Tensor, crd: torch.Tensor,
               parent_ref: torch.Tensor, parent_valid: torch.Tensor,
               cap: int):
    """Expand the fibers addressed by ``parent_ref`` into a child stream.

    Returns (crd, ref, parent_idx, valid) tensors of length ``cap``.
    ``parent_ref < 0`` (holes from unions) scan as empty fibers.
    """
    dev = crd.device
    if crd.shape[0] == 0:  # tensor level with no stored coordinates
        z = torch.zeros((cap,), dtype=I32, device=dev)
        return z, z.clone(), z.clone(), torch.zeros((cap,), dtype=torch.bool,
                                                   device=dev)
    seg = seg.to(I64)
    pr = _clip(parent_ref.to(I64), 0, seg.shape[0] - 2)
    ok = parent_valid & (parent_ref >= 0)
    lengths = torch.where(ok, seg[pr + 1] - seg[pr], 0)
    starts = exclusive_cumsum(lengths)
    if lengths.shape[0]:
        total = starts[-1] + lengths[-1]
    else:
        total = torch.zeros((), dtype=I64, device=dev)
    # segment id of each output slot: number of starts <= position
    pos = torch.arange(cap, dtype=I64, device=dev)
    sid = torch.searchsorted(starts, pos, right=True) - 1
    sid = _clip(sid, 0, lengths.shape[0] - 1)
    intra = pos - starts[sid]
    valid = pos < total
    ref = torch.where(valid, seg[pr[sid]] + intra, 0)
    out_crd = torch.where(valid, crd[_clip(ref, 0, crd.shape[0] - 1)], 0)
    return out_crd.to(I32), ref.to(I32), sid.to(I32), valid


def intersect_keys(a_key, a_valid, b_key, b_valid):
    """Sorted-key intersection. Returns (mask over a, b positions).

    ``a_key``/``b_key`` must be sorted with invalid rows keyed PAD_KEY.
    A surviving element keeps its position in *a*; its reference in *b*
    is the searchsorted probe.
    """
    if b_key.shape[0] == 0:
        return (torch.zeros_like(a_valid),
                torch.zeros(a_key.shape, dtype=I32, device=a_key.device))
    idx = torch.searchsorted(b_key, a_key)
    idxc = _clip(idx, 0, b_key.shape[0] - 1)
    hit = (b_key[idxc] == a_key) & a_valid & (a_key != PAD_KEY)
    hit = hit & b_valid[idxc]
    return hit, idxc.to(I32)


def union_keys(a_key, a_valid, b_key, b_valid, cap: int):
    """Sorted-key union with per-side presence masks.

    Returns (keys, in_a, a_pos, in_b, b_pos, valid) of length ``cap``.
    """
    dev = a_key.device
    a_key = torch.where(a_valid, a_key, PAD_KEY)
    b_key = torch.where(b_valid, b_key, PAD_KEY)
    allk = torch.sort(torch.cat([a_key, b_key])).values
    keep = _first_flags(allk) & (allk != PAD_KEY)
    (keys,), count = compact(keep, (allk,), cap, fill=PAD_KEY)
    valid = torch.arange(cap, device=dev) < count
    outs = [keys]
    for side in (a_key, b_key):
        i = _clip(torch.searchsorted(side, keys), 0, side.shape[0] - 1)
        outs += [(side[i] == keys) & valid, i.to(I32)]
    return (*outs, valid)


def locate_keys(level_seg, level_crd, parent_ref, probe_crd, valid):
    """Def 4.1 locator: find ``probe_crd`` inside the fiber at parent_ref.

    Returns (found mask, refs). The search runs inside ``[lo, hi)`` of
    each row's own fiber: every stored coordinate is keyed by
    ``(fiber, crd)``, which is globally sorted because ``seg`` is
    monotone and each fiber is sorted, and the probe searches for its
    own ``(fiber, crd)`` key. (The reference searches the whole ``crd``
    array, which is sorted only inside each fiber, and then clamps into
    ``[lo, hi)``: that misses coordinates in levels holding more than one
    fiber.)
    """
    dev = level_crd.device
    n = level_crd.shape[0]
    if n == 0:
        return (torch.zeros_like(valid),
                torch.zeros(probe_crd.shape, dtype=I32, device=dev))
    seg = level_seg.to(I64)
    fid = torch.searchsorted(seg, torch.arange(n, dtype=I64, device=dev),
                             right=True) - 1
    gkey = (fid << 32) + level_crd.to(I64)
    pr = _clip(parent_ref.to(I64), 0, seg.shape[0] - 2)
    lo, hi = seg[pr], seg[pr + 1]
    probe = (pr << 32) + probe_crd.to(I64)
    idx = _clip(torch.searchsorted(gkey, probe), 0, n - 1)
    found = (gkey[idx] == probe) & valid & (parent_ref >= 0) & (hi > lo)
    return found, torch.where(found, idx, 0).to(I32)


def default_segment_sum(vals, seg_ids, num_segments: int):
    """Plain keyed segment-sum; the dispatch-table fallback impl.

    Ids outside ``[0, num_segments)`` are dropped, as
    ``jax.ops.segment_sum`` drops them.
    """
    ids = seg_ids.to(I64)
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out = torch.zeros((num_segments + 1,) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    out.index_add_(0, ids, vals)
    return out[:num_segments]


def dense_workspace_result(sums, hits, cap: int):
    """Compact a dense workspace (per-slot ``sums`` and appearance counts
    ``hits``) into a keyed-reduce result ``(keys, vals, valid, count)``.

    A slot that any live key hit stays, even when its sum is 0. Shared by
    the dense branch below and every workspace kernel's dispatch entry, so
    their results are bit-identical.
    """
    dev = sums.device
    (uk, uv), count = compact(
        hits > 0, (torch.arange(sums.shape[0], dtype=I64, device=dev), sums),
        cap, fill=0)
    out_valid = torch.arange(cap, device=dev) < count
    return (torch.where(out_valid, uk, PAD_KEY),
            torch.where(out_valid, uv, 0.0), out_valid, count)


def keyed_union_reduce(keys, vals, valid, cap: int, segment_sum_impl=None,
                       key_bound=None):
    """Def 3.7 reducer for n>=1 / multi-term union: sum ``vals`` at equal
    ``keys``.

    Returns (unique_keys, summed_vals, valid, count) of length ``cap``;
    ``count`` is the number of distinct live keys, so a caller with a
    fixed ``cap`` can detect overflow (``count > cap`` means truncation).
    The inner segment-sum is pluggable: ``kernels.ops`` routes it to the
    ``segment_reduce`` CUDA kernel on the GPU.

    ``key_bound`` is an exclusive upper bound on live key values when the
    caller knows one. A bound up to ``DENSE_REDUCE_BOUND`` selects the
    dense-workspace merge (one scatter-add over a ``key_bound``-slot
    accumulator, keys cast to int32 as in the reference); larger or
    unknown bounds keep the sort-based merge.
    """
    segsum = segment_sum_impl or default_segment_sum
    dev = keys.device
    if key_bound is not None and int(key_bound) <= DENSE_REDUCE_BOUND:
        nseg = max(int(key_bound), 1)
        # invalid rows take the dropped id nseg: their zeros land nowhere
        k = torch.where(valid, keys, nseg).to(I32)
        v0 = torch.where(valid, vals, torch.zeros((), dtype=vals.dtype,
                                                  device=dev))
        return dense_workspace_result(segsum(v0, k, nseg),
                                      segsum(valid.to(v0.dtype), k, nseg),
                                      cap)
    n = keys.shape[0]
    if n == 0:
        return (torch.full((cap,), PAD_KEY, dtype=I64, device=dev),
                torch.zeros((cap,), dtype=vals.dtype, device=dev),
                torch.zeros((cap,), dtype=torch.bool, device=dev),
                torch.zeros((), dtype=I32, device=dev))
    keys = torch.where(valid, keys, PAD_KEY)
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    sv = torch.where(valid[order], vals[order], 0.0)
    first = _first_flags(sk)
    live = sk != PAD_KEY
    # padding rows (sorted last) take the dropped id n: their sum is
    # never read
    seg_id = torch.where(live, torch.cumsum(first.to(I64), 0) - 1, n)
    sums = segsum(sv, seg_id, n)
    keep = first & live
    (uk,), count = compact(keep, (sk,), cap, fill=PAD_KEY)
    if cap <= n:
        uv = sums[:cap]
    else:
        uv = torch.cat([sums, torch.zeros((cap - n,), dtype=sums.dtype,
                                          device=dev)])
    # sums are indexed by seg_id order == compacted order
    out_valid = torch.arange(cap, device=dev) < count
    return uk, torch.where(out_valid, uv, 0.0), out_valid, count


def mul_reduce(keys, a_vals, b_vals, valid, cap: int, *, key_bound=None,
               segment_sum_impl=None):
    """Fused multiply × keyed reduce: sum ``a_vals * b_vals`` at equal
    ``keys``.

    The exact unfused composition, so routing through it is bit-identical
    to computing the product eagerly (``kernels/ops.py`` lowers it to the
    ``scatter_workspace`` kernel in ``mul_pair`` mode on the GPU).
    Returns ``(keys, vals, valid, count)`` like ``keyed_union_reduce``.
    """
    return keyed_union_reduce(keys, a_vals * b_vals, valid, cap,
                              segment_sum_impl, key_bound=key_bound)


def fused_intersect_mul_reduce(a_key, a_valid, a_vals, b_key, b_valid,
                               b_vals, out_key, cap: int, *, key_bound=None,
                               segment_sum_impl=None):
    """The Gustavson inner loop as ONE primitive: sorted intersection of
    ``b`` into ``a`` × value gather × multiply × keyed segment-reduce.

    ``a_key``/``b_key`` are sorted stream keys (invalid rows keyed
    ``PAD_KEY``); ``a_vals``/``out_key`` are aligned to *a* positions and
    ``b_vals`` to *b* positions. This fallback is the composition of
    ``intersect_keys`` + gather + multiply + ``keyed_union_reduce``.
    Returns ``(keys, vals, valid, count)`` like ``keyed_union_reduce``.
    """
    hit, idx = intersect_keys(a_key, a_valid, b_key, b_valid)
    if b_vals.shape[0] == 0:
        prod = torch.zeros_like(a_vals)
    else:
        prod = a_vals * b_vals[idx]
    return keyed_union_reduce(out_key, prod, hit, cap, segment_sum_impl,
                              key_bound=key_bound)


def accumulate_coo(acc_keys, acc_vals, keys, vals, key_bound=None,
                   segment_sum_impl=None, union_reduce_impl=None, *,
                   device=None):
    """Merge a new keyed COO partial into a running accumulator.

    Inputs and outputs are host (numpy) arrays of live entries only; the
    merge itself runs on ``device`` with ONE ``keyed_union_reduce``.
    Returns ``(keys, vals)`` sorted by key, unique. Values are cast to
    float32, as in the reference. ``device`` defaults to CUDA (see
    ``resolve_device``). ``union_reduce_impl`` routes the merge
    through a dispatch-table implementation; None keeps this module's
    fallback.
    """
    device = resolve_device(device)
    k = torch.cat([torch.as_tensor(np.asarray(acc_keys), dtype=I64),
                   torch.as_tensor(np.asarray(keys), dtype=I64)]).to(device)
    v = torch.cat([torch.as_tensor(np.asarray(acc_vals), dtype=torch.float32),
                   torch.as_tensor(np.asarray(vals), dtype=torch.float32)]
                  ).to(device)
    if k.shape[0] == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.float32))
    cap = max(8, 1 << (int(k.shape[0]) - 1).bit_length())
    union_reduce = union_reduce_impl or keyed_union_reduce
    uk, uv, _, count = union_reduce(
        k, v, torch.ones(k.shape, dtype=torch.bool, device=k.device), cap,
        segment_sum_impl, key_bound=key_bound)
    n = int(count)
    return uk[:n].cpu().numpy(), uv[:n].cpu().numpy()


def convert_level(level, num_parents: int):
    """Canonicalize ONE fibertree level to engine-native (seg, crd) storage.

    Host-side numpy, as in the reference: hashed levels drop their slot
    view over the sorted backing arrays, bitmap/bitvector words expand to
    (seg, crd) in ascending bit order, dense/compressed levels pass
    unchanged. Non-unique (``singleton``) levels cannot convert
    level-locally and raise; ``fibertree.canonical_tree`` rebuilds such
    trees whole instead.
    """
    from .fibertree import (BITMAP, BITVECTOR, BV_WIDTH, COMPRESSED, DENSE,
                            HASHED, SINGLETON, Level)
    if level.format in (DENSE, COMPRESSED):
        return level
    if level.format == HASHED:
        return Level(format=COMPRESSED, dim=level.dim, seg=level.seg,
                     crd=level.crd)
    if level.format in (BITVECTOR, BITMAP):
        segs = [0]
        crds: list = []
        for p in range(int(num_parents)):
            for wi, w in enumerate(level.words[p]):
                w = int(w)
                b = 0
                while w >> b:
                    if (w >> b) & 1:
                        crds.append(wi * BV_WIDTH + b)
                    b += 1
            segs.append(len(crds))
        return Level(format=COMPRESSED, dim=level.dim,
                     seg=np.asarray(segs, dtype=np.int64),
                     crd=np.asarray(crds, dtype=np.int64))
    if level.format == SINGLETON:
        raise ValueError("singleton levels convert tree-wide "
                         "(FiberTree.convert), not level-locally")
    raise ValueError(level.format)


def segment_sum(vals, parent_idx, valid, num_parents: int):
    """Def 3.7 scalar reducer (n=0): one sum per parent fiber (zero-mode)."""
    v = torch.where(valid, vals, 0.0)
    return default_segment_sum(v, parent_idx, num_parents)


def coo_to_levels(keys, valid, dims_list, caps):
    """Sorted unique COO keys -> compressed fibertree levels, on device.

    ``dims_list`` is the per-level extent (outer -> inner); ``caps[l]`` is
    the capacity of level ``l``'s coordinate array. Returns ``(segs,
    crds, counts)`` shaped as in the reference: ``segs[l]`` has length
    ``caps[l-1] + 1`` (2 for the root level), ``crds[l]`` has length
    ``caps[l]``, and ``counts[l]`` is the number of live entries at level
    ``l``, so a caller with fixed caps can detect overflow.
    """
    dev = keys.device
    n = len(dims_list)
    pref = [None] * n
    cur = torch.where(valid, keys, PAD_KEY)
    for l in range(n - 1, -1, -1):
        pref[l] = cur
        if l:
            cur = torch.where(valid, cur // dims_list[l], PAD_KEY)
    segs, crds, counts = [], [], []
    parent_cap = 1
    # rank of each element's enclosing level-(l-1) fiber (root: fiber 0)
    parent_rank = torch.zeros(keys.shape[0], dtype=I64, device=dev)
    for l in range(n):
        first = _first_flags(pref[l]) & valid
        cnt = torch.sum(first.to(I64))
        (crd_l, par_l), _ = compact(
            first, (pref[l] % dims_list[l], parent_rank), caps[l], fill=0)
        # padding rows must sort AFTER every live parent so the seg
        # boundaries below count only live entries
        live = torch.arange(caps[l], device=dev) < cnt
        par_l = torch.where(live, par_l, parent_cap)
        # entries are key-sorted, so parents are non-decreasing:
        # seg[p] = first entry whose parent >= p
        seg_l = torch.searchsorted(
            par_l, torch.arange(parent_cap + 1, dtype=I64, device=dev)
        ).to(I32)
        segs.append(seg_l)
        crds.append(torch.where(live, crd_l, 0).to(I32))
        counts.append(cnt)
        parent_rank = torch.cumsum(first.to(I64), 0) - 1
        parent_cap = caps[l]
    return segs, crds, counts
