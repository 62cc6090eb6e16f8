"""GQA/MQA attention with RoPE, qk-norm, sliding windows, a prefix-LM mask,
a soft cap, and KV caching.

A port of ``repro.models.attention``: the same einsum formulation, in
``torch.einsum``. The reference takes its score einsum on bfloat16
operands with ``preferred_element_type=float32``; here the operands are
cast to float32 first, the softmax runs in float32, and the
probabilities go back to the compute dtype, as there. ``NEG_INF`` is the
reference's finite constant, so a fully masked row gives the same
uniform softmax. The reference's cache write drops a token past
``max_seq`` (a JAX scatter ignores out-of-range updates); here a write
past the end raises ``ValueError`` before anything reaches the device.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..core import coord_ops as co
from ..distributed import sharding as shd
from .common import (apply_rope, dense_init, device_of, init_rms, rms_norm,
                     rope_angles)

__all__ = ["NEG_INF", "init_attention", "attention", "init_kv_cache",
           "check_cache_room", "read_path", "write_rows", "sequence_partials",
           "merge_partials", "merge_over_axis", "sequence_read"]

NEG_INF = -2.3819763e38


def init_attention(gen: Optional[torch.Generator], d_model: int,
                   n_heads: int, n_kv: int, head_dim: int, dtype,
                   qk_norm: bool = False) -> dict:
    p = {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype),
        "wk": dense_init(gen, d_model, n_kv * head_dim, dtype),
        "wv": dense_init(gen, d_model, n_kv * head_dim, dtype),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype),
    }
    if qk_norm:
        p["q_norm"] = init_rms(head_dim, dtype, device_of(gen))
        p["k_norm"] = init_rms(head_dim, dtype, device_of(gen))
    return p


def _mask(q_pos, k_pos, window: Optional[int], prefix_len):
    """(..., Sq, Sk) boolean attention mask."""
    m = q_pos[..., :, None] >= k_pos[..., None, :]
    if prefix_len is not None:
        # prefix-LM: bidirectional attention within the prefix (PaliGemma)
        m = m | (k_pos[..., None, :] < prefix_len)
    if window is not None:
        m = m & (q_pos[..., :, None] - k_pos[..., None, :] < window)
    return m


def check_cache_room(pos: torch.Tensor, s: int, max_seq: int) -> None:
    """Raise ``ValueError`` unless ``s`` new tokens fit behind every
    row's ``pos`` in a cache of ``max_seq`` slots (one read on the
    host). Meta tensors hold no positions to read: the dry-run's steps
    on them skip the check."""
    if pos.device.type == "meta":
        return
    end = int(pos.max()) + s if pos.numel() else s
    if end > max_seq:
        raise ValueError(f"the cache holds {max_seq} tokens; writing {s} "
                         f"at position {end - s} would end at {end}")


def write_rows(arr, new, pos, lo: int = 0):
    """``arr`` (B, rows, ...), the rows from global position ``lo`` on of
    a cache (all of it, or a shard of one split over its sequence), with
    the rows of ``new`` (B, s, ...) whose positions ``pos + t`` fall among
    them written; the others (a neighbour's) are dropped. The caller has
    checked the room."""
    b, s = new.shape[:2]
    rows, dev = arr.shape[1], arr.device
    idx = pos.long()[:, None] + torch.arange(s, device=dev)[None, :] - lo
    idx = torch.where((idx >= 0) & (idx < rows), idx,
                      torch.full_like(idx, rows))
    bidx = torch.arange(b, device=dev)[:, None].expand(b, s)
    buf = torch.cat([arr, arr[:, :1]], dim=1)     # a spare row: the drops
    buf.index_put_((bidx, idx), new.to(arr.dtype))
    return buf[:, :rows]


def attention(p: dict, x: torch.Tensor, *, n_heads: int, n_kv: int,
              head_dim: int, rope_theta: float = 10000.0,
              qk_norm: bool = False, window: Optional[int] = None,
              prefix_len=None, compute_dtype=torch.bfloat16,
              cache: Optional[dict] = None,
              soft_cap: Optional[float] = None
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, S, D). With ``cache`` given, S is the new-token count and
    attention runs against cache + new tokens (decode/prefill-extend).

    Placed with ``wq`` and ``wo`` split over the model axis on whole heads
    (``distributed.sharding``), the layer is tensor-parallel: the
    column-parallel projections give each model shard its own heads, the
    core (norms, RoPE, scores, values) runs on them per shard through
    ``local_map``, and the row-parallel ``wo`` leaves a float32
    ``Partial`` sum over the model axis for the caller to reduce (in
    float32, then cast: a partial rounded to bfloat16 on each shard would
    move the loss by about 1e-4 of itself). K and V heads that the
    model axis does not divide are computed whole on every shard and each
    shard takes the ones its query heads read (Megatron's replicated KV
    heads). Where the model axis does not divide the heads, the layer's
    weights are made whole over it first.

    A placed cache (its sequence split over the model axis, the
    reference's rule) is read on its own sequence shards where that moves
    fewer bytes than the cache (``sharding.cache_read_path``: a decode
    step): ``_sequence_attention``. Otherwise (a prefill that fills the
    cache) it is moved onto the K and V heads' placements for the step,
    so each shard writes and reads its own rows and heads, and back onto
    its own placements (``_per_shard``). Either way the cache comes back
    on the placements it came with."""
    cd = compute_dtype
    x = x.to(cd)
    if _sequence_read_applies(x, cache, n_heads, head_dim, cd):
        return _sequence_attention(
            p, x, cache, n_heads=n_heads, head_dim=head_dim,
            qk_norm=qk_norm, cd=cd, rope_theta=rope_theta, window=window,
            prefix_len=prefix_len, soft_cap=soft_cap)
    split = _heads_split(p, n_heads)
    if not split:
        p = {k: shd.whole_over_model(v) for k, v in p.items()}
    elif not (n_kv % shd.model_coordinate(p["wq"])[1] == 0
              and shd.model_sharded(p["wk"], 1)
              and shd.model_sharded(p["wv"], 1)):
        p = dict(p, wk=shd.whole_over_model(p["wk"]),
                 wv=shd.whole_over_model(p["wv"]))
    if split:
        x = shd.model_input(x)
    q = x @ p["wq"].to(cd)
    k = x @ p["wk"].to(cd)
    v = x @ p["wv"].to(cd)
    norms = (p["q_norm"], p["k_norm"]) if qk_norm else ()
    core = functools.partial(
        _core, head_dim=head_dim, group=n_heads // n_kv,
        rope_theta=rope_theta, window=window, prefix_len=prefix_len,
        cd=cd, soft_cap=soft_cap)
    if not (isinstance(q, DTensor) and (split or cache is not None)):
        out, new_cache = core(q, k, v, *norms, cache=cache)
    else:
        out, new_cache = _per_shard(core, q, k, v, norms, cache,
                                    n_heads if split else None)
    if split:
        # row-parallel: each shard's partial product in float32, so their
        # sum rounds to the compute dtype once, as one device's product
        return out.float() @ p["wo"].to(cd).float(), new_cache
    return out @ p["wo"].to(cd), new_cache


_CACHE = ("k", "v", "pos")


def _per_shard(core, q, k, v, norms, cache, n_heads):
    """``core`` through ``local_map`` on DTensor projections: each shard
    runs it on its rows and, with ``n_heads`` given (split heads), on its
    query heads. A placed cache whose sequence is split over the model
    axis (the reference's rule) is moved to the placements of ``k`` and
    ``v`` for the step, so each shard writes and reads its own rows and KV
    heads, and back to its own placements after it; a cache whole over
    the model axis stays so, each shard writing every KV head's new rows
    (``k`` and ``v`` made whole over the axis) and reading its own."""
    first = 0
    if n_heads is not None:
        rank, size = shd.model_coordinate(q)
        first = rank * (n_heads // size)
    rows = shd.over_model(q, Replicate())
    if cache is not None and not shd.model_sharded(cache["k"], 1):
        if any(shd.model_sharded(cache["k"], d) for d in (0, 2, 3)):
            raise ValueError(
                f"a cache split over the model axis on a dim other than its "
                f"sequence: {cache['k'].placements}")
        k, v = shd.whole_over_model(k), shd.whole_over_model(v)
    # K and V whole on the model axis: each shard's gradient covers the
    # heads it read, a partial sum over the axis
    kv_grad = [t.placements if shd.model_sharded(t, 2)
               else shd.over_model(t, Partial()) for t in (k, v)]
    args, in_pl, grad_pl = [q, k, v], [q.placements, k.placements,
                                       v.placements], [q.placements, *kv_grad]
    out_pl = [q.placements]
    if cache is not None:
        held = [c.redistribute(c.device_mesh, pl) for c, pl in zip(
            (cache[n] for n in _CACHE), (k.placements, v.placements, rows))]
        args += held
        in_pl += [t.placements for t in held]
        grad_pl += [t.placements for t in held]
        out_pl += [t.placements for t in held]
    args += list(norms)
    in_pl += [n.placements for n in norms]
    grad_pl += [_partial_everywhere(n) for n in norms]

    def local(q, k, v, *rest):
        if cache is None:
            return core(q, k, v, *rest, first_head=first)[0]
        c = dict(zip(_CACHE, rest[:3]))
        o, nc = core(q, k, v, *rest[3:], cache=c, first_head=first)
        return (o,) + tuple(nc[n] for n in _CACHE)
    out = local_map(local, out_placements=tuple(out_pl),
                    in_placements=tuple(in_pl),
                    in_grad_placements=tuple(grad_pl),
                    device_mesh=q.device_mesh)(*args)
    if cache is None:
        return out, None
    return out[0], {n: t.redistribute(t.device_mesh, cache[n].placements)
                    for n, t in zip(_CACHE, out[1:])}


def _heads_split(p: dict, n_heads: int) -> bool:
    """Whether ``p``'s query and output projections are split over the
    model axis on whole heads."""
    if not (shd.model_sharded(p["wq"], 1) and shd.model_sharded(p["wo"], 0)):
        return False
    return n_heads % shd.model_coordinate(p["wq"])[1] == 0


def _partial_everywhere(t) -> tuple:
    """The gradient placements of a replicated scale that each shard uses
    on its own rows and heads: a partial sum on every mesh axis."""
    return (Partial(),) * t.device_mesh.ndim


def _core(q, k, v, *norms, head_dim: int, group: int, rope_theta: float,
          window, prefix_len, cd, soft_cap, cache=None, first_head=0):
    """Attention from the projections' outputs (B, S, heads x head_dim) to
    the input of ``wo`` (B, S, heads x head_dim): the q/k norms, RoPE, the
    cache write, the GQA scores and the values. On a model shard ``q``
    holds the query heads from ``first_head`` on, and ``k``/``v`` either
    the KV heads they read or every KV head (each query head then takes
    its own, ``group`` query heads a KV head)."""
    b, s = q.shape[:2]
    n_q, n_k = q.shape[-1] // head_dim, k.shape[-1] // head_dim
    q = q.reshape(b, s, n_q, head_dim)
    k = k.reshape(b, s, n_k, head_dim)
    v = v.reshape(b, s, n_k, head_dim)

    if norms:
        q = rms_norm(q, norms[0])
        k = rms_norm(k, norms[1])

    steps = torch.arange(s, dtype=torch.int32, device=q.device)
    if cache is None:
        q_pos = steps[None, :]
        k_pos = q_pos
        cos, sin = rope_angles(q_pos, head_dim, rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        new_cache = None
    else:
        pos = cache["pos"]                       # (B,) current lengths
        check_cache_room(pos, s, cache["k"].shape[1])
        q_pos = pos[:, None] + steps[None, :]
        cos, sin = rope_angles(q_pos, head_dim, rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        k_cache = write_rows(cache["k"], k, pos)
        v_cache = write_rows(cache["v"], v, pos)
        k, v = k_cache.to(cd), v_cache.to(cd)
        k_pos = torch.arange(k.shape[1], dtype=torch.int32,
                             device=q.device)[None, :]
        new_cache = {"k": k_cache, "v": v_cache, "pos": pos + s}

    if n_k * group != n_q:
        # every KV head on this shard: each local query head takes its own
        idx = torch.div(first_head + torch.arange(n_q, device=q.device),
                        group, rounding_mode="floor")
        k, v, n_k, group = k[:, :, idx], v[:, :, idx], n_q, 1
    qg = q.reshape(b, -1, n_k, group, head_dim)
    # float32 scores from the compute-dtype operands, as the reference's
    # preferred_element_type=float32
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    scores = scores / (head_dim ** 0.5)
    if soft_cap is not None:
        scores = torch.tanh(scores / soft_cap) * soft_cap
    mask = _mask(q_pos, k_pos, window, prefix_len)
    if cache is not None:
        mask = mask & (k_pos[..., None, :] < (cache["pos"] + s)[:, None, None])
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(cd)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    out = out.reshape(b, -1, n_q * head_dim)
    return out, new_cache


# -- the sequence read: a placed cache read on its own sequence shards --------

def read_path(batch: int, tokens: int, cache_len: int, n_heads: int,
              n_kv: int, head_dim: int, cd, cache_dtype) -> str:
    """``sharding.cache_read_path`` for a step of ``tokens`` new tokens
    of ``batch`` rows against a K/V cache of ``cache_len`` rows: the
    sequence read moves the queries (compute dtype ``cd``) and the float32
    partials (a head's output, max and sum) of every query head, the
    cache path K and V of every KV head (``cache_dtype``)."""
    step = batch * tokens * n_heads * (head_dim * cd.itemsize
                                       + (head_dim + 2) * 4)
    kv = 2 * batch * cache_len * n_kv * head_dim * cache_dtype.itemsize
    return shd.cache_read_path(kv, step)


def _sequence_read_applies(x, cache, n_heads: int, head_dim: int, cd) -> bool:
    """Whether this step reads ``cache`` on its own sequence shards
    (``_sequence_attention``): a placed cache whose sequence is split over
    the model axis, where ``read_path`` picks the sequence read."""
    if (cache is None or not isinstance(x, DTensor)
            or not shd.model_sharded(cache["k"], 1)):
        return False
    b, rows, n_kv = cache["k"].shape[:3]
    return read_path(b, x.shape[1], rows, n_heads, n_kv, head_dim, cd,
                     cache["k"].dtype) == "sequence"


def _rows_of(t, like) -> None:
    """Raise ``ValueError`` unless DTensor ``t`` (a cache leaf) splits its
    batch over the mesh's other axes as ``like`` (the step's activations)
    does: each card must hold the cache rows of its own batch rows."""
    if shd.over_model(t, Replicate()) != shd.over_model(like, Replicate()):
        raise ValueError(f"a placed cache's batch rows {t.placements} differ "
                         f"from the step's {like.placements}")


def _sequence_attention(p, x, cache, *, n_heads, head_dim, qk_norm, cd,
                        rope_theta, window, prefix_len, soft_cap):
    """``attention`` on a placed cache read on its own sequence shards:
    the projections as the rules place them (no weight is gathered over
    the model axis), then ``sequence_read`` on each card through
    ``local_map``. Where the model axis splits the heads, each card ends
    with its own heads, and ``wo`` is row-parallel as on the train path;
    where it does not (gemma-2b's 8 heads on 16, llama3.2-3b's 24), every
    card ends with every head and takes its own rows of a row-parallel
    ``wo``, or all of a whole one. Returns (the layer's output, a float32
    ``Partial`` over the model axis where ``wo`` is split, the new cache
    on the placements it came with)."""
    q = x @ p["wq"].to(cd)
    k = x @ p["wk"].to(cd)
    v = x @ p["wv"].to(cd)
    held = [cache[n] for n in _CACHE]
    for t in held:
        _rows_of(t, q)
    owners = _heads_split(p, n_heads)
    out_split = owners or shd.model_sharded(p["wo"], 0)
    norms = [p["q_norm"], p["k_norm"]] if qk_norm else []
    args = [q, k, v, *held, *norms]
    read = functools.partial(
        sequence_read, axis=shd.ModelAxis(q.device_mesh),
        gathered=tuple(shd.model_sharded(t, 2) for t in (q, k, v)),
        owners=owners, out_split=out_split, head_dim=head_dim,
        rope_theta=rope_theta, window=window, prefix_len=prefix_len, cd=cd,
        soft_cap=soft_cap)
    out_pl = tuple(shd.over_model(q, Shard(2) if out_split else Replicate()))
    out, *new = local_map(
        read, out_placements=(out_pl, *(tuple(t.placements) for t in held)),
        in_placements=tuple(tuple(t.placements) for t in args),
        device_mesh=q.device_mesh)(*args)
    new_cache = dict(zip(_CACHE, new))
    if out_split:
        return out.float() @ p["wo"].to(cd).float(), new_cache
    return out @ p["wo"].to(cd), new_cache


def sequence_partials(q, k, v, q_pos, k_pos, bound, *, window=None,
                      prefix_len=None, soft_cap=None):
    """The float32 partial softmax read of queries ``q`` (B, s, H, hd) at
    positions ``q_pos`` (B, s) against some rows of K and V (B, S, n_kv,
    hd) at global positions ``k_pos`` (S,), ``bound`` (B,) the rows'
    lengths after the step: ``o = Σ exp(score - m) · v`` (B, s, H, hd),
    the row max ``m`` and sum ``l`` (B, s, H), with ``_core``'s scores and
    mask (GQA, soft cap, causal, window, prefix). A fully masked row has
    ``m`` = ``NEG_INF`` and takes no weight beside one that is not."""
    b, s, n_q, hd = q.shape
    n_k = k.shape[2]
    qg = q.reshape(b, s, n_k, n_q // n_k, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    scores = scores / (hd ** 0.5)
    if soft_cap is not None:
        scores = torch.tanh(scores / soft_cap) * soft_cap
    mask = _mask(q_pos, k_pos[None, :], window, prefix_len)
    mask = mask & (k_pos[None, None, :] < bound[:, None, None])
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    m = torch.amax(scores, dim=-1)
    e = torch.exp(scores - m[..., None])
    o = torch.einsum("bkgqs,bskh->bqkgh", e, v.float())
    return (o.reshape(b, s, n_q, hd),
            *(t.permute(0, 3, 1, 2).reshape(b, s, n_q)
              for t in (m, torch.sum(e, dim=-1))))


def merge_partials(o, m, l):
    """The softmax read from partials stacked on a leading dim (one a
    sequence shard): ``o`` (M, ..., hd), ``m`` and ``l`` (M, ...), merged
    by log-sum-exp; float32."""
    w = torch.exp(m - torch.amax(m, dim=0))
    return (torch.sum(o * w[..., None], dim=0)
            / torch.sum(l * w, dim=0)[..., None])


def merge_over_axis(axis, o, m, l, owners: bool):
    """The partials ``o`` (B, s, H, d), ``m``, ``l`` (B, s, H) of every
    head on this card's rows, merged over the model axis (``axis``): with
    ``owners``, each head's partials go to the card that owns it (one
    all-to-all) and it merges them (B, s, H/M, d); else a MAX all-reduce
    of the row maxes and a SUM all-reduce of the rescaled outputs and
    sums, every head on every card (B, s, H, d)."""
    if owners:
        b, s, h = m.shape
        part = torch.cat([o, m[..., None], l[..., None]], dim=-1)
        part = axis.to_owners(part.reshape(
            b, s, axis.size, h // axis.size, -1).movedim(2, 0))
        return merge_partials(part[..., :-2], part[..., -2], part[..., -1])
    w = torch.exp(m - axis.amax(m))
    part = axis.sum(torch.cat([o * w[..., None], (l * w)[..., None]], -1))
    return part[..., :-1] / part[..., -1:]


def sequence_read(q, k, v, k_cache, v_cache, pos, *norms, axis, gathered,
                  owners: bool, out_split: bool, head_dim: int,
                  rope_theta: float, window, prefix_len, cd, soft_cap):
    """One card's share of a step's attention on its own rows of a cache
    whose sequence is split over the model axis (``axis``, a
    ``sharding.ModelAxis``: rank r of M holds the global rows [r·S/M,
    (r+1)·S/M)). ``q``, ``k``, ``v`` are the projections' outputs (B, s,
    columns) on this card, gathered over the axis where ``gathered`` says
    they are split (a decode step's few rows). The q/k norms and RoPE run
    on every head; the new K and V rows whose positions fall in this
    card's range are written (the rest are dropped: no collective); every
    query head is scored against this card's rows
    (``sequence_partials``), and the partials are merged over the axis
    (``merge_over_axis``). With ``owners`` (the heads split on whole
    heads) the card returns its own heads; otherwise every head, or with
    ``out_split`` its own columns (the rows of its row-parallel ``wo``).
    The partials stay in float32 up to the merge, where ``_core`` rounds
    the probabilities to ``cd`` before the value product: in bfloat16
    compute the two differ by that rounding. Returns (out (B, s, columns)
    in ``cd``, the K and V caches, pos + s)."""
    b, s = q.shape[:2]
    q, k, v = (axis.gather(t, 2) if g else t
               for t, g in zip((q, k, v), gathered))
    q = q.reshape(b, s, -1, head_dim)
    k = k.reshape(b, s, -1, head_dim)
    v = v.reshape(b, s, -1, head_dim)
    if norms:
        q = rms_norm(q, norms[0])
        k = rms_norm(k, norms[1])
    rows = k_cache.shape[1]
    lo = axis.rank * rows
    check_cache_room(pos, s, rows * axis.size)
    q_pos = pos[:, None] + torch.arange(s, dtype=torch.int32,
                                        device=q.device)[None, :]
    cos, sin = rope_angles(q_pos, head_dim, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    k_cache = write_rows(k_cache, k, pos, lo)
    v_cache = write_rows(v_cache, v, pos, lo)
    k_pos = lo + torch.arange(rows, dtype=torch.int32, device=q.device)
    o, m, l = sequence_partials(q, k_cache.to(cd), v_cache.to(cd), q_pos,
                                k_pos, pos + s, window=window,
                                prefix_len=prefix_len, soft_cap=soft_cap)
    out = merge_over_axis(axis, o, m, l, owners).reshape(b, s, -1)
    if out_split and not owners:
        n = out.shape[-1] // axis.size
        out = out[..., axis.rank * n:(axis.rank + 1) * n]
    return out.to(cd), k_cache, v_cache, pos + s


def init_kv_cache(batch: int, max_seq: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    """Zeroed K and V of (batch, max_seq, n_kv, head_dim) and int32
    positions, on ``device`` (CUDA unless the caller names one)."""
    dev = co.resolve_device(device)
    return {
        "k": torch.zeros((batch, max_seq, n_kv, head_dim), dtype=dtype,
                         device=dev),
        "v": torch.zeros((batch, max_seq, n_kv, head_dim), dtype=dtype,
                         device=dev),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }
