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
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from ..core import coord_ops as co
from ..distributed import sharding as shd
from .common import (apply_rope, dense_init, device_of, init_rms, rms_norm,
                     rope_angles)

__all__ = ["NEG_INF", "init_attention", "attention", "init_kv_cache",
           "check_cache_room"]

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


def _write_tokens(cache_arr, new, pos):
    """``cache_arr`` with ``new`` (B, s, ...) written at the per-batch
    offsets ``pos``; the caller has checked the room."""
    b, s = new.shape[:2]
    dev = cache_arr.device
    idx = pos.long()[:, None] + torch.arange(s, device=dev)[None, :]
    bidx = torch.arange(b, device=dev)[:, None].expand(b, s)
    return cache_arr.index_put((bidx, idx), new.to(cache_arr.dtype))


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
    heads). A placed cache (its sequence split over the model axis, the
    reference's rule) is moved onto the K and V heads' placements, so
    each shard writes and reads its own rows and heads. Where the model
    axis does not divide the heads, the layer's weights are made whole
    over it first."""
    cd = compute_dtype
    x = x.to(cd)
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
    query heads. A placed cache (its sequence split over the model axis,
    the reference's rule) is moved to the placements of ``k`` and ``v``,
    so each shard writes and reads its own rows and KV heads."""
    first = 0
    if n_heads is not None:
        rank, size = shd.model_coordinate(q)
        first = rank * (n_heads // size)
    rows = shd.over_model(q, Replicate())
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
    return out[0], dict(zip(_CACHE, out[1:]))


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
        k_cache = _write_tokens(cache["k"], k, pos)
        v_cache = _write_tokens(cache["v"], v, pos)
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
