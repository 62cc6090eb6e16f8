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

from typing import Optional, Tuple

import torch

from ..core import coord_ops as co
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
    attention runs against cache + new tokens (decode/prefill-extend)."""
    b, s, d = x.shape
    cd = compute_dtype
    x = x.to(cd)
    q = (x @ p["wq"].to(cd)).reshape(b, s, n_heads, head_dim)
    k = (x @ p["wk"].to(cd)).reshape(b, s, n_kv, head_dim)
    v = (x @ p["wv"].to(cd)).reshape(b, s, n_kv, head_dim)

    if qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])

    steps = torch.arange(s, dtype=torch.int32, device=x.device)
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
                             device=x.device)[None, :]
        new_cache = {"k": k_cache, "v": v_cache, "pos": pos + s}

    group = n_heads // n_kv
    qg = q.reshape(b, -1, n_kv, group, head_dim)
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
    out = out.reshape(b, -1, n_heads * head_dim)
    return out @ p["wo"].to(cd), new_cache


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
