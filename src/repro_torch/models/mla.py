"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437 §2.1).

Queries are low-rank projected through ``q_lora_rank``; keys/values share a
compressed latent ``kv_lora_rank`` plus a decoupled RoPE key of
``rope_head_dim``, one head shared by all query heads. Only (c_kv, k_rope,
pos) is cached: (kv_lora_rank + rope_head_dim) per token instead of
2*H*hd.

A port of ``repro.models.mla``, with the reference's float32 scores
(operands cast to float32 before the score einsums), its finite
``NEG_INF``, and a cache write past ``max_seq`` refused with
``ValueError`` (``attention.check_cache_room``) where the reference's
scatter would drop it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core import coord_ops as co
from .attention import NEG_INF, _write_tokens, check_cache_room
from .common import (apply_rope, dense_init, device_of, init_rms, rms_norm,
                     rope_angles)

__all__ = ["init_mla", "mla_attention", "init_mla_cache"]


def init_mla(gen: Optional[torch.Generator], d_model: int, n_heads: int, *,
             q_lora_rank: int = 1536, kv_lora_rank: int = 512,
             qk_nope_dim: int = 128, rope_dim: int = 64,
             v_head_dim: int = 128, dtype=torch.float32) -> dict:
    qk_head = qk_nope_dim + rope_dim
    dev = device_of(gen)
    return {
        "wq_a": dense_init(gen, d_model, q_lora_rank, dtype),
        "q_a_norm": init_rms(q_lora_rank, dtype, dev),
        "wq_b": dense_init(gen, q_lora_rank, n_heads * qk_head, dtype),
        "wkv_a": dense_init(gen, d_model, kv_lora_rank + rope_dim, dtype),
        "kv_a_norm": init_rms(kv_lora_rank, dtype, dev),
        "wkv_b": dense_init(gen, kv_lora_rank,
                            n_heads * (qk_nope_dim + v_head_dim), dtype),
        "wo": dense_init(gen, n_heads * v_head_dim, d_model, dtype),
    }


def mla_attention(p: dict, x: torch.Tensor, *, n_heads: int,
                  qk_nope_dim: int = 128, rope_dim: int = 64,
                  v_head_dim: int = 128, kv_lora_rank: int = 512,
                  rope_theta: float = 10000.0, compute_dtype=torch.bfloat16,
                  cache: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    b, s, _ = x.shape
    cd = compute_dtype
    x = x.to(cd)
    qk_head = qk_nope_dim + rope_dim

    q = rms_norm(x @ p["wq_a"].to(cd), p["q_a_norm"])
    q = (q @ p["wq_b"].to(cd)).reshape(b, s, n_heads, qk_head)
    q_nope, q_rope = q[..., :qk_nope_dim], q[..., qk_nope_dim:]

    kv = x @ p["wkv_a"].to(cd)
    c_kv, k_rope = kv[..., :kv_lora_rank], kv[..., kv_lora_rank:]
    c_kv = rms_norm(c_kv, p["kv_a_norm"])
    k_rope = k_rope[..., None, :]  # single shared rope key head

    steps = torch.arange(s, dtype=torch.int32, device=x.device)
    if cache is None:
        q_pos = steps[None, :]
        new_cache = None
    else:
        pos = cache["pos"]
        check_cache_room(pos, s, cache["c_kv"].shape[1])
        q_pos = pos[:, None] + steps[None, :]
        kv_len = cache["c_kv"].shape[1]

    cos, sin = rope_angles(q_pos, rope_dim, rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)

    if cache is not None:
        c_kv_all = _write_tokens(cache["c_kv"], c_kv, pos)
        k_rope_all = _write_tokens(cache["k_rope"], k_rope[..., 0, :], pos)
        new_cache = {"c_kv": c_kv_all, "k_rope": k_rope_all, "pos": pos + s}
        c_kv = c_kv_all.to(cd)
        k_rope = k_rope_all.to(cd)[..., None, :]
        k_pos = torch.arange(kv_len, dtype=torch.int32,
                             device=x.device)[None, :]
    else:
        k_pos = q_pos

    # expand latent to per-head keys/values
    kv_b = (c_kv @ p["wkv_b"].to(cd)).reshape(
        b, -1, n_heads, qk_nope_dim + v_head_dim)
    k_nope, v = kv_b[..., :qk_nope_dim], kv_b[..., qk_nope_dim:]

    scale = 1.0 / (qk_head ** 0.5)
    # float32 scores, as the reference's preferred_element_type=float32;
    # the shared rope key broadcasts over the query heads
    scores = (torch.einsum("bqhd,bshd->bhqs", q_nope.float(), k_nope.float())
              + torch.einsum("bqhd,bsxd->bhqs", q_rope.float(),
                             k_rope.float())) * scale
    mask = q_pos[:, :, None] >= k_pos[:, None, :]
    if cache is not None:
        mask = mask & (k_pos[:, None, :] < (pos + s)[:, None, None])
    scores = torch.where(mask[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(cd)
    out = torch.einsum("bhqs,bshd->bqhd", probs, v)
    out = out.reshape(b, -1, n_heads * v_head_dim)
    return out @ p["wo"].to(cd), new_cache


def init_mla_cache(batch: int, max_seq: int, kv_lora_rank: int = 512,
                   rope_dim: int = 64, dtype=torch.bfloat16,
                   device=None) -> dict:
    """Zeroed latent cache (c_kv, k_rope) and int32 positions, on
    ``device`` (CUDA unless the caller names one)."""
    dev = co.resolve_device(device)
    return {
        "c_kv": torch.zeros((batch, max_seq, kv_lora_rank), dtype=dtype,
                            device=dev),
        "k_rope": torch.zeros((batch, max_seq, rope_dim), dtype=dtype,
                              device=dev),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }
