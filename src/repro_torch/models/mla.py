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
scatter would drop it. Placed over a mesh, the layer is
tensor-parallel on whole heads (``mla_attention``).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..core import coord_ops as co
from ..distributed import sharding as shd
from .attention import (NEG_INF, _rows_of, check_cache_room,
                        merge_over_axis, write_rows)
from .common import (apply_rope, dense_init, device_of, init_rms, rms_norm,
                     rope_angles)

__all__ = ["init_mla", "mla_attention", "init_mla_cache", "read_path",
           "mla_sequence_read"]


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
    """x: (B, S, D). With ``cache`` given, S is the new-token count and
    attention runs against the cached latents and the new ones.

    Placed with ``wq_b`` and ``wkv_b`` split over the model axis on whole
    heads and ``wo`` on its input rows (``distributed.sharding``), the
    layer is tensor-parallel as ``attention.attention`` is. ``wq_a`` and
    ``wkv_a`` are made whole over the model axis: their latents are
    normalized over the whole row and read by every head, and the weights
    are smaller than the latents' activations. The column-parallel
    ``wq_b`` and ``wkv_b`` give each shard its own heads, the scores and
    values run on them per shard through ``local_map`` (the shared RoPE
    key, read by every shard's heads, gets a ``Partial`` gradient), and
    the row-parallel ``wo`` leaves a float32 ``Partial`` sum over the
    model axis for the caller to reduce. Where the model axis does not
    divide the heads, or the three are not split, the layer's weights are
    made whole over it first.

    A placed cache (its sequence split over the model axis, the rules'
    ``cache_spec``) is read on its own sequence shards where that moves
    fewer bytes (``sharding.cache_read_path``: a decode step), in the
    absorbed form (``mla_sequence_read``); otherwise (a prefill that fills
    the cache) it is made whole over the model axis for the step (an
    all-gather of its sequence shards), each card writes its own rows, and
    it goes back on its own placements (a local slice)."""
    s = x.shape[1]
    cd = compute_dtype
    x = x.to(cd)
    split = (shd.model_sharded(p["wq_b"], 1)
             and shd.model_sharded(p["wkv_b"], 1)
             and shd.model_sharded(p["wo"], 0)
             and n_heads % shd.model_coordinate(p["wq_b"])[1] == 0)
    p = {k: v if split and k in _HEAD_SPLIT else shd.whole_over_model(v)
         for k, v in p.items()}

    q_lat = rms_norm(x @ p["wq_a"].to(cd), p["q_a_norm"])
    kv = x @ p["wkv_a"].to(cd)
    c_kv, k_rope = kv[..., :kv_lora_rank], kv[..., kv_lora_rank:]
    c_kv = rms_norm(c_kv, p["kv_a_norm"])
    k_rope = k_rope[..., None, :]  # single shared rope key head

    steps = torch.arange(s, dtype=torch.int32, device=x.device)
    seq = _sequence_read_applies(x, cache, n_heads, kv_lora_rank, rope_dim)
    if cache is None:
        pos, q_pos = None, steps[None, :]
        new_cache = None
    else:
        pos = cache["pos"]
        if not seq:
            check_cache_room(pos, s, cache["c_kv"].shape[1])
        q_pos = pos[:, None] + steps[None, :]

    cos, sin = rope_angles(q_pos, rope_dim, rope_theta)
    k_rope = apply_rope(k_rope, cos, sin)

    if seq:
        return _mla_sequence(
            p, q_lat, c_kv, k_rope[..., 0, :], cache, split=split,
            qk_nope_dim=qk_nope_dim, v_head_dim=v_head_dim,
            rope_dim=rope_dim, rope_theta=rope_theta, cd=cd)
    if cache is not None:
        c_kv_all = _write(cache["c_kv"], c_kv, pos)
        k_rope_all = _write(cache["k_rope"], k_rope[..., 0, :], pos)
        new_cache = {"c_kv": _placed_as(c_kv_all, cache["c_kv"]),
                     "k_rope": _placed_as(k_rope_all, cache["k_rope"]),
                     "pos": pos + s}
        c_kv = c_kv_all.to(cd)
        k_rope = k_rope_all.to(cd)[..., None, :]

    if split:
        # Megatron's f: the column-parallel products' input gradients are
        # partial sums over the model axis, reduced here
        q_lat, c_kv = shd.model_input(q_lat), shd.model_input(c_kv)
        k_rope = shd.model_input(k_rope)
    q = q_lat @ p["wq_b"].to(cd)                 # (B, S, heads x qk_head)
    kv_b = c_kv @ p["wkv_b"].to(cd)      # (B, S_kv, heads x (nope + v))
    core = functools.partial(
        _core, qk_nope_dim=qk_nope_dim, v_head_dim=v_head_dim,
        rope_dim=rope_dim, rope_theta=rope_theta, cd=cd, steps=steps)
    if not split:
        out = core(q, kv_b, k_rope, pos)
        return out @ p["wo"].to(cd), new_cache
    args = [q, kv_b, k_rope] + ([] if pos is None else [pos])
    in_pl = tuple(tuple(t.placements) for t in args)
    grad_pl = (in_pl[0], in_pl[1], tuple(shd.over_model(k_rope, Partial())),
               *in_pl[3:])
    out = local_map(core, out_placements=(in_pl[0],), in_placements=in_pl,
                    in_grad_placements=grad_pl,
                    device_mesh=q.device_mesh)(*args)
    # row-parallel: each shard's partial product in float32, so their sum
    # rounds to the compute dtype once, as one device's product
    return out.float() @ p["wo"].to(cd).float(), new_cache


# the projections split over the model axis on whole heads
_HEAD_SPLIT = ("wq_b", "wkv_b", "wo")


def _write(arr, new, pos):
    """``arr`` with ``new`` (B, s, ...) written at the rows' positions
    ``pos`` (``attention.write_rows``). On DTensors each card writes its
    own rows of the cache made whole on its other dims (an all-gather of
    the sequence shards over the model axis)."""
    if not isinstance(arr, DTensor):
        return write_rows(arr, new, pos)
    mesh = arr.device_mesh
    rows = tuple(p if p.is_shard() and p.dim == 0 else Replicate()
                 for p in arr.placements)
    return local_map(write_rows, out_placements=(rows,),
                     in_placements=(rows,) * 3, device_mesh=mesh)(
        *(t.redistribute(mesh, rows) for t in (arr, new, pos)))


def _placed_as(t, like):
    """``t`` on DTensor ``like``'s placements (a slice of a replicated
    dim: no collective); a plain ``t`` as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(like.device_mesh, like.placements)


def _core(q, kv_b, k_rope, pos=None, *, qk_nope_dim: int, v_head_dim: int,
          rope_dim: int, rope_theta: float, cd, steps):
    """The scores and values from the head projections' outputs: ``q``
    (B, S, heads x qk_head), ``kv_b`` (B, S_kv, heads x (nope + v)), the
    rotated shared key ``k_rope`` (B, S_kv, 1, rope) and, with a cache,
    the rows' positions before the step ``pos`` (B,); returns the input
    of ``wo`` (B, S, heads x v). On a model shard the heads are its own."""
    b, s = q.shape[:2]
    qk_head = qk_nope_dim + rope_dim
    heads = q.shape[-1] // qk_head
    q = q.reshape(b, s, heads, qk_head)
    q_nope, q_rope = q[..., :qk_nope_dim], q[..., qk_nope_dim:]
    kv_b = kv_b.reshape(b, -1, heads, qk_nope_dim + v_head_dim)
    k_nope, v = kv_b[..., :qk_nope_dim], kv_b[..., qk_nope_dim:]
    if pos is None:
        q_pos = k_pos = steps[None, :]
    else:
        q_pos = pos[:, None] + steps[None, :]
        k_pos = torch.arange(kv_b.shape[1], dtype=torch.int32,
                             device=q.device)[None, :]
    cos, sin = rope_angles(q_pos, rope_dim, rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)

    scale = 1.0 / (qk_head ** 0.5)
    # float32 scores, as the reference's preferred_element_type=float32;
    # the shared rope key broadcasts over the query heads
    scores = (torch.einsum("bqhd,bshd->bhqs", q_nope.float(), k_nope.float())
              + torch.einsum("bqhd,bsxd->bhqs", q_rope.float(),
                             k_rope.float())) * scale
    mask = q_pos[:, :, None] >= k_pos[:, None, :]
    if pos is not None:
        mask = mask & (k_pos[:, None, :] < (pos + s)[:, None, None])
    scores = torch.where(mask[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(cd)
    out = torch.einsum("bhqs,bshd->bqhd", probs, v)
    return out.reshape(b, -1, heads * v_head_dim)


# -- the sequence read: a placed latent cache read on its own shards ---------

_MLA_CACHE = ("c_kv", "k_rope", "pos")


def read_path(batch: int, tokens: int, cache_len: int, n_heads: int,
              kv_lora_rank: int, rope_dim: int, cache_dtype) -> str:
    """``sharding.cache_read_path`` for a step of ``tokens`` new tokens
    of ``batch`` rows against a latent cache of ``cache_len`` rows: the
    absorbed sequence read moves each query head's folded and RoPE queries
    and its partial latent context with its max and sum, in float32; the
    cache path the latents (``cache_dtype``)."""
    step = batch * tokens * n_heads * (2 * kv_lora_rank + rope_dim + 2) * 4
    latents = batch * cache_len * (kv_lora_rank + rope_dim) \
        * cache_dtype.itemsize
    return shd.cache_read_path(latents, step)


def _sequence_read_applies(x, cache, n_heads: int, kv_lora_rank: int,
                           rope_dim: int) -> bool:
    """Whether this step reads the latent ``cache`` on its own sequence
    shards (``_mla_sequence``): a placed cache whose sequence is split over
    the model axis, where ``read_path`` picks the sequence read."""
    if (cache is None or not isinstance(x, DTensor)
            or not shd.model_sharded(cache["c_kv"], 1)):
        return False
    b, rows = cache["c_kv"].shape[:2]
    return read_path(b, x.shape[1], rows, n_heads, kv_lora_rank, rope_dim,
                     cache["c_kv"].dtype) == "sequence"


def _mla_sequence(p, q_lat, c_kv, k_rope, cache, *, split, qk_nope_dim,
                  v_head_dim, rope_dim, rope_theta, cd):
    """``mla_attention`` on a placed latent cache read on its own sequence
    shards: the column-parallel ``wq_b`` gives each card its own heads'
    queries, ``mla_sequence_read`` runs on each card through ``local_map``
    with its columns of ``wkv_b``, and the row-parallel ``wo`` leaves a
    float32 ``Partial`` (heads not split: every head on every card, the
    weights whole). ``c_kv`` and the rotated ``k_rope`` (B, s, rope) are
    the step's new latents, whole over the model axis. Returns (the
    layer's output, the new cache on the placements it came with)."""
    q = q_lat @ p["wq_b"].to(cd)
    held = [cache[n] for n in _MLA_CACHE]
    for t in held:
        _rows_of(t, q)
    args = [q, c_kv, k_rope, *held, p["wkv_b"]]
    read = functools.partial(
        mla_sequence_read, axis=shd.ModelAxis(q.device_mesh), owners=split,
        qk_nope_dim=qk_nope_dim, v_head_dim=v_head_dim, rope_dim=rope_dim,
        rope_theta=rope_theta, cd=cd)
    out_pl = tuple(shd.over_model(q, Shard(2) if split else Replicate()))
    out, *new = local_map(
        read, out_placements=(out_pl, *(tuple(t.placements) for t in held)),
        in_placements=tuple(tuple(t.placements) for t in args),
        device_mesh=q.device_mesh)(*args)
    new_cache = dict(zip(_MLA_CACHE, new))
    if split:
        return out.float() @ p["wo"].to(cd).float(), new_cache
    return out @ p["wo"].to(cd), new_cache


def _latent_partials(scores, values, mask):
    """Masked float32 ``scores`` (B, H, s, S) of some rows of the latents
    ``values`` (B, S, d): ``o = Σ exp(score - m) · values`` (B, s, H, d),
    the row max ``m`` and sum ``l`` (B, s, H)."""
    scores = torch.where(mask[:, None], scores, NEG_INF)
    m = torch.amax(scores, dim=-1)
    e = torch.exp(scores - m[..., None])
    o = torch.einsum("bhqs,bsd->bqhd", e, values)
    return o, m.transpose(1, 2), torch.sum(e, dim=-1).transpose(1, 2)


def mla_sequence_read(q, c_new, kr_new, c_cache, kr_cache, pos, w, *, axis,
                      owners: bool, qk_nope_dim: int, v_head_dim: int,
                      rope_dim: int, rope_theta: float, cd):
    """One card's share of a step's MLA on its own rows of a latent cache
    whose sequence is split over the model axis (``axis``, a
    ``sharding.ModelAxis``; rank r of M holds the global rows [r·S/M,
    (r+1)·S/M)). ``q`` (B, s, heads x qk_head) are this card's heads'
    queries (every head without ``owners``), ``w`` its columns of
    ``wkv_b`` (kv_lora_rank, heads x (nope + v)), ``c_new`` and the
    rotated ``kr_new`` the step's new latents, whole. The new rows whose
    positions fall in this card's range are written (the rest dropped: no
    collective). The read is the absorbed form (DeepSeek-V2 §2.1.2), in
    float32: each card folds ``wkv_b``'s key half into its heads' queries,
    ``q_nope · W_nope,hᵀ``, the folded queries and the RoPE queries are
    gathered over the axis (B, s, H, kv_lora_rank + rope), every head is
    scored against this card's latents and keeps its partial latent
    context ``Σ p · c_kv``; merged (``attention.merge_over_axis``), each
    owner applies ``W_v,h``. The reference's association is ``q · (W c)``
    with ``W c`` rounded to ``cd``: in bfloat16 compute the two differ by
    that rounding. Returns (out (B, s, heads x v) in ``cd``, the c_kv and k_rope
    caches, pos + s)."""
    b, s = q.shape[:2]
    qk_head = qk_nope_dim + rope_dim
    rows, r = c_cache.shape[1], c_cache.shape[-1]
    lo = axis.rank * rows
    check_cache_room(pos, s, rows * axis.size)
    c_cache = write_rows(c_cache, c_new, pos, lo)
    kr_cache = write_rows(kr_cache, kr_new, pos, lo)
    steps = torch.arange(s, dtype=torch.int32, device=q.device)
    q_pos = pos[:, None] + steps[None, :]
    k_pos = lo + torch.arange(rows, dtype=torch.int32, device=q.device)
    mask = ((q_pos[:, :, None] >= k_pos[None, None, :])
            & (k_pos[None, None, :] < (pos + s)[:, None, None]))
    q = q.reshape(b, s, -1, qk_head)
    q_nope, q_rope = q[..., :qk_nope_dim], q[..., qk_nope_dim:]
    cos, sin = rope_angles(q_pos, rope_dim, rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    w = w.to(cd).reshape(r, q.shape[2], qk_nope_dim + v_head_dim)
    c, kr = c_cache.to(cd).float(), kr_cache.to(cd).float()
    scale = 1.0 / (qk_head ** 0.5)
    feats = torch.cat([torch.einsum("bqhn,rhn->bqhr", q_nope.float(),
                                    w[..., :qk_nope_dim].float()),
                       q_rope.float()], dim=-1)
    if owners:
        feats = axis.gather(feats, 2)
    scores = (torch.einsum("bqhr,bsr->bhqs", feats[..., :r], c)
              + torch.einsum("bqhd,bsd->bhqs", feats[..., r:], kr))
    ctx = merge_over_axis(axis, *_latent_partials(scores * scale, c, mask),
                          owners)
    out = torch.einsum("bqhr,rhv->bqhv", ctx, w[..., qk_nope_dim:].float())
    return out.to(cd).reshape(b, s, -1), c_cache, kr_cache, pos + s


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
