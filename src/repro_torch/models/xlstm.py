"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunk-parallel)
and sLSTM (scalar memory, inherently sequential).

mLSTM maps onto the shared gated outer-product recurrence (q/k/v heads,
sigmoid forget gate -> log decay, exp input gate clipped at
``GATE_CLIP`` for stability in place of the paper's stabilizer state).
sLSTM keeps the paper's recurrent formulation with its stabilised
exponential gates, one step after another.

A port of ``repro.models.xlstm``: the reference's ``lax.scan`` over time
is a Python loop over time, ``jax.nn.log_sigmoid`` is ``F.logsigmoid``.
The recurrent states stay float32.

Placed over a mesh, both cells run their gates and recurrences per
shard through ``local_map`` on local tensors (``F.logsigmoid`` and its
backward never meet a DTensor, which has no rule for the backward):
mLSTM split on whole heads over the model axis (``mlstm``), sLSTM whole
on every model shard, per data shard (``slstm``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..core import coord_ops as co
from ..distributed import sharding as shd
from .common import dense_init, device_of, init_rms, normal, rms_norm
from .ssm_common import (chunked_gated_recurrence, gated_recurrence_step,
                         heads_split, per_shard_rows)

__all__ = ["GATE_CLIP", "init_mlstm", "mlstm", "init_mlstm_cache",
           "init_slstm", "slstm", "init_slstm_cache"]

GATE_CLIP = 8.0


# -- mLSTM -------------------------------------------------------------------

def init_mlstm(gen: Optional[torch.Generator], d_model: int, n_heads: int, *,
               proj_factor: float = 2.0, dtype=torch.float32) -> dict:
    d_inner = int(d_model * proj_factor)
    return {
        "w_up": dense_init(gen, d_model, 2 * d_inner, dtype),
        "wq": dense_init(gen, d_inner, d_inner, dtype),
        "wk": dense_init(gen, d_inner, d_inner, dtype),
        "wv": dense_init(gen, d_inner, d_inner, dtype),
        "w_if": dense_init(gen, d_inner, 2 * n_heads, dtype, scale=0.02),
        "norm": init_rms(d_inner, dtype, device_of(gen)),
        "w_down": dense_init(gen, d_inner, d_model, dtype),
    }


def mlstm(p: dict, xin: torch.Tensor, *, n_heads: int, chunk: int = 64,
          compute_dtype=torch.bfloat16, cache: Optional[dict] = None
          ) -> Tuple[torch.Tensor, Optional[dict]]:
    """xin: (B, S, D). With ``cache`` given, S is the new-token count.

    Placed with ``wq``/``wk``/``wv`` and ``w_down`` split over the model
    axis on whole heads (``distributed.sharding``), the cell is
    tensor-parallel: ``w_up`` gives each model shard ``xi`` whole and the
    ``gate`` columns of its own heads (``sharding.packed_product``); the
    column-parallel ``wq``/``wk``/``wv`` on ``xi`` give it its heads' q,
    k and v; ``w_if``, made whole over the model axis, its heads' ``i``
    and ``f``; the gates and the recurrence run per shard through
    ``local_map``, and the mLSTM state is placed with its heads over the
    model axis (``sharding.cache_spec``), so each shard reads and writes
    its own. The RMS norm over the whole ``d_inner`` row sums its squares
    over the model axis (DTensor's reduction over the split dim: one
    float32 all-reduce of (B, S) a layer, its gradient all-reduced back).
    The row-parallel ``w_down`` leaves a float32 ``Partial`` sum over the
    model axis for the caller to reduce. Where the model axis does not
    divide the heads, or the projections are not split, the cell's
    weights are made whole over it first, and it still runs per data
    shard."""
    b, s, _ = xin.shape
    cd = compute_dtype
    xin = xin.to(cd)
    d_inner = p["wq"].shape[0]
    if not isinstance(xin, DTensor):
        up = xin @ p["w_up"].to(cd)
        y, gate, hfin = _mlstm_core(
            up, p["wq"], p["wk"], p["wv"], p["w_if"],
            *((cache["mlstm"],) if cache else ()), n_heads=n_heads,
            rank=0, size=1, chunk=chunk, cd=cd)
        y = rms_norm(y, p["norm"]) * F.silu(gate.float()).to(cd)
        return (y @ p["w_down"].to(cd),
                None if cache is None else {"mlstm": hfin})
    rank, size = heads_split(xin, n_heads, all(
        shd.model_sharded(p[k], 1) for k in ("wq", "wk", "wv"))
        and shd.model_sharded(p["w_down"], 0))
    split = size > 1
    if not split:
        p = {k: shd.whole_over_model(v) for k, v in p.items()}
    xin = per_shard_rows(xin)
    up = shd.packed_product(xin, p["w_up"], (d_inner, d_inner),
                            (None, n_heads), split, cd)
    differs = shd.split_rows(xin, split)
    rows = tuple(shd.over_model(xin, Replicate()))
    heads_pl = tuple(shd.over_model(xin, Shard(2))) if split else rows
    state_pl = tuple(shd.over_model(xin, Shard(1))) if split else rows
    args = [up, p["wq"], p["wk"], p["wv"], shd.whole_over_model(p["w_if"])]
    if cache is not None:
        args.append(cache["mlstm"].redistribute(xin.device_mesh, state_pl))
    res = local_map(
        lambda *a: _mlstm_core(*a, n_heads=n_heads, rank=rank, size=size,
                               chunk=chunk, cd=cd),
        out_placements=(heads_pl, heads_pl, state_pl),
        in_placements=tuple(tuple(t.placements) for t in args),
        in_grad_placements=tuple(shd.per_shard_grads(t, differs)
                                 for t in args),
        device_mesh=xin.device_mesh)(*args)
    y = rms_norm(res[0], p["norm"]) * F.silu(res[1].float()).to(cd)
    if split:
        # row-parallel: each shard's partial product in float32, so their
        # sum rounds to the compute dtype once, as one device's product
        out = y.float() @ p["w_down"].to(cd).float()
    else:
        out = y @ p["w_down"].to(cd)
    if cache is None:
        return out, None
    return out, {"mlstm": res[2].redistribute(
        xin.device_mesh, cache["mlstm"].placements)}


def _mlstm_core(up, wq, wk, wv, w_if, state=None, *, n_heads: int,
                rank: int, size: int, chunk: int, cd):
    """The cell from ``w_up``'s output to the input of its norm, on the
    heads of model shard ``rank`` of ``size``: ``up`` holds ``xi`` whole
    and this shard's ``gate`` columns, ``wq``/``wk``/``wv`` this shard's
    columns, ``w_if`` whole (each shard takes its heads' ``i`` and ``f``),
    ``state`` this shard's heads' memory (zeros without it). Returns (y
    (B, S, its d_inner columns), its gate columns, the final state)."""
    b, s = up.shape[:2]
    d_inner = wq.shape[0]
    h_l = n_heads // size
    hd = d_inner // n_heads
    xi, gate = up[..., :d_inner], up[..., d_inner:]

    q = (xi @ wq.to(cd)).reshape(b, s, h_l, hd)
    k = (xi @ wk.to(cd)).reshape(b, s, h_l, hd) / (hd ** 0.5)
    v = (xi @ wv.to(cd)).reshape(b, s, h_l, hd)
    w_if = shd.pick_columns(w_if, shd.packed_ranges(
        (n_heads, n_heads), (n_heads, n_heads), rank, size))
    if_ = (xi @ w_if.to(cd)).float()
    i_log = torch.clamp(if_[..., :h_l], -GATE_CLIP, GATE_CLIP)
    f_gate = F.logsigmoid(if_[..., h_l:])                # log decay <= 0
    beta = torch.exp(i_log)

    if state is None:
        y, hfin = chunked_gated_recurrence(q, k, v, f_gate, beta, chunk=chunk)
    elif s == 1:
        y1, hfin = gated_recurrence_step(state, q[:, 0], k[:, 0], v[:, 0],
                                         f_gate[:, 0], beta[:, 0])
        y = y1[:, None]
    else:  # prefill: chunked recurrence seeded from the cached state
        y, hfin = chunked_gated_recurrence(q, k, v, f_gate, beta,
                                           chunk=chunk, h0=state)
    return y.to(cd).reshape(b, s, h_l * hd), gate, hfin


def init_mlstm_cache(batch: int, d_model: int, n_heads: int,
                     proj_factor: float = 2.0, device=None) -> dict:
    """The float32 matrix memory, zeroed, on ``device`` (CUDA unless the
    caller names one)."""
    d_inner = int(d_model * proj_factor)
    hd = d_inner // n_heads
    return {"mlstm": torch.zeros((batch, n_heads, hd, hd),
                                 dtype=torch.float32,
                                 device=co.resolve_device(device))}


# -- sLSTM -------------------------------------------------------------------

def init_slstm(gen: Optional[torch.Generator], d_model: int, n_heads: int,
               dtype=torch.float32) -> dict:
    hd = d_model // n_heads
    return {
        # input projections for (i, f, z, o) gates
        "w_in": dense_init(gen, d_model, 4 * d_model, dtype),
        # block-diagonal recurrent weights, per head
        "r": (normal(gen, (n_heads, hd, 4 * hd)) / hd ** 0.5).to(dtype),
        "norm": init_rms(d_model, dtype, device_of(gen)),
        "w_down": dense_init(gen, d_model, d_model, dtype),
    }


def slstm(p: dict, xin: torch.Tensor, *, n_heads: int,
          compute_dtype=torch.bfloat16, cache: Optional[dict] = None
          ) -> Tuple[torch.Tensor, Optional[dict]]:
    """xin: (B, S, D). With ``cache`` given, S is the new-token count.

    Placed, the cell's leaves are made whole over the model axis (the
    rules replicate all but the recurrent ``r``, 2.4 MB at full width in
    float32) and the whole cell runs per data shard through ``local_map``:
    one loop over time on local tensors, every head on every model shard.
    Its (B, H, hd) states, placed with their heads over the model axis,
    are made whole over it to be read (B·H·hd·4 floats) and go back on
    their placements (a local slice)."""
    cd = compute_dtype
    xin = xin.to(cd)
    if not isinstance(xin, DTensor):
        return _slstm_core(xin, p["w_in"], p["r"], p["norm"], p["w_down"],
                           *((cache[k] for k in _SLSTM) if cache else ()),
                           n_heads=n_heads, cd=cd)
    xin = per_shard_rows(xin)
    rows = tuple(xin.placements)
    differs = shd.split_rows(xin, False)
    args = [xin] + [shd.whole_over_model(p[k])
                    for k in ("w_in", "r", "norm", "w_down")]
    if cache is not None:
        args += [cache[k].redistribute(xin.device_mesh, rows)
                 for k in _SLSTM]
    out = local_map(
        lambda *a: _flat(_slstm_core(*a, n_heads=n_heads, cd=cd)),
        out_placements=(rows,) * (1 + (4 if cache is not None else 0)),
        in_placements=tuple(tuple(t.placements) for t in args),
        in_grad_placements=tuple(shd.per_shard_grads(t, differs)
                                 for t in args),
        device_mesh=xin.device_mesh)(*args)
    if cache is None:
        return out, None
    return out[0], {k: t.redistribute(t.device_mesh, cache[k].placements)
                    for k, t in zip(_SLSTM, out[1:])}


# the sLSTM states, in the order ``_slstm_core`` takes them
_SLSTM = ("h", "c", "n", "m")


def _flat(res):
    """``_slstm_core``'s (y, cache or None) as a flat tuple of tensors."""
    y, cache = res
    return y if cache is None else (y,) + tuple(cache[k] for k in _SLSTM)


def _slstm_core(xin, w_in, r, norm, w_down, h=None, c=None, n=None, m=None,
                *, n_heads: int, cd):
    b, s, d = xin.shape
    hd = d // n_heads
    gates_in = (xin @ w_in.to(cd)).reshape(b, s, n_heads, 4 * hd).float()
    r = r.float()
    cached = h is not None
    if not cached:
        state = init_slstm_cache(b, d, n_heads, device=xin.device)
        h, c, n, m = (state[k] for k in _SLSTM)

    hs = []
    for t in range(s):
        rec = torch.einsum("bhd,hdk->bhk", h, r)         # (B,H,4hd)
        z_all = gates_in[:, t] + rec
        i_log = torch.clamp(z_all[..., 0 * hd:1 * hd], -GATE_CLIP, GATE_CLIP)
        f_log = F.logsigmoid(z_all[..., 1 * hd:2 * hd])
        z = torch.tanh(z_all[..., 2 * hd:3 * hd])
        o = torch.sigmoid(z_all[..., 3 * hd:4 * hd])
        m_new = torch.maximum(f_log + m, i_log)          # stabilizer
        i = torch.exp(i_log - m_new)
        f = torch.exp(f_log + m - m_new)
        c = f * c + i * z
        n = f * n + i
        h = o * c / torch.clamp(torch.abs(n), min=1.0)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(b, s, d).to(cd)
    new_cache = {"h": h, "c": c, "n": n, "m": m} if cached else None
    y = rms_norm(y, norm)
    return y @ w_down.to(cd), new_cache


def init_slstm_cache(batch: int, d_model: int, n_heads: int,
                     device=None) -> dict:
    """The float32 states (h, c, n, m): zeros, and ones for the
    normalizer n, on ``device`` (CUDA unless the caller names one)."""
    hd = d_model // n_heads
    dev = co.resolve_device(device)

    def z():
        return torch.zeros((batch, n_heads, hd), dtype=torch.float32,
                           device=dev)
    return {"h": z(), "c": z(), "n": torch.ones_like(z()), "m": z()}
