"""Mamba2 block (state space duality form, arXiv:2405.21060) for Zamba2.

in_proj -> [z | x | B | C | dt], causal depthwise conv over (x,B,C),
selective SSM via the shared chunked gated recurrence (q=C, k=B,
decay=A*dt, beta=dt), skip connection D*x, gated output y*silu(z),
RMSNorm, out_proj. Decode keeps (conv window, SSM state) as the cache:
O(1) per token.

A port of ``repro.models.mamba2``. ``F.softplus`` returns its input above
20, where ``jax.nn.softplus`` has no threshold; the two differ there by
less than float32 resolves. The SSM state stays float32 whatever the
cache dtype.

Placed over a mesh (``mamba2``'s docstring), the block is
tensor-parallel on whole heads: each model shard runs the conv, the
recurrence and the gate on its own heads through ``local_map``, on
local tensors.
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

__all__ = ["D_CONV", "init_mamba2", "mamba2", "init_mamba2_cache"]

D_CONV = 4


def init_mamba2(gen: Optional[torch.Generator], d_model: int, *,
                expand: int = 2, headdim: int = 64, d_state: int = 64,
                n_groups: int = 1, dtype=torch.float32) -> dict:
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    d_in_proj = 2 * d_inner + 2 * n_groups * d_state + n_heads
    conv_dim = d_inner + 2 * n_groups * d_state
    dev = device_of(gen)
    f32 = torch.float32
    return {
        "in_proj": dense_init(gen, d_model, d_in_proj, dtype),
        "conv_w": (normal(gen, (D_CONV, conv_dim)) * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.zeros((n_heads,), dtype=f32, device=dev),
        "dt_bias": torch.zeros((n_heads,), dtype=f32, device=dev),
        "D_skip": torch.ones((n_heads,), dtype=f32, device=dev),
        "norm": init_rms(d_inner, dtype, dev),
        "out_proj": dense_init(gen, d_inner, d_model, dtype),
    }


def mamba2(p: dict, xin: torch.Tensor, *, expand: int = 2, headdim: int = 64,
           d_state: int = 64, n_groups: int = 1, chunk: int = 64,
           compute_dtype=torch.bfloat16, cache: Optional[dict] = None
           ) -> Tuple[torch.Tensor, Optional[dict]]:
    """xin: (B, S, D). With ``cache`` given, S is the new-token count
    (one: a decode step; more: a prefill seeded from the cache).

    Placed with ``out_proj`` split over the model axis on whole heads
    (``distributed.sharding``), the block is tensor-parallel: ``in_proj``
    gives each model shard ``z``, ``x`` and ``dt`` of its own heads and
    ``B`` and ``C`` whole (``sharding.packed_product``: the weight or the
    output gathered over the model axis, whichever moves fewer bytes);
    ``conv_w`` is made whole over the model axis and each shard takes its
    channels; the conv, softplus, the recurrence, ``D_skip`` and the
    ``silu(z)`` gate run per shard through ``local_map``. The RMS norm
    over the whole ``d_inner`` row sums its squares over the model axis
    (DTensor's reduction over the split dim: one float32 all-reduce of
    (B, S) a layer, its gradient all-reduced back). The row-parallel
    ``out_proj`` leaves a float32 ``Partial`` sum over the model axis for
    the caller to reduce. The ``ssm`` state is placed with its heads over
    the model axis (``sharding.cache_spec``): each shard reads and writes
    its own heads, and nothing moves it. The ``conv`` window (B, 3,
    conv_dim) is whole over the model axis by the rules (3 does not
    split): each shard reads its channels, and its new window's ``x``
    channels are gathered over the model axis to write it back (a small
    all-gather a layer a step). Where the model axis does not divide the
    heads, or ``out_proj`` is not split, the block's weights are made
    whole over it first, and it still runs per data shard."""
    b, s, d_model = xin.shape
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    gn = n_groups * d_state
    cd = compute_dtype
    xin = xin.to(cd)
    dims = dict(d_inner=d_inner, n_heads=n_heads, headdim=headdim,
                n_groups=n_groups, d_state=d_state, chunk=chunk, cd=cd)
    if not isinstance(xin, DTensor):
        zx = xin @ p["in_proj"].to(cd)
        y, win_x, win_bc, ssm = _core(
            zx, p["conv_w"], p["conv_b"], p["A_log"], p["dt_bias"],
            p["D_skip"], *((cache["conv"], cache["ssm"]) if cache else ()),
            rank=0, size=1, **dims)
        y = rms_norm(y, p["norm"])
        return y @ p["out_proj"].to(cd), _new_cache(cache, win_x, win_bc,
                                                    ssm)
    rank, size = heads_split(xin, n_heads,
                             shd.model_sharded(p["out_proj"], 0))
    split = size > 1
    if not split:
        p = {k: shd.whole_over_model(v) for k, v in p.items()}
    xin = per_shard_rows(xin)
    zx = shd.packed_product(xin, p["in_proj"],
                            (d_inner, d_inner, gn, gn, n_heads),
                            (n_heads, n_heads, None, None, n_heads), split,
                            cd)
    differs = shd.split_rows(xin, split)
    rows = tuple(shd.over_model(xin, Replicate()))
    heads_pl = tuple(shd.over_model(xin, Shard(xin.ndim - 1))) if split \
        else rows
    weights = [shd.whole_over_model(p["conv_w"])] + [
        p[k] for k in ("conv_b", "A_log", "dt_bias", "D_skip")]
    args = [zx] + weights
    out_pl = [heads_pl]
    if cache is not None:
        out_pl += [heads_pl, rows]
        ssm_pl = tuple(shd.over_model(xin, Shard(1))) if split else rows
        args += [cache["conv"].redistribute(xin.device_mesh, rows),
                 cache["ssm"].redistribute(xin.device_mesh, ssm_pl)]
        out_pl += [ssm_pl]
    in_pl = tuple(tuple(t.placements) for t in args)
    grad_pl = tuple(shd.per_shard_grads(t, differs) for t in args)

    def local(*a):
        out = _core(*a, rank=rank, size=size, **dims)
        return out if cache is not None else out[0]
    res = local_map(local, out_placements=tuple(out_pl), in_placements=in_pl,
                    in_grad_placements=grad_pl,
                    device_mesh=xin.device_mesh)(*args)
    y = rms_norm(res if cache is None else res[0], p["norm"])
    if split:
        # row-parallel: each shard's partial product in float32, so their
        # sum rounds to the compute dtype once, as one device's product
        out = y.float() @ p["out_proj"].to(cd).float()
    else:
        out = y @ p["out_proj"].to(cd)
    if cache is None:
        return out, None
    win_x = res[1].redistribute(xin.device_mesh, rows)
    new = _new_cache(cache, win_x, res[2], res[3])
    return out, {k: v.redistribute(v.device_mesh, cache[k].placements)
                 for k, v in new.items()}


def _new_cache(cache, win_x, win_bc, ssm):
    if cache is None:
        return None
    return {"conv": torch.cat([win_x, win_bc], dim=-1).to(
        cache["conv"].dtype), "ssm": ssm}


def _core(zx, conv_w, conv_b, a_log, dt_bias, d_skip, conv_cache=None,
          ssm_cache=None, *, rank: int, size: int, d_inner: int,
          n_heads: int, headdim: int, n_groups: int, d_state: int,
          chunk: int, cd):
    """The block from ``in_proj``'s output to the input of the norm, on the
    heads of model shard ``rank`` of ``size``: ``zx`` holds their ``z``,
    ``x`` and ``dt`` and ``B`` and ``C`` whole (``sharding.packed_ranges``);
    the conv weights and the per-head vectors are whole, and each shard
    takes its channels and heads; the caches hold the whole conv window
    and this shard's heads' SSM state. Returns (y·silu(z) (B, S, its
    d_inner columns), the new window's ``x`` channels and its ``B`` and
    ``C`` channels, the final state)."""
    b, s = zx.shape[:2]
    h_l, di_l = n_heads // size, d_inner // size
    gn = n_groups * d_state
    z = zx[..., :di_l]
    xbc = zx[..., di_l:2 * di_l + 2 * gn]
    dt = zx[..., 2 * di_l + 2 * gn:]
    chans = shd.packed_ranges((d_inner, gn, gn), (n_heads, None, None),
                              rank, size)
    heads = slice(rank * h_l, (rank + 1) * h_l)

    # causal depthwise conv over (x, B, C)
    if conv_cache is None:
        pad = xbc.new_zeros((b, D_CONV - 1, xbc.shape[-1]))
        win = torch.cat([pad, xbc], dim=1)
    else:
        win = torch.cat([shd.pick_columns(conv_cache, chans).to(xbc.dtype),
                         xbc], dim=1)
    new_win = win[:, -(D_CONV - 1):]
    w = shd.pick_columns(conv_w, chans).to(xbc.dtype)
    conv = torch.zeros_like(xbc)
    for i in range(D_CONV):
        conv = conv + win[:, i:i + s] * w[i]
    xbc = F.silu((conv + shd.pick_columns(conv_b, chans).to(xbc.dtype))
                 .float()).to(cd)

    x = xbc[..., :di_l].reshape(b, s, h_l, headdim)
    B = xbc[..., di_l:di_l + gn].reshape(b, s, n_groups, d_state)
    C = xbc[..., di_l + gn:].reshape(b, s, n_groups, d_state)
    # broadcast groups over heads, then this shard's heads
    rep = n_heads // n_groups
    Bh = torch.repeat_interleave(B, rep, dim=2)[:, :, heads]
    Ch = torch.repeat_interleave(C, rep, dim=2)[:, :, heads]

    dt = F.softplus(dt.float() + dt_bias[heads])                 # (B,S,H)
    a = -torch.exp(a_log[heads])[None, None, :] * dt             # <= 0

    if ssm_cache is None:
        y, hfin = chunked_gated_recurrence(Ch, Bh, x, a, dt, chunk=chunk)
    elif s == 1:
        y1, hfin = gated_recurrence_step(
            ssm_cache, Ch[:, 0], Bh[:, 0], x[:, 0], a[:, 0], dt[:, 0])
        y = y1[:, None]
    else:  # prefill: chunked recurrence seeded from the cached state
        y, hfin = chunked_gated_recurrence(Ch, Bh, x, a, dt, chunk=chunk,
                                           h0=ssm_cache)
    y = y.to(cd) + x * d_skip[heads].to(cd)[None, None, :, None]
    y = y.reshape(b, s, di_l) * F.silu(z.float()).to(cd)
    return y, new_win[..., :di_l], new_win[..., di_l:], hfin


def init_mamba2_cache(batch: int, d_model: int, *, expand: int = 2,
                      headdim: int = 64, d_state: int = 64,
                      n_groups: int = 1, dtype=torch.bfloat16,
                      device=None) -> dict:
    """The conv window in ``dtype`` and the float32 SSM state, zeroed, on
    ``device`` (CUDA unless the caller names one)."""
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    conv_dim = d_inner + 2 * n_groups * d_state
    dev = co.resolve_device(device)
    return {
        "conv": torch.zeros((batch, D_CONV - 1, conv_dim), dtype=dtype,
                            device=dev),
        "ssm": torch.zeros((batch, n_heads, d_state, headdim),
                           dtype=torch.float32, device=dev),
    }
