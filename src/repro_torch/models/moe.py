"""Mixture-of-Experts with SAM-lowered sparse dispatch, on one device.

Routing is the sparse tensor algebra expression

    Y[e, c, d] = sum_t  G[e, c, t] * X[t, d]

with ``G`` the top-k one-hot routing tensor. Two dispatch algorithms are
implemented, mirroring the paper's dataflow-order study (§6.3):

* ``dense``  — the inner-product-style baseline: one-hot einsum over the
               full (E x T) iteration space, O(E*T*D).
* ``sam``    — the Gustavson-ordered SAM lowering: iterate the *nonzero*
               routing coordinates only. Sort (token, choice) pairs by
               expert (the level-scanner's concordant e->t fiber order),
               crop to capacity (finite-memory tiling, §4.1), gather ->
               expert batches, and combine with a keyed scatter-add (the
               Def 3.7 reducer). O(k*T*D).

A port of ``repro.models.moe``. Under an activation policy
(``distributed.sharding.set_activation_policy``) the SAM dispatch is
grouped as the reference's is: the T tokens split into ``g =
data_group_size()`` groups (when g divides T), each sorted by expert and
cropped to its own capacity ``max(8, int(cf * (T/g) * k / E))``, so the
sort stays local to a data shard. On DTensors (parameters placed over a
process group's mesh) the build and the combine run per data shard
through ``local_map``, and the expert FFN runs with the dispatch buffers
redistributed onto the expert-parallel placements (``Shard`` on the E
axis over ``_ep_axes``), the token-to-expert all-to-all; on plain
tensors the groups run one after another. Without a policy there is one
group, computed exactly as before. The expert products are
``torch.einsum`` in the compute dtype, plain products the reference
computes outside any Pallas kernel too.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

from ..distributed import sharding as shd
from .common import apply_mlp, dense_init, init_mlp

__all__ = ["init_moe", "route_topk", "moe_dense_dispatch",
           "moe_sam_dispatch", "apply_moe"]


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             n_shared: int = 0, shared_d_ff: Optional[int] = None,
             dtype=torch.float32) -> dict:
    """Router, experts stacked on a leading E axis, and ``n_shared``
    shared experts as one MLP of width ``shared_d_ff`` (``d_ff *
    n_shared`` by default), drawn from ``gen`` on its device."""
    p = {
        "router": dense_init(gen, d_model, n_experts, dtype, scale=0.02),
        "w_gate": dense_init(gen, d_model, n_experts * d_ff, dtype)
        .reshape(d_model, n_experts, d_ff).permute(1, 0, 2).contiguous(),
        "w_up": dense_init(gen, d_model, n_experts * d_ff, dtype)
        .reshape(d_model, n_experts, d_ff).permute(1, 0, 2).contiguous(),
        "w_down": dense_init(gen, d_ff, n_experts * d_model, dtype)
        .reshape(d_ff, n_experts, d_model).permute(1, 0, 2).contiguous(),
    }
    if n_shared:
        p["shared"] = init_mlp(gen, d_model, shared_d_ff or d_ff * n_shared,
                               dtype)
    return p


def route_topk(router_w, x, k: int, *, bias: Optional[torch.Tensor] = None):
    """Returns (weights (T,k) fp32 normalized, expert ids (T,k) int32)."""
    logits = x.float() @ router_w.float()
    if bias is not None:
        logits = logits + bias
    if isinstance(logits, DTensor):     # the top-k a token, on its shard
        pl = tuple(logits.placements)
        return local_map(functools.partial(_top_k, k=k),
                         out_placements=(pl, pl), in_placements=(pl,),
                         device_mesh=logits.device_mesh)(logits)
    return _top_k(logits, k=k)


def _top_k(logits, *, k: int):
    gates = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(gates, k, dim=-1)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return w, ids.int()


def _shard(x, *spec):
    """Expert-parallel sharding constraints: a DTensor redistributed to
    ``spec`` with "data" the policy's batch axes and "model" its model
    axis, fitted to the shape; the identity on a plain tensor or without
    a policy."""
    pol = shd._ACT_POLICY
    if pol is None:
        return x
    resolved = tuple(pol["batch"] if s == "data" else
                     (pol["model"] if s == "model" else None) for s in spec)
    return shd.redistribute_to(x, resolved)


def _expert_ffn(p, xe, compute_dtype):
    """xe: (..., E, C, D) -> (..., E, C, D); batched per-expert SwiGLU."""
    xe = xe.to(compute_dtype)
    g = torch.einsum("...ecd,edf->...ecf", xe,
                     p["w_gate"].to(compute_dtype))
    u = torch.einsum("...ecd,edf->...ecf", xe, p["w_up"].to(compute_dtype))
    h = F.silu(g.float()).to(compute_dtype) * u
    return torch.einsum("...ecf,efd->...ecd", h,
                        p["w_down"].to(compute_dtype))


def moe_dense_dispatch(p: dict, x: torch.Tensor, *, k: int,
                       compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Baseline: every expert runs every token, combined through the dense
    one-hot gate tensor — the full E x T iteration space, O(E*T*D)."""
    t, d = x.shape
    e = p["router"].shape[1]
    w, ids = route_topk(p["router"], x, k)
    onehot = F.one_hot(ids.long(), e).float()                  # (T, k, E)
    g = torch.einsum("tke,tk->et", onehot, w)                  # (E, T)
    xe = x.to(compute_dtype).expand(e, t, d)                   # all pairs
    ye = _expert_ffn(p, xe, compute_dtype)                     # (E, T, D)
    return torch.einsum("et,etd->td", g.to(compute_dtype), ye)


def _sam_build(e, x, w, ids, *, k: int, cap: int, compute_dtype):
    """The dispatch build: sort by expert, crop to capacity.

    x: (T, D); w/ids: (T, k). Returns (xe (E, cap, D), keep, slot,
    sorted weights, sorted token ids)."""
    t, d = x.shape
    flat_e = ids.reshape(-1).long()                            # (T*k,)
    flat_t = torch.arange(t, device=x.device).repeat_interleave(k)
    flat_w = w.reshape(-1)

    # level-scanner order: sort coordinates by expert fiber (stable in t;
    # the keys are distinct, since a token's k experts are)
    order = torch.argsort(flat_e * t + flat_t)
    se, stk, sw = flat_e[order], flat_t[order], flat_w[order]
    # position within each expert fiber -> capacity crop
    pos_in_e = (torch.arange(t * k, device=x.device)
                - torch.searchsorted(se, se, side="left"))
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e,
                       torch.full_like(se, e * cap))           # drop -> pad

    # one pad row past the E*cap slots takes every dropped pair
    xe = torch.zeros((e * cap + 1, d), dtype=compute_dtype, device=x.device)
    xe.index_copy_(0, slot, x[stk].to(compute_dtype))
    return xe[:-1].reshape(e, cap, d), keep, slot, sw, stk


def _sam_combine(e, cap, t, ye, keep, slot, sw, stk, compute_dtype):
    """Weighted gather back to tokens (the Def-3.7 reducer: sum over k)."""
    yflat = ye.reshape(e * cap, -1)
    picked = yflat[torch.clamp(slot, 0, e * cap - 1)]
    contrib = (torch.where(keep[:, None], picked, torch.zeros_like(picked))
               * sw[:, None].to(compute_dtype))
    out = torch.zeros((t, contrib.shape[1]), dtype=contrib.dtype,
                      device=contrib.device)
    return out.index_add_(0, stk, contrib)


def _ep_axes(e: int):
    """Expert-parallel mesh axes: (model, data...) when E divides both."""
    if shd._ACT_POLICY is None:
        return None
    pol = shd._ACT_POLICY
    shape = dict(pol["mesh"].shape)
    axes = [pol["model"]] if pol["model"] else []
    n = shape.get(pol["model"], 1)
    for a in pol["batch"] or ():
        if e % (n * shape.get(a, 1)) == 0:
            axes.append(a)
            n *= shape.get(a, 1)
    return tuple(axes) if axes else None


def _stacked(outs):
    """Per-group tuples of tensors as one tuple of stacked tensors."""
    return tuple(torch.stack(parts) for parts in zip(*outs))


def _per_group(fn, n_out: int, *args):
    """``fn`` over the groups (the leading axis) of ``args``, returning a
    tuple of ``n_out`` tensors with the same leading axis: on DTensors
    through ``local_map`` over the data shards (the placements of the first
    argument, which every argument shares), each process running its own
    groups (all of them where the groups are not sharded); on plain
    tensors over all of them."""
    if not isinstance(args[0], DTensor):
        return fn(*args)
    pl = tuple(args[0].placements)
    return local_map(fn, out_placements=(pl,) * n_out,
                     in_placements=(pl,) * len(args),
                     device_mesh=args[0].device_mesh)(*args)


def moe_sam_dispatch(p: dict, x: torch.Tensor, *, k: int,
                     capacity_factor: float = 1.25,
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
    """SAM lowering: sort-by-expert concordant traversal, O(k*T*D).

    The (expert, token) routing fibers are materialized by sorting the
    nonzero coordinates (level-scanner order), cropped to per-expert
    capacity (the §4.1 finite-memory tile; a pair past an expert's
    capacity is dropped), processed as dense per-expert batches, and
    combined by the Def-3.7 reducer (weighted scatter-add).

    Distribution: under a policy the token axis is grouped by data shard
    and the build and the combine run per group, so the expert-order sort
    runs locally per shard; capacity is per (group, expert). The expert
    FFN runs on the expert-parallel placements (module docstring)."""
    t, d = x.shape
    e = p["router"].shape[1]
    g = shd.data_group_size() if shd._ACT_POLICY is not None else 1
    g = g if t % g == 0 else 1
    tl = t // g
    cap = max(8, int(capacity_factor * tl * k / e))
    w, ids = route_topk(p["router"], x, k)                     # (T, k)
    if g == 1 and not isinstance(x, DTensor):
        xe, keep, slot, sw, stk = _sam_build(e, x, w, ids, k=k, cap=cap,
                                             compute_dtype=compute_dtype)
        ye = _expert_ffn(p, xe, compute_dtype)
        return _sam_combine(e, cap, t, ye, keep, slot, sw, stk,
                            compute_dtype)

    xs = _shard(x.reshape(g, tl, d), "data", None, None)
    ws = _shard(w.reshape(g, tl, k), "data", None, None)
    idss = _shard(ids.reshape(g, tl, k), "data", None, None)

    def build(xx, ww, ii):
        return _stacked([_sam_build(e, xx[j], ww[j], ii[j], k=k, cap=cap,
                                    compute_dtype=compute_dtype)
                         for j in range(xx.shape[0])])
    xe, keep, slot, sw, stk = _per_group(build, 5, xs, ws, idss)

    # token->expert all-to-all: the dispatch buffers move from
    # group(data)-major onto the expert-parallel axes, the expert FFN runs
    # there, and its output moves back for the combine
    ep = _ep_axes(e)
    if ep is not None:
        xe = shd.redistribute_to(xe, (None, ep, None, None))
    ye = _expert_ffn(p, xe, compute_dtype)
    if ep is not None:
        ye = shd.redistribute_to(ye, (None, ep, None, None))
    ye = _shard(ye, "data", None, None, None)

    def combine(yy, kk, ss, ww, tt):
        return (torch.stack([_sam_combine(e, cap, tl, yy[j], kk[j], ss[j],
                                          ww[j], tt[j], compute_dtype)
                             for j in range(yy.shape[0])]),)
    out, = _per_group(combine, 1, ye, keep, slot, sw, stk)
    return _shard(out, "data", None, None).reshape(t, d)


def apply_moe(p: dict, x: torch.Tensor, *, k: int, dispatch: str = "sam",
              capacity_factor: float = 1.25,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D); adds shared experts if present."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    if dispatch == "sam":
        y = moe_sam_dispatch(p, xf, k=k, capacity_factor=capacity_factor,
                             compute_dtype=compute_dtype)
    else:
        y = moe_dense_dispatch(p, xf, k=k, compute_dtype=compute_dtype)
    y = y.reshape(b, s, d)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x, compute_dtype=compute_dtype)
    return y
