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
sort stays local to a data shard; on plain tensors the groups run one
after another. Without a policy there is one group, computed exactly as
before.

On DTensors (parameters placed over a process group's mesh) the experts
stay where the sharding rules put them: each expert stack keeps its
``Shard`` on the E axis (``sharding.expert_axes``: the model axis, and
the data axes where E divides them), and the tokens move to the experts,
never the experts to the tokens. The router is made whole over the model
axis (every expert's logit is needed for a token's top-k, and the
router, d_model x E, is smaller than the logits it gives). One
``local_map`` then runs the dispatch on each card: the build of its data
shard's groups, for the experts it dispatches to; over each data axis
that also splits the experts, an all-to-all of the buffers to the cards
that hold their experts (and of the results back); the expert FFN on the
card's own experts; the combine. Over the model axis, which splits the
experts but not the tokens, each card dispatches only to its own experts
and its combine is a float32 partial sum (``Partial``), which
``apply_moe`` adds to the shared experts' partial sum (``apply_mlp``
column- and row-parallel) before the layer's one all-reduce. The layout
follows the expert leaves' placements (``_ep_layout``), so the buffers
and the weights always agree. The dense dispatch, the baseline, gathers
its placed experts whole. The expert products are ``torch.einsum`` in
the compute dtype, plain products the reference computes outside any
Pallas kernel too.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate
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
    p = shd.gathered(p)              # placed: every expert whole
    w, ids = route_topk(p["router"], x, k)
    onehot = F.one_hot(ids.long(), e).float()                  # (T, k, E)
    g = torch.einsum("tke,tk->et", onehot, w)                  # (E, T)
    xe = x.to(compute_dtype).expand(e, t, d)                   # all pairs
    ye = _expert_ffn(p, xe, compute_dtype)                     # (E, T, D)
    return torch.einsum("et,etd->td", g.to(compute_dtype), ye)


def _sam_build(e, x, w, ids, *, k: int, cap: int, compute_dtype,
               expert_map=None):
    """The dispatch build: sort by expert, crop to capacity.

    x: (T, D); w/ids: (T, k). Returns (xe (E, cap, D), keep, slot,
    sorted weights, sorted token ids). With ``expert_map`` (a map from
    each expert to its index among n of them, -1 for the others; n), the
    buffer holds those n experts' slots only, and the pairs of the others
    are dropped as pairs past capacity are."""
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
    if expert_map is not None:
        emap, e = expert_map
        se = emap[se]
        keep = keep & (se >= 0)
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


def _ep_layout(w_pl, g_pl, sizes):
    """The expert-parallel layout of the placed dispatch, from the
    placements of an expert stack ``w_pl`` (``Shard(0)`` on each mesh axis
    that splits E, as the sharding rules placed it) and of the grouped
    tokens ``g_pl`` (``Shard(0)`` on each axis that splits the groups),
    ``sizes`` the mesh axes' sizes: (split, exchange, local), lists of mesh
    axis indices in mesh order. ``split`` splits the experts; of them,
    ``exchange`` also splits the groups (an all-to-all over each moves a
    card's tokens to the cards that hold their experts, and back) and
    ``local`` does not (each card dispatches its tokens to its own experts
    only, and the combine is a partial sum over the axis)."""
    split = [i for i, p in enumerate(w_pl) if p.is_shard() and sizes[i] > 1]
    groups = {i for i, p in enumerate(g_pl) if p.is_shard() and sizes[i] > 1}
    return (split, [i for i in split if i in groups],
            [i for i in split if i not in groups])


def _expert_map(e, sizes, coords, split, local, device):
    """(a map from each of the ``e`` experts to its index among the experts
    this card dispatches to, -1 for the others; that count). Experts lie
    on the cards as DTensor lays a dim split over several mesh axes: in
    blocks of ``e / prod(sizes[split])``, the block index mixed radix over
    ``split`` in mesh order, the first axis outermost. A card dispatches
    to the experts whose digits on the ``local`` axes are its coordinates
    there, indexed by their digits on the other axes of ``split`` (the
    exchange axes, the first outermost), then by their place in the
    block."""
    blk = e // int(np.prod([sizes[i] for i in split]))
    ids = torch.arange(e, device=device)
    block, idx = ids // blk, ids % blk
    mine = torch.ones(e, dtype=torch.bool, device=device)
    mult = blk
    for i in reversed(split):
        digit = block % sizes[i]
        block = block // sizes[i]
        if i in local:
            mine &= digit == coords[i]
        else:
            idx = idx + digit * mult
            mult *= sizes[i]
    return torch.where(mine, idx, torch.full_like(idx, -1)), mult


class _AllToAll(torch.autograd.Function):
    """The all-to-all of a local tensor over one process group, chunk ``i``
    of its leading dim to the group's rank ``i``; its backward is the same
    exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group_name):
        ctx.group_name = group_name
        return _all_to_all(x, group_name)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group_name), None


def _all_to_all(x, group_name):
    ops = torch.ops._c10d_functional
    n = x.shape[0]
    return ops.wait_tensor(ops.all_to_all_single(
        x.contiguous(), [1] * n, [1] * n, group_name))


def _placed_dispatch(p, xs, ws, idss, *, e, k, cap, compute_dtype):
    """The grouped dispatch on DTensors: the tokens ``xs`` (g, T/g, D),
    their gates ``ws`` and experts ``idss`` (g, T/g, k), split into groups
    over the data axes, and the expert stacks as the sharding rules placed
    them (no gather). One ``local_map``: each card builds the buffers of
    its groups for the experts it dispatches to (``_ep_layout``), sends
    them over each exchange axis to the cards that hold those experts
    (``_AllToAll``), runs the expert FFN on its own experts, sends the
    results back and combines them, in float32 where the combine is a
    partial sum over the local axes (the result ``Partial`` there, for the
    caller to reduce once with the shared experts'). The expert gradients
    stay on their shards; where a stack is replicated over a group axis,
    its gradient is a partial sum there, reduced as DTensor reduces any
    replicated leaf's."""
    w = p["w_gate"]
    dm = w.device_mesh
    sizes = [dm.size(i) for i in range(dm.ndim)]
    coords = dm.get_coordinate()
    split, exchange, local = _ep_layout(w.placements, xs.placements, sizes)
    groups = [dm.get_group(i).group_name for i in range(dm.ndim)]
    partial = bool(local)

    def grad_pl(t, *, weight=False):
        out = []
        for i, pl in enumerate(t.placements):
            if weight and pl.is_replicate() and xs.placements[i].is_shard():
                pl = Partial()             # other tokens on each card
            elif not weight and i in local:
                pl = Partial()             # its own experts' pairs only
            out.append(pl)
        return tuple(out)
    out_pl = tuple(Partial() if i in local else pl
                   for i, pl in enumerate(xs.placements))

    def run(x, gates, ids, w_gate, w_up, w_down):
        emap, n_local = _expert_map(e, sizes, coords, split, local,
                                    x.device)
        built = _stacked([_sam_build(e, x[j], gates[j], ids[j], k=k,
                                     cap=cap, compute_dtype=compute_dtype,
                                     expert_map=(emap, n_local))
                          for j in range(x.shape[0])])
        xe, keep, slot, sw, stk = built
        gl, blk = xe.shape[0], w_gate.shape[0]
        buf = xe.reshape(gl, *(sizes[i] for i in exchange), blk, cap, -1)
        for n, i in enumerate(exchange):       # tokens to their experts
            buf = _AllToAll.apply(buf.movedim(n + 1, 0), groups[i])
        lead = buf.shape[:-3]
        ye = _expert_ffn({"w_gate": w_gate, "w_up": w_up, "w_down": w_down},
                         buf.reshape(-1, blk, cap, buf.shape[-1]),
                         compute_dtype).reshape(*lead, blk, cap, -1)
        for n, i in reversed(list(enumerate(exchange))):   # and back
            ye = _AllToAll.apply(ye, groups[i]).movedim(0, n + 1)
        ye = ye.reshape(gl, n_local, cap, -1)
        acc = torch.float32 if partial else compute_dtype
        return torch.stack([_sam_combine(
            n_local, cap, x.shape[1], ye[j].to(acc), keep[j], slot[j],
            sw[j], stk[j], acc) for j in range(gl)])

    ins = (xs, ws, idss, p["w_gate"], p["w_up"], p["w_down"])
    return local_map(
        run, out_placements=(out_pl,),
        in_placements=tuple(tuple(t.placements) for t in ins),
        in_grad_placements=(grad_pl(xs), grad_pl(ws), tuple(idss.placements))
        + tuple(grad_pl(t, weight=True) for t in ins[3:]),
        device_mesh=dm)(*ins)


def _stacked(outs):
    """Per-group tuples of tensors as one tuple of stacked tensors."""
    return tuple(torch.stack(parts) for parts in zip(*outs))


def _tokens_on_groups(x):
    """A DTensor ``x`` (g, T/g, ...) made whole on each mesh axis that
    splits it on another dim than its groups'; a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    pl = [Replicate() if pl.is_shard() and pl.dim != 0 else pl
          for pl in x.placements]
    return x if tuple(pl) == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


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
    runs locally per shard; capacity is per (group, expert). On DTensors
    the tokens move to the experts' cards (module docstring); the result
    is then a float32 ``Partial`` over the model axis where the experts are
    split over it."""
    t, d = x.shape
    e = p["router"].shape[1]
    g = shd.data_group_size() if shd._ACT_POLICY is not None else 1
    g = g if t % g == 0 else 1
    tl = t // g
    cap = max(8, int(capacity_factor * tl * k / e))
    # every expert's logit for the top-k: the router whole over the model
    # axis (d_model x E, smaller than the logits it gives)
    w, ids = route_topk(shd.whole_over_model(p["router"]), x, k)  # (T, k)
    if isinstance(x, DTensor):
        # the groups over the policy's data axes
        spec = (shd._ACT_POLICY["batch"] if g > 1 else None, None, None)
        xs, ws, idss = (_tokens_on_groups(shd.redistribute_to(
            a.reshape(g, tl, -1), spec)) for a in (x, w, ids))
        out = _placed_dispatch(p, xs, ws, idss, e=e, k=k, cap=cap,
                               compute_dtype=compute_dtype)
        return out.reshape(t, d)
    if g == 1:
        xe, keep, slot, sw, stk = _sam_build(e, x, w, ids, k=k, cap=cap,
                                             compute_dtype=compute_dtype)
        ye = _expert_ffn(p, xe, compute_dtype)
        return _sam_combine(e, cap, t, ye, keep, slot, sw, stk,
                            compute_dtype)
    # the groups one after another, as the mesh's data shards run them
    xs, ws, idss = (a.reshape(g, tl, -1) for a in (x, w, ids))
    xe, keep, slot, sw, stk = _stacked([
        _sam_build(e, xs[j], ws[j], idss[j], k=k, cap=cap,
                   compute_dtype=compute_dtype) for j in range(g)])
    ye = _expert_ffn(p, xe, compute_dtype)
    return torch.stack([_sam_combine(e, cap, tl, ye[j], keep[j], slot[j],
                                     sw[j], stk[j], compute_dtype)
                        for j in range(g)]).reshape(t, d)


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
        shared = apply_mlp(p["shared"], x, compute_dtype=compute_dtype)
        if _partial_axes(y) != _partial_axes(shared):
            # partial sums over different axes (or one partial, one whole
            # result): each reduced first
            y, shared = shd.reduced(y), shd.reduced(shared)
        y = y + shared
    return y


def _partial_axes(t) -> tuple:
    """The mesh axes over which DTensor ``t`` is a partial sum."""
    if not isinstance(t, DTensor):
        return ()
    return tuple(i for i, p in enumerate(t.placements) if p.is_partial())
