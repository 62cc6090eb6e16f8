"""Chunk-parallel gated outer-product recurrence.

Both Mamba2's SSD and xLSTM's mLSTM share the recurrence

    H_t = exp(a_t) * H_{t-1} + beta_t * k_t v_t^T        (state per head)
    y_t = q_t @ H_t

(Mamba2: q=C, k=B, a=A*dt, beta=dt; mLSTM: q/k/v with log-sigmoid forget
and input gates.) The chunked evaluation computes the quadratic
intra-chunk term with matrix products and carries the state across
chunks, one chunk after another: the state-space-duality schedule.

A port of ``repro.models.ssm_common``: the reference's ``lax.scan`` over
chunks is a Python loop over chunks; every product is ``torch.einsum``
in float32, as there. Placed, both blocks run the recurrence per shard
on local tensors (``heads_split``, ``per_shard_rows``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import Replicate

from ..distributed import sharding as shd

__all__ = ["chunked_gated_recurrence", "gated_recurrence_step",
           "heads_split", "per_shard_rows"]


def heads_split(x, n_heads: int, projections_split: bool
                ) -> Tuple[int, int]:
    """(this process's model coordinate, the model axis' size) where a
    block of ``n_heads`` heads whose input is DTensor ``x`` runs split on
    whole heads: its projections split over a model axis of more than one
    device (``projections_split``) that divides the heads; else (0, 1),
    every head on every shard."""
    names = x.device_mesh.mesh_dim_names or ()
    if not projections_split or "model" not in names:
        return 0, 1
    rank, size = shd.model_coordinate(x)
    return (rank, size) if size > 1 and n_heads % size == 0 else (0, 1)


def per_shard_rows(x):
    """DTensor ``x`` (B, S, D) at the placements a per-shard recurrence
    reads it at: its batch split as it is, every other dim whole (a
    sequence split would cut the recurrence) and replicated over the
    model axis."""
    names = x.device_mesh.mesh_dim_names or ()
    pl = tuple(p if n != "model" and p.is_shard() and p.dim == 0
               else Replicate() for n, p in zip(names, x.placements))
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def chunked_gated_recurrence(q, k, v, log_decay, beta, *, chunk: int = 64,
                             h0: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q,k: (B,S,H,Dk); v: (B,S,H,Dv); log_decay/beta: (B,S,H).

    Returns (y: (B,S,H,Dv) float32, final state (B,H,Dk,Dv) float32).
    """
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    orig_s = s
    pad = (-s) % chunk
    if pad:
        # pads are state-neutral: decay 0 (exp=1) and beta 0
        def zpad(a):
            return torch.cat(
                [a, a.new_zeros((b, pad) + tuple(a.shape[2:]))], dim=1)
        q, k, v = zpad(q), zpad(k), zpad(v)
        log_decay, beta = zpad(log_decay), zpad(beta)
        s = s + pad
    nc = s // chunk
    qc = q.reshape(b, nc, chunk, h, dk).float()
    kc = k.reshape(b, nc, chunk, h, dk).float()
    vc = v.reshape(b, nc, chunk, h, dv).float()
    ac = log_decay.reshape(b, nc, chunk, h).float()
    bc = beta.reshape(b, nc, chunk, h).float()

    cums = torch.cumsum(ac, dim=2)                      # inclusive
    total = cums[:, :, -1:, :]                          # (B,NC,1,H)

    # intra-chunk quadratic term: scores[t,s] = q_t.k_s e^{cums_t - cums_s} b_s
    decay_ts = cums[:, :, :, None, :] - cums[:, :, None, :, :]  # (B,NC,T,S,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    decay_ts = torch.where(tri[None, None, :, :, None], decay_ts,
                           float("-inf"))
    qk = torch.einsum("bcthd,bcshd->bctsh", qc, kc)
    w = qk * torch.exp(decay_ts) * bc[:, :, None, :, :]
    y_intra = torch.einsum("bctsh,bcshv->bcthv", w, vc)

    # per-chunk state contribution: sum_s e^{total - cums_s} b_s k_s v_s^T
    carry_w = torch.exp(total - cums) * bc              # (B,NC,T,H)
    chunk_state = torch.einsum("bcthd,bcth,bcthv->bchdv", kc, carry_w, vc)
    chunk_decay = torch.exp(total[:, :, 0, :])          # (B,NC,H)

    hstate = (torch.zeros((b, h, dk, dv), dtype=torch.float32,
                          device=q.device) if h0 is None else h0)
    hprevs = []
    for c in range(nc):
        hprevs.append(hstate)
        hstate = (hstate * chunk_decay[:, c, :, None, None]
                  + chunk_state[:, c])
    hprev = torch.stack(hprevs, dim=1)                  # (B,NC,H,Dk,Dv)

    # inter-chunk term: y_t += e^{cums_t} q_t @ H_prev
    y_inter = torch.einsum("bcthd,bchdv->bcthv",
                           qc * torch.exp(cums)[..., None], hprev)
    y = (y_intra + y_inter).reshape(b, s, h, dv)[:, :orig_s]
    return y, hstate


def gated_recurrence_step(h, q, k, v, log_decay, beta):
    """Single-token decode: q,k,v (B,H,D*); log_decay/beta (B,H).

    Returns (y (B,H,Dv), new state), in float32."""
    h = h * torch.exp(log_decay.float())[..., None, None]
    h = h + (beta.float()[..., None, None]
             * k.float()[..., :, None] * v.float()[..., None, :])
    y = torch.einsum("bhd,bhdv->bhv", q.float(), h)
    return y, h
