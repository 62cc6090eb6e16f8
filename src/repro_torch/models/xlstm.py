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
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import coord_ops as co
from .common import dense_init, device_of, init_rms, normal, rms_norm
from .ssm_common import chunked_gated_recurrence, gated_recurrence_step

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
    b, s, _ = xin.shape
    cd = compute_dtype
    xin = xin.to(cd)
    up = xin @ p["w_up"].to(cd)
    d_inner = up.shape[-1] // 2
    xi, gate = up[..., :d_inner], up[..., d_inner:]
    hd = d_inner // n_heads

    q = (xi @ p["wq"].to(cd)).reshape(b, s, n_heads, hd)
    k = (xi @ p["wk"].to(cd)).reshape(b, s, n_heads, hd) / (hd ** 0.5)
    v = (xi @ p["wv"].to(cd)).reshape(b, s, n_heads, hd)
    if_ = (xi @ p["w_if"].to(cd)).float()
    i_log = torch.clamp(if_[..., :n_heads], -GATE_CLIP, GATE_CLIP)
    f_gate = F.logsigmoid(if_[..., n_heads:])            # log decay <= 0
    beta = torch.exp(i_log)

    if cache is None:
        y, hfin = chunked_gated_recurrence(q, k, v, f_gate, beta, chunk=chunk)
        new_cache = None
    elif s == 1:
        y1, hfin = gated_recurrence_step(
            cache["mlstm"], q[:, 0], k[:, 0], v[:, 0], f_gate[:, 0],
            beta[:, 0])
        y = y1[:, None]
        new_cache = {"mlstm": hfin}
    else:  # prefill: chunked recurrence seeded from the cached state
        y, hfin = chunked_gated_recurrence(q, k, v, f_gate, beta,
                                           chunk=chunk, h0=cache["mlstm"])
        new_cache = {"mlstm": hfin}
    y = y.to(cd).reshape(b, s, d_inner)
    y = rms_norm(y, p["norm"])
    y = y * F.silu(gate.float()).to(cd)
    return y @ p["w_down"].to(cd), new_cache


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
    b, s, d = xin.shape
    hd = d // n_heads
    cd = compute_dtype
    xin = xin.to(cd)
    gates_in = (xin @ p["w_in"].to(cd)).reshape(b, s, n_heads, 4 * hd).float()
    r = p["r"].float()

    if cache is None:
        state = init_slstm_cache(b, d, n_heads, device=xin.device)
    else:
        state = cache
    h, c, n, m = state["h"], state["c"], state["n"], state["m"]

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
    new_cache = None
    if cache is not None:
        new_cache = {"h": h, "c": c, "n": n, "m": m}
    y = rms_norm(y, p["norm"])
    return y @ p["w_down"].to(cd), new_cache


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
