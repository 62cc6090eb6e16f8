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
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import coord_ops as co
from .common import dense_init, device_of, init_rms, normal, rms_norm
from .ssm_common import chunked_gated_recurrence, gated_recurrence_step

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


def _split(zxbcdt, d_inner, gn):
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + d_inner + 2 * gn]
    dt = zxbcdt[..., d_inner + d_inner + 2 * gn:]
    return z, xbc, dt


def mamba2(p: dict, xin: torch.Tensor, *, expand: int = 2, headdim: int = 64,
           d_state: int = 64, n_groups: int = 1, chunk: int = 64,
           compute_dtype=torch.bfloat16, cache: Optional[dict] = None
           ) -> Tuple[torch.Tensor, Optional[dict]]:
    b, s, d_model = xin.shape
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    gn = n_groups * d_state
    cd = compute_dtype
    xin = xin.to(cd)

    zxbcdt = xin @ p["in_proj"].to(cd)
    z, xbc, dt = _split(zxbcdt, d_inner, gn)

    # causal depthwise conv over (x, B, C)
    if cache is None:
        pad = xbc.new_zeros((b, D_CONV - 1, xbc.shape[-1]))
        win = torch.cat([pad, xbc], dim=1)
    else:
        win = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)
    new_conv = win[:, -(D_CONV - 1):]
    conv = torch.zeros_like(xbc)
    for i in range(D_CONV):
        conv = conv + win[:, i:i + s] * p["conv_w"][i].to(xbc.dtype)
    xbc = F.silu((conv + p["conv_b"].to(xbc.dtype)).float()).to(cd)

    x = xbc[..., :d_inner].reshape(b, s, n_heads, headdim)
    B = xbc[..., d_inner:d_inner + gn].reshape(b, s, n_groups, d_state)
    C = xbc[..., d_inner + gn:].reshape(b, s, n_groups, d_state)
    # broadcast groups over heads
    rep = n_heads // n_groups
    Bh = torch.repeat_interleave(B, rep, dim=2)
    Ch = torch.repeat_interleave(C, rep, dim=2)

    dt = F.softplus(dt.float() + p["dt_bias"])                   # (B,S,H)
    a = -torch.exp(p["A_log"])[None, None, :] * dt               # <= 0

    if cache is None:
        y, hfin = chunked_gated_recurrence(Ch, Bh, x, a, dt, chunk=chunk)
        new_cache = None
    elif s == 1:
        y1, hfin = gated_recurrence_step(
            cache["ssm"], Ch[:, 0], Bh[:, 0], x[:, 0], a[:, 0], dt[:, 0])
        y = y1[:, None]
        new_cache = {"conv": new_conv.to(cache["conv"].dtype), "ssm": hfin}
    else:  # prefill: chunked recurrence seeded from the cached state
        y, hfin = chunked_gated_recurrence(Ch, Bh, x, a, dt, chunk=chunk,
                                           h0=cache["ssm"])
        new_cache = {"conv": new_conv.to(cache["conv"].dtype), "ssm": hfin}
    y = y.to(cd) + x * p["D_skip"].to(cd)[None, None, :, None]
    y = y.reshape(b, s, d_inner)
    y = rms_norm(y * F.silu(z.float()).to(cd), p["norm"])
    out = y @ p["out_proj"].to(cd)
    return out, new_cache


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
