"""Shared model components of the PyTorch port: norms, rotary embeddings,
the gated MLP, embeddings, and the carrier of the reference's parameters.

A port of ``repro.models.common``. Pure-functional style: ``init_*`` builds
parameter trees (dicts of tensors), the apply functions are stateless.
Parameters are drawn in ``param_dtype`` (float32 by default) and computed
in ``compute_dtype`` (bfloat16 by default), the reference's
mixed-precision policy. Random draws come from an explicit
``torch.Generator`` on the parameters' device, so they differ from the
reference's ``jax.random`` draws; ``params_from_numpy`` carries the
reference's own parameters across where the two must agree. An init
function given ``gen=None`` builds meta tensors: the shapes and dtypes
of its tree and no data (``model.init_params`` uses that for a stack of
zero layers).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import coord_ops as co

__all__ = ["device_of", "normal", "rms_norm", "init_rms", "dense_init",
           "rope_angles", "apply_rope", "init_mlp", "apply_mlp",
           "init_embedding", "cross_entropy", "params_from_numpy"]


def device_of(gen: Optional[torch.Generator]) -> torch.device:
    """The device an init function builds on: ``gen``'s, or meta for
    ``gen=None``."""
    return torch.device("meta") if gen is None else gen.device


def normal(gen: Optional[torch.Generator], shape) -> torch.Tensor:
    """Standard normal float32 draws from ``gen`` on its device."""
    return torch.randn(tuple(shape), generator=gen, device=device_of(gen),
                       dtype=torch.float32)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             add_unit_offset: bool = False) -> torch.Tensor:
    """RMS norm over the last axis in float32, returned in ``x``'s dtype;
    ``add_unit_offset`` scales by ``1 + scale`` (the Gemma convention)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = scale.float()
    if add_unit_offset:
        w = 1.0 + w
    return (x * w).to(dt)


def init_rms(d: int, dtype, device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def dense_init(gen: Optional[torch.Generator], d_in: int, d_out: int, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """(d_in, d_out) standard normal times ``scale`` (1/sqrt(d_in) by
    default), drawn in float32 on ``gen``'s device, cast to ``dtype``."""
    scale = scale if scale is not None else (1.0 / d_in) ** 0.5
    return (normal(gen, (d_in, d_out)) * scale).to(dtype)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0):
    """positions (..., S) -> cos/sin of shape (..., S, head_dim // 2), in
    float32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., S, H, hd); cos/sin: (..., S, half). Rotates the two halves
    of each head (not interleaved pairs), in float32."""
    dt = x.dtype
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(dt)


# -- gated MLPs ---------------------------------------------------------------

def init_mlp(gen: Optional[torch.Generator], d_model: int, d_ff: int,
             dtype) -> dict:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype),
        "w_up": dense_init(gen, d_model, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d_model, dtype),
    }


def apply_mlp(p: dict, x: torch.Tensor, activation: str = "silu",
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Gated MLP: ``(act(x Wg) * (x Wu)) Wd``, the activation taken in
    float32 (SiLU, or tanh-approximated GELU for ``"gelu"``)."""
    x = x.to(compute_dtype)
    g = x @ p["w_gate"].to(compute_dtype)
    u = x @ p["w_up"].to(compute_dtype)
    if activation == "silu":
        act = F.silu(g.float())
    else:
        act = F.gelu(g.float(), approximate="tanh")
    return (act.to(compute_dtype) * u) @ p["w_down"].to(compute_dtype)


def init_embedding(gen: Optional[torch.Generator], vocab: int, d_model: int,
                   dtype) -> torch.Tensor:
    return (normal(gen, (vocab, d_model)) * 0.02).to(dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy in float32; with ``mask``, the mean over
    the masked tokens (``sum(mask)`` at least 1)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def params_from_numpy(p, device=None, dtype=None):
    """A tree of nested dicts and lists of arrays (the reference's
    parameters or caches, through ``np.asarray``) as the same tree of
    torch tensors on ``device`` (CUDA unless the caller names one; an
    error without a GPU). ``dtype`` casts the floating arrays; None keeps
    each array's own."""
    dev = co.resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        t = torch.tensor(np.asarray(v), device=dev)
        return t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t

    return conv(p)
