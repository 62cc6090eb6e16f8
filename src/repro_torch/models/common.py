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
from torch.distributed.tensor import Shard
from torch.distributed.tensor.experimental import local_map

from ..core import coord_ops as co
from ..distributed import sharding as shd

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
    ``add_unit_offset`` scales by ``1 + scale`` (the Gemma convention).
    A DTensor row split over the model axis is normalized per shard
    (``_split_rms_norm``)."""
    if shd.model_sharded(x, x.ndim - 1):
        return _split_rms_norm(x, scale, eps, add_unit_offset)
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = scale.float()
    if add_unit_offset:
        w = 1.0 + w
    return (x * w).to(dt)


def _split_rms_norm(x, scale, eps: float, add_unit_offset: bool):
    """``rms_norm`` of a DTensor ``x`` whose last dim is split over the
    model axis, through ``local_map``: each shard sums the squares of its
    columns, one float32 all-reduce of the (..., 1) sums over the model
    axis gives the whole row's (``sharding.sum_over_model``: the gradient
    all-reduced back), and each shard scales its own columns."""
    mesh, d = x.device_mesh, x.shape[-1]
    scale = scale.redistribute(mesh, shd.over_model(scale, Shard(0)))

    def local(xl, wl):
        dt = xl.dtype
        xf = xl.float()
        ss = shd.sum_over_model(
            torch.sum(torch.square(xf), dim=-1, keepdim=True), mesh)
        xf = xf * torch.rsqrt(ss / d + eps)
        w = wl.float()
        if add_unit_offset:
            w = 1.0 + w
        return (xf * w).to(dt)
    return local_map(
        local, out_placements=(tuple(x.placements),),
        in_placements=(tuple(x.placements), tuple(scale.placements)),
        in_grad_placements=(tuple(x.placements), shd.per_shard_grads(
            scale, shd.split_rows(x, True))), device_mesh=mesh)(x, scale)


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
    float32 (SiLU, or tanh-approximated GELU for ``"gelu"``).

    Placed with ``w_gate`` and ``w_up`` split over the model axis on their
    output dim and ``w_down`` on its input dim, the products are column-
    then row-parallel: the activation and the product run on each shard's
    columns, and the result is a float32 ``Partial`` sum over the model
    axis for the caller to reduce and cast. Where the three are not all
    split, they are made whole over the model axis first."""
    split = (shd.model_sharded(p["w_gate"], 1) and shd.model_sharded(
        p["w_up"], 1) and shd.model_sharded(p["w_down"], 0))
    if not split:
        p = {k: shd.whole_over_model(v) for k, v in p.items()}
    x = x.to(compute_dtype)
    if split:
        x = shd.model_input(x)
    g = x @ p["w_gate"].to(compute_dtype)
    u = x @ p["w_up"].to(compute_dtype)
    if activation == "silu":
        act = F.silu(g.float())
    else:
        act = F.gelu(g.float(), approximate="tanh")
    h = act.to(compute_dtype) * u
    if split:
        # row-parallel: float32 partial products, summed before one
        # rounding to the compute dtype
        return h.float() @ p["w_down"].to(compute_dtype).float()
    return h @ p["w_down"].to(compute_dtype)


def init_embedding(gen: Optional[torch.Generator], vocab: int, d_model: int,
                   dtype) -> torch.Tensor:
    return (normal(gen, (vocab, d_model)) * 0.02).to(dtype)


def _whole_last_dim(x: torch.Tensor) -> torch.Tensor:
    """A DTensor ``x`` with its last dim whole on every shard (the label
    pick's gather has no rule over a sharded vocabulary); a plain tensor
    as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    last = x.ndim - 1
    pl = [Replicate() if isinstance(p, Shard) and p.dim in (-1, last) else p
          for p in x.placements]
    return x.redistribute(x.device_mesh, pl)


def _replicated(x: torch.Tensor) -> torch.Tensor:
    """A DTensor ``x`` whole on every process; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy in float32; with ``mask``, the mean over
    the masked tokens (``sum(mask)`` at least 1)."""
    # placed, the vocabulary-parallel logits are gathered into whole rows
    # once, for the normalizer and the label pick alike
    logits = _whole_last_dim(logits.float())
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    # placed, the token losses are summed whole on every process, in one
    # device's order, so a loss does not depend on the mesh
    nll = _replicated(logz - ll)
    if mask is None:
        return torch.mean(nll)
    mask = _replicated(mask.float())
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
