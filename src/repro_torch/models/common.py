"""Shared model components of the PyTorch port: the dense initializer,
the gated MLP, and the carrier of the reference's parameters.

A partial port of ``repro.models.common``: only what ``models/moe.py``
needs. Parameters are drawn in ``param_dtype`` (float32 by default) and
computed in ``compute_dtype`` (bfloat16 by default), the reference's
mixed-precision policy. Random draws come from an explicit
``torch.Generator`` on the parameters' device, so they differ from the
reference's ``jax.random`` draws; ``params_from_numpy`` carries the
reference's own parameters across where the two must agree.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import coord_ops as co

__all__ = ["dense_init", "init_mlp", "apply_mlp", "params_from_numpy"]


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """(d_in, d_out) standard normal times ``scale`` (1/sqrt(d_in) by
    default), drawn in float32 on ``gen``'s device, cast to ``dtype``."""
    scale = scale if scale is not None else (1.0 / d_in) ** 0.5
    return (torch.randn((d_in, d_out), generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype) -> dict:
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


def params_from_numpy(p, device=None, dtype=None):
    """A nested dict of parameters as arrays (the reference's, through
    ``np.asarray``) as torch tensors on ``device`` (CUDA unless the caller
    names one; an error without a GPU). ``dtype`` casts the floating
    arrays; None keeps each array's own."""
    dev = co.resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        t = torch.tensor(np.asarray(v), device=dev)
        return t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t

    return conv(p)
