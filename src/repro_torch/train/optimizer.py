"""AdamW with low-precision moments, the learning-rate schedule and
global-norm clipping.

A port of ``repro.train.optimizer``. Moments are stored in
``state_dtype`` (bfloat16 by default, rounded to nearest even) and taken
to float32 at the update; all the math is float32, the schedule
included (the reference takes the step to float32 before it). Trees are
nested dicts and lists of tensors; ``global_norm`` sums the leaves in
the reference's order (``jax.tree.leaves`` sorts a dict's keys). As in
the reference, every leaf with two or more dims gets decoupled weight
decay: the matrices, and also the stacked ``(L, d)`` norm scales.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from ..models.model import tree_leaves, tree_map, tree_unzip

__all__ = ["AdamWConfig", "lr_at", "init_opt_state", "global_norm",
           "adamw_update"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    state_dtype: str = "bfloat16"


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then a cosine decay to a tenth of ``cfg.lr`` at
    ``total_steps``; a float32 tensor on ``step``'s device."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(cfg: AdamWConfig, params) -> dict:
    """Zero moments in ``state_dtype`` beside each parameter (on its
    device, a placed parameter's moments with its placements) and a step
    count of 0 (int32, on the first leaf's device)."""
    dt = getattr(torch, cfg.state_dtype)

    def zeros(p):
        return torch.zeros_like(p, dtype=dt,
                                memory_format=torch.contiguous_format)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def adamw_update(cfg: AdamWConfig, params, grads, state
                 ) -> Tuple[Any, dict]:
    """One AdamW step: returns (new params, new state); the inputs are
    not changed."""
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    if cfg.clip_norm is not None:
        gn = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale.to(g.dtype), grads)

    bc1 = 1.0 - torch.pow(cfg.b1, step.float())
    bc2 = 1.0 - torch.pow(cfg.b2, step.float())
    sdt = getattr(torch, cfg.state_dtype)

    def upd(p, g, m, v):
        g32 = g.float()
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32 * g32
        mh = m32 / bc1
        vh = v32 / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        p32 = p.float()
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p32
        return (p32 - lr * delta).to(p.dtype), m32.to(sdt), v32.to(sdt)

    new_p, new_m, new_v = tree_unzip(
        tree_map(upd, params, grads, state["m"], state["v"]), 3)
    return new_p, {"m": new_m, "v": new_v, "step": step}

