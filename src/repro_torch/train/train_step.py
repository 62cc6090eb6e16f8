"""The prefill and the decode step a server calls, as functions of
(params, caches, batch).

The serving half of ``repro.train.train_step``: ``make_prefill_step``
and ``make_serve_step``. ``make_train_step`` and the optimizer come with
the training slice (ROADMAP.md, still to port #8). The reference jits the
steps it builds; the port's run eagerly.
"""
from __future__ import annotations

from typing import Callable

from ..configs.base import ModelConfig
from ..models import model as M

__all__ = ["make_prefill_step", "make_serve_step"]


def make_serve_step(cfg: ModelConfig) -> Callable:
    """``(params, caches, batch) -> (logits (B, V), caches)``: one cached
    token."""
    def serve_step(params, caches, batch):
        return M.decode_step(cfg, params, caches, batch)
    return serve_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """``(params, caches, batch) -> (last logits (B, V), caches)``: the
    prompt written into the caches."""
    def prefill(params, caches, batch):
        logits, caches = M.forward(cfg, params, batch, caches)
        return logits[:, -1], caches
    return prefill
