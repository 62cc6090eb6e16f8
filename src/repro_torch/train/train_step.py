"""The train step (rematerialization, micro-batches, gradient
compression) and the prefill and decode steps a server calls.

A port of ``repro.train.train_step``. ``make_train_step`` returns a
function ``(params, opt_state, batch) -> (params, opt_state, metrics)``
that changes none of its inputs; the reference jits its steps, the
port's run eagerly. Gradients are ``torch.autograd.grad`` of
``models.model.loss_fn`` with respect to the parameter leaves.

Remat: per-layer ``torch.utils.checkpoint`` with a selectable policy
(``models.model``'s docstring):
  "none"  — save everything (smallest recompute, highest memory)
  "dots"  — save only the projections' outputs (products without batch dims)
  "full"  — save nothing (max recompute, min memory)

Micro-batches: the batch is split into ``n_micro`` slices run one after
another, the gradients accumulated in float32, then divided by
``n_micro`` (and so is the loss).

Gradient compression: int8 with error feedback (``opt_state["err"]``),
per leaf, applied to the accumulated gradient before the optimizer.

Placed parameters (DTensors over a process group's mesh,
``distributed.sharding.place``) go through the same functions: the step
runs inside ``spmd_region``, each gradient is redistributed to its
parameter's placements (a replicated leaf's gradient comes out
``Partial(sum)``; the reduction happens there, so the compression's
abs-max and rounding see reduced values), the error feedback and the
optimizer's moments take their parameters' placements, and the metrics
come back whole on every process.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..distributed.sharding import spmd_region
from ..models import model as M
from .optimizer import AdamWConfig, adamw_update, global_norm

__all__ = ["REMAT_POLICIES", "remat_loss_fn", "quantize_int8",
           "value_and_grad", "make_train_step", "make_prefill_step",
           "make_serve_step"]

REMAT_POLICIES = M.REMAT_POLICIES      # the names forward(remat=) accepts


def remat_loss_fn(cfg: ModelConfig, remat: str = "dots") -> Callable:
    """Loss with per-layer rematerialization applied inside the stacks."""
    return lambda params, batch: M.loss_fn(cfg, params, batch, remat=remat)


def quantize_int8(g: torch.Tensor, err: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 quantize/dequantize with error feedback. Returns (g_hat, err);
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    g32 = g.float() + err
    scale = torch.max(torch.abs(g32)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    g_hat = q.float() * scale
    return g_hat.to(g.dtype), g32 - g_hat


def value_and_grad(loss_fn, params, batch):
    """(loss, the gradient tree of ``loss_fn(params, batch)`` with respect
    to ``params``): the leaves are detached copies that require grad, so
    ``params`` is not changed; a leaf the loss does not reach gets
    zeros."""
    leaves = [t.detach().requires_grad_(True)
              for t in M.tree_leaves(params)]
    with torch.enable_grad(), spmd_region(params):
        loss = loss_fn(M.tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else _like(g, t)
             for t, g in zip(leaves, grads)]
    return loss.detach(), M.tree_unflatten(params, grads)


def _like(g, p):
    """A DTensor gradient redistributed to its parameter's placements
    (this reduces a ``Partial`` one); a plain one as it is."""
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _zeros32(params):
    return M.tree_map(lambda p: torch.zeros_like(
        p, dtype=torch.float32, memory_format=torch.contiguous_format),
        params)


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, *,
                    remat: str = "dots", n_micro: int = 1,
                    compress_grads: bool = False) -> Callable:
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``: one
    AdamW step on the gradients of ``loss_fn`` (under ``remat``; the
    batch in ``n_micro`` slices; int8-compressed with error feedback in
    ``opt_state["err"]`` under ``compress_grads``); metrics ``loss``,
    ``grad_norm`` (of the gradients the optimizer took) and ``step``."""
    loss_fn = remat_loss_fn(cfg, remat)

    def train_step(params, opt_state, batch):
        with spmd_region(params):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        if n_micro == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            micro = [{k: v.reshape((n_micro, v.shape[0] // n_micro)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()} for i in range(n_micro)]
            gsum = _zeros32(params)
            lsum = 0.0
            for mb in micro:
                l, g = value_and_grad(loss_fn, params, mb)
                gsum = M.tree_map(lambda a, gg: a + gg.float(), gsum, g)
                lsum = lsum + l
            grads = M.tree_map(lambda g: g / n_micro, gsum)
            loss = lsum / n_micro

        if compress_grads:
            ef = opt_state.get("err")
            if ef is None:
                ef = _zeros32(params)
            grads, new_err = M.tree_unzip(
                M.tree_map(quantize_int8, grads, ef), 2)
        core = {k: opt_state[k] for k in ("m", "v", "step")}
        new_params, new_core = adamw_update(opt, params, grads, core)
        new_state = dict(new_core)
        if compress_grads:
            new_state["err"] = new_err
        metrics = {"loss": _whole(loss.float()),
                   "grad_norm": _whole(global_norm(grads)),
                   "step": _whole(new_core["step"])}
        return new_params, new_state, metrics

    return train_step


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
