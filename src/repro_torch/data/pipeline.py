"""Deterministic, stateless synthetic data pipeline.

``batch_for_step(step)`` is a pure function of (seed, step, host): the
property the fault-tolerance contract depends on. A restarted job
regenerates the exact token stream with no iterator state to checkpoint.

A port of ``repro.data.pipeline``: the same keys, shapes, dtypes and
ranges per frontend, and the same host slicing. The draws come from a
fresh CPU ``torch.Generator`` seeded from ``np.random.SeedSequence((seed,
step, host))`` and are then put on the device the caller names (CUDA
unless the caller names another; an error without a GPU), so every
device gets the same batch. They are not the reference's threefry
stream: the two packages' batches differ, as their ``init_params``
draws do.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core import coord_ops as co

__all__ = ["batch_for_step", "decode_batch"]


def _generator(*entropy: int) -> torch.Generator:
    seed = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


def batch_for_step(cfg: ModelConfig, shape: ShapeConfig, step: int,
                   *, host: int = 0, num_hosts: int = 1, seed: int = 0,
                   device=None) -> Dict[str, torch.Tensor]:
    """Global batch for ``step`` (host slice if num_hosts > 1): int32
    ``tokens`` and ``labels`` (the same draws shifted by one) in
    ``[0, vocab)``; float32 ``frames`` (B, S, d_model) and int32
    ``labels`` for ``encodec_stub``; float32 ``patches`` (B, n_patches,
    patch_dim) beside the tokens for ``siglip_stub``."""
    dev = co.resolve_device(device)
    b = shape.global_batch // num_hosts
    s = shape.seq_len
    gen = _generator(seed, step, host)
    out: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "encodec_stub":
        out["frames"] = torch.randn((b, s, cfg.d_model), generator=gen)
        out["labels"] = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                      dtype=torch.int32)
    else:
        tokens = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen,
                               dtype=torch.int32)
        out["tokens"] = tokens[:, :-1]
        out["labels"] = tokens[:, 1:]
        if cfg.frontend == "siglip_stub":
            out["patches"] = torch.randn(
                (b, cfg.n_patches, cfg.patch_dim), generator=gen)
    return {k: v.contiguous().to(dev) for k, v in out.items()}


def decode_batch(cfg: ModelConfig, batch_size: int, *, seed: int = 0,
                 device=None) -> Dict[str, torch.Tensor]:
    """One decode step's inputs: ``tokens`` (B, 1), or ``frames`` (B, 1,
    d_model) for ``encodec_stub``; ``patches`` beside the tokens for
    ``siglip_stub``."""
    dev = co.resolve_device(device)
    gen = _generator(seed)
    out: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "encodec_stub":
        out["frames"] = torch.randn((batch_size, 1, cfg.d_model),
                                    generator=gen)
    else:
        out["tokens"] = torch.randint(0, cfg.vocab, (batch_size, 1),
                                      generator=gen, dtype=torch.int32)
        if cfg.frontend == "siglip_stub":
            out["patches"] = torch.randn(
                (batch_size, cfg.n_patches, cfg.patch_dim), generator=gen)
    return {k: v.to(dev) for k, v in out.items()}
