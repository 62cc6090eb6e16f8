"""Meta-tensor stand-ins for every (arch x shape) cell's step inputs.

``input_specs`` returns the shapes and dtypes of a step's inputs with NO
allocation: parameter, optimizer and cache trees are built by the real
init functions as meta tensors, batches directly. A port of
``repro.launch.specs``, whose ``ShapeDtypeStruct`` trees come from
``jax.eval_shape``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models.model import init_caches, init_params
from ..train.optimizer import AdamWConfig, init_opt_state

__all__ = ["batch_specs", "params_specs", "opt_specs", "cache_specs",
           "input_specs"]

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    out: Dict[str, Any] = {}
    if cfg.frontend == "encodec_stub":
        out["frames"] = _sds((b, s, cfg.d_model), torch.float32)
    else:
        out["tokens"] = _sds((b, s), torch.int32)
    if cfg.frontend == "siglip_stub":
        out["patches"] = _sds((b, cfg.n_patches, cfg.patch_dim),
                              torch.float32)
    if shape.kind == "train":
        out["labels"] = _sds((b, s), torch.int32)
    return out


def params_specs(cfg: ModelConfig):
    return init_params(cfg, None)


def opt_specs(cfg: ModelConfig, opt: AdamWConfig, params_tree):
    return init_opt_state(opt, params_tree)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    return init_caches(cfg, shape.global_batch, shape.seq_len,
                       torch.bfloat16, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                opt: AdamWConfig | None = None) -> Dict[str, Any]:
    """All step-function inputs for one cell: train -> (params,
    opt_state, batch); prefill/decode -> (params, caches, batch)."""
    p = params_specs(cfg)
    if shape.kind == "train":
        return {"params": p,
                "opt_state": opt_specs(cfg, opt or AdamWConfig(), p),
                "batch": batch_specs(cfg, shape)}
    return {"params": p,
            "caches": cache_specs(cfg, shape),
            "batch": batch_specs(cfg, shape)}
