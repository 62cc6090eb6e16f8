"""Architecture + shape configuration system.

Every assigned architecture is a ``ModelConfig`` in its own module (one
file per arch, ``--arch <id>`` selectable); each has a ``reduced()``
variant for CPU smoke tests. Shapes are the four assigned input-shape
cells; ``long_500k`` is only valid for sub-quadratic archs (SSM/hybrid) —
``supports_shape`` encodes the skip rules recorded in DESIGN.md.

A copy of ``repro.configs.base`` for the PyTorch port: ``pdtype`` and
``cdtype`` return ``torch`` dtypes; everything else is unchanged, so the
registry gives the same configurations.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    activation: str = "silu"      # "gelu" => GeGLU (gemma)
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    soft_cap: Optional[float] = None
    window: Optional[int] = None  # sliding-window attention (tokens)
    # -- MoE --
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_dispatch: str = "sam"     # "sam" | "dense" (paper-baseline)
    first_dense_layers: int = 0
    # -- MLA (deepseek) --
    use_mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    rope_dim: int = 64
    v_head_dim: int = 128
    # -- SSM / hybrid --
    ssm_state: int = 64
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 64
    attn_every: int = 0           # zamba2: shared attn every N mamba layers
    slstm_layers: Tuple[int, ...] = ()
    # -- modality stubs --
    frontend: Optional[str] = None   # "siglip_stub" | "encodec_stub"
    n_patches: int = 256
    patch_dim: int = 1152
    # -- precision --
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # -- lowering --
    unroll_scan: bool = False     # roofline probes unroll layer scans

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pdtype(self):
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self):
        return getattr(torch, self.compute_dtype)

    def n_params(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("ssm",):
            for i in range(self.n_layers):
                di = int(d * 2)
                if i in self.slstm_layers:
                    per_layer += 4 * d * d + d * d + 4 * (d // self.n_heads) \
                        * d + d
                else:
                    per_layer += d * 2 * di + 3 * di * di + di * d \
                        + 2 * self.n_heads * di
            return emb + per_layer
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        if self.use_mla:
            attn = (d * self.q_lora_rank
                    + self.q_lora_rank * self.n_heads
                    * (self.qk_nope_dim + self.rope_dim)
                    + d * (self.kv_lora_rank + self.rope_dim)
                    + self.kv_lora_rank * self.n_heads
                    * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        mlp = 3 * d * self.d_ff
        total = emb
        if self.family == "hybrid":
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_headdim
            mamba = (d * (2 * d_in + 2 * self.ssm_state + nh)
                     + d_in * d + 4 * (d_in + 2 * self.ssm_state))
            total += self.n_layers * mamba
            total += attn + mlp   # one shared block
            return total
        for i in range(self.n_layers):
            total += attn
            if self.n_experts and i >= self.first_dense_layers:
                total += 3 * d * self.moe_d_ff * self.n_experts
                total += 3 * d * self.moe_d_ff * self.n_shared_experts
                total += d * self.n_experts
            else:
                total += mlp
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k + shared only)."""
        if not self.n_experts:
            return self.n_params()
        d = self.d_model
        total = self.n_params()
        inactive = 3 * d * self.moe_d_ff \
            * (self.n_experts - self.top_k) \
            * (self.n_layers - self.first_dense_layers)
        return total - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def supports_shape(cfg: ModelConfig, shape: str) -> bool:
    """long_500k needs sub-quadratic attention: SSM/hybrid only (the eight
    pure full-attention archs skip it — recorded in DESIGN.md)."""
    if shape == "long_500k":
        return cfg.family in ("ssm", "hybrid") or cfg.window is not None
    return True


_REGISTRY: Dict[str, "tuple"] = {}


def register(cfg: ModelConfig, reduced: ModelConfig):
    _REGISTRY[cfg.name] = (cfg, reduced)
    return cfg


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    from . import ALL_ARCHS  # noqa: F401 - triggers registration imports
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name][1 if reduced else 0]


def list_archs():
    from . import ALL_ARCHS  # noqa: F401
    return sorted(_REGISTRY)
