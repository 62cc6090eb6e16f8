"""zamba2-2.7b [hybrid]: 54L(mamba2) d_model=2560 32H (kv=32) d_ff=10240
vocab=32000, ssm_state=64 - Mamba2 backbone + ONE shared attention+MLP
block applied every 6 mamba layers [arXiv:2411.15242; hf]. (Zamba2 uses two
alternating shared blocks; we model one, noted in DESIGN.md.) Runs
long_500k: mamba state is O(1), shared attention KV is seq-sharded."""
import dataclasses
from .base import ModelConfig, register

CFG = ModelConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000, head_dim=80,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, attn_every=6,
    ssm_chunk=64)

REDUCED = dataclasses.replace(
    CFG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256, head_dim=16, attn_every=2, ssm_headdim=16, ssm_state=16)

register(CFG, REDUCED)
