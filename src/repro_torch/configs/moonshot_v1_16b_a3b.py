"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16) d_ff(expert)=1408
vocab=163840, MoE 64e top-6, 2 shared experts (kimi/moonlight)
[hf:moonshotai/Moonlight-16B-A3B; hf]."""
import dataclasses
from .base import ModelConfig, register

CFG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=5632, vocab=163840, head_dim=128,
    n_experts=64, top_k=6, n_shared_experts=2, moe_d_ff=1408,
    first_dense_layers=1, rope_theta=50000.0)

REDUCED = dataclasses.replace(
    CFG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256, head_dim=16, n_experts=8, top_k=2, moe_d_ff=32,
    first_dense_layers=1)

register(CFG, REDUCED)
