"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936 - qk_norm, GQA [hf:Qwen/Qwen3-0.6B; hf]."""
import dataclasses
from .base import ModelConfig, register

CFG = ModelConfig(
    name="qwen3-0.6b", family="dense", n_layers=28, d_model=1024,
    n_heads=16, n_kv_heads=8, d_ff=3072, vocab=151936, head_dim=128,
    qk_norm=True, rope_theta=1000000.0, tie_embeddings=True)

REDUCED = dataclasses.replace(
    CFG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16)

register(CFG, REDUCED)
