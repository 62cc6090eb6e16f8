"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 [hf:ibm-granite/granite-3.0-8b-base; hf]."""
import dataclasses
from .base import ModelConfig, register

CFG = ModelConfig(
    name="granite-3-8b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=12800, vocab=49155, head_dim=128,
    rope_theta=10000.0, tie_embeddings=True)

REDUCED = dataclasses.replace(
    CFG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16)

register(CFG, REDUCED)
