"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000
- GeGLU, head_dim=256, MQA [arXiv:2403.08295; hf]."""
import dataclasses
from .base import ModelConfig, register

CFG = ModelConfig(
    name="gemma-2b", family="dense", n_layers=18, d_model=2048,
    n_heads=8, n_kv_heads=1, d_ff=16384, vocab=256000, head_dim=256,
    activation="gelu", tie_embeddings=True)

REDUCED = dataclasses.replace(
    CFG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab=256, head_dim=16)

register(CFG, REDUCED)
