"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32) d_ff=8192
vocab=2048 - decoder-only over EnCodec tokens [arXiv:2306.05284; hf].
The EnCodec frontend + codebook delay pattern is a STUB: input_specs
provides precomputed (B, S, d_model) frame embeddings; one codebook head."""
import dataclasses
from .base import ModelConfig, register

CFG = ModelConfig(
    name="musicgen-large", family="audio", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=2048, head_dim=64,
    activation="gelu", frontend="encodec_stub")

REDUCED = dataclasses.replace(
    CFG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=64, head_dim=16)

register(CFG, REDUCED)
