"""paligemma-3b [vlm]: gemma-2b decoder (18L d_model=2048 8H kv=1
d_ff=16384) + SigLIP stub frontend, vocab=257216, prefix-LM attention on
the 256 image patches [arXiv:2407.07726; hf]. The SigLIP tower is a STUB:
input_specs provides precomputed (B, 256, 1152) patch embeddings."""
import dataclasses
from .base import ModelConfig, register

CFG = ModelConfig(
    name="paligemma-3b", family="vlm", n_layers=18, d_model=2048,
    n_heads=8, n_kv_heads=1, d_ff=16384, vocab=257216, head_dim=256,
    activation="gelu", tie_embeddings=True,
    frontend="siglip_stub", n_patches=256, patch_dim=1152)

REDUCED = dataclasses.replace(
    CFG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab=256, head_dim=16, n_patches=8, patch_dim=32)

register(CFG, REDUCED)
