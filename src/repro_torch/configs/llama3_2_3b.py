"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256 [hf:meta-llama/Llama-3.2-3B; unverified]."""
import dataclasses
from .base import ModelConfig, register

CFG = ModelConfig(
    name="llama3.2-3b", family="dense", n_layers=28, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=8192, vocab=128256, head_dim=128,
    rope_theta=500000.0, tie_embeddings=True)

REDUCED = dataclasses.replace(
    CFG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16)

register(CFG, REDUCED)

# Beyond-paper variant (DESIGN.md §8 deviations ledger): SAM block-sparse
# sliding-window
# attention (the kernels/bsr_attention path; lowered as windowed masking)
# makes the 500k-token cell sub-quadratic and therefore lowerable. Reported
# separately — it does not replace the faithful long_500k skip above.
CFG_BSR = dataclasses.replace(CFG, name="llama3.2-3b-bsr", window=4096)
REDUCED_BSR = dataclasses.replace(REDUCED, name="llama3.2-3b-bsr",
                                  window=32)
register(CFG_BSR, REDUCED_BSR)
