"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 - sLSTM + mLSTM
blocks (xLSTM[7:1]-style: sLSTM at layers 3, 11) [arXiv:2405.04517;
unverified]. Attention-free; the paper's SAM technique is inapplicable to
the recurrence (DESIGN.md SS5); runs long_500k (O(1) recurrent state)."""
import dataclasses
from .base import ModelConfig, register

CFG = ModelConfig(
    name="xlstm-125m", family="ssm", n_layers=12, d_model=768,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
    slstm_layers=(3, 11), ssm_chunk=64)

REDUCED = dataclasses.replace(
    CFG, n_layers=3, d_model=64, n_heads=2, n_kv_heads=2, vocab=256,
    slstm_layers=(1,))

register(CFG, REDUCED)
