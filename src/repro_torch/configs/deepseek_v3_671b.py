"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff(expert)=2048
vocab=129280, MoE 256e top-8, MLA (q_lora 1536, kv_lora 512, rope 64),
1 shared expert, first 3 layers dense d_ff=18432 [arXiv:2412.19437; hf].
MTP module omitted (single-token head), noted in DESIGN.md."""
import dataclasses
from .base import ModelConfig, register

CFG = ModelConfig(
    name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
    n_heads=128, n_kv_heads=128, d_ff=18432, vocab=129280,
    n_experts=256, top_k=8, n_shared_experts=1, moe_d_ff=2048,
    first_dense_layers=3, use_mla=True, q_lora_rank=1536,
    kv_lora_rank=512, qk_nope_dim=128, rope_dim=64, v_head_dim=128,
    rope_theta=10000.0)

REDUCED = dataclasses.replace(
    CFG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256, n_experts=8, top_k=2, moe_d_ff=32, first_dense_layers=1,
    q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, rope_dim=8,
    v_head_dim=16)

register(CFG, REDUCED)
