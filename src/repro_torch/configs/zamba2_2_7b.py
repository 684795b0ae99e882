"""zamba2-2.7b [hybrid]: 54L d=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf]. Shared block applied every 6 SSM layers (9
invocations, one weight set). SSM decode is O(1); the shared block keeps
a KV cache per invocation.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_head=80,
    d_ff=10240, vocab=32_000,
    ssm=SSMConfig(d_state=64, head_dim=64, n_groups=1, expand=2, chunk=128),
    shared_attn_every=6,
    subquadratic_decode=True,
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=256,
    ssm=SSMConfig(d_state=16, head_dim=8, n_groups=1, expand=2, chunk=16),
    shared_attn_every=2, attn_chunk_threshold=1 << 30, remat="none")
