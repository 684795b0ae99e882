"""command-r-plus-104b [dense]: 64L d=12288 96H (GQA kv=8) d_ff=33792
vocab=256000 — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01;
unverified]. Sequential residual blocks stand in for Cohere's parallel
block (same dims/FLOPs; DESIGN.md §9). long_500k skipped (full attn).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, d_head=128,
    d_ff=33792, vocab=256_000,
    use_bias=False, rope_theta=75_000_000.0,
    # the reference microbatches its 4k-token training batches in 4
    grad_accum=4,
)

SMOKE = CONFIG.replace(
    grad_accum=1, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, attn_chunk_threshold=1 << 30, remat="none")
