"""phi3.5-moe-42b-a6.6b [moe]: 32L d=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf].

CG router. long_500k skipped (full attention).
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=6400, vocab=32_064,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400,
                  capacity_factor=1.25, overflow_depth=4, router="cg"),
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=32, vocab=256,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32,
                  capacity_factor=1.25, overflow_depth=2, router="cg"),
    attn_chunk_threshold=1 << 30, remat="none")
