"""qwen3-moe-235b-a22b [moe]: 94L d=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

CG router (the paper's technique): capacity (1+ε)·S·k/E with overflow
probing — see repro_torch.moe. long_500k skipped (full attention).
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=1536, vocab=151_936,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536,
                  capacity_factor=1.25, overflow_depth=4, router="cg"),
    rope_theta=1_000_000.0,
    # 235B MoE: microbatch so dispatch buffers fit v5e HBM (§Perf)
    grad_accum=8,
)

SMOKE = CONFIG.replace(
    grad_accum=1, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=32, vocab=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                  capacity_factor=1.25, overflow_depth=2, router="cg"),
    attn_chunk_threshold=1 << 30, remat="none")
