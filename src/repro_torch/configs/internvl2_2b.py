"""internvl2-2b [vlm]: 24L d=2048 16H (GQA kv=8) d_ff=8192 vocab=92553 —
InternViT + InternLM2 [arXiv:2404.16821; hf].

The InternViT frontend is a STUB per the assignment: input_specs
provides precomputed patch embeddings [B, 256, 1024] which are linearly
projected and prepended to the token stream. long_500k skipped
(full-attention backbone).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=92_553,
    vision_dim=1024, n_patches=256,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, vision_dim=32, n_patches=8,
    attn_chunk_threshold=1 << 30, remat="none")
