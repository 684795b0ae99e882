"""starcoder2-3b [dense]: 30L d=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.

GQA, RoPE [arXiv:2402.19173; hf]. StarCoder2 specifics honored: LayerNorm,
2-matrix GELU MLP, biases, sliding window 4096 on all layers.
long_500k skipped per assignment (full-attention lineage).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_head=128,
    d_ff=12288, vocab=49_152,
    mlp_kind="gelu", norm_kind="ln", use_bias=True,
    sliding_window=4096, rope_theta=100_000.0,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, sliding_window=16,
    attn_chunk_threshold=1 << 30, remat="none")
