"""whisper-small [audio]: 12L enc + 12L dec, d=768 12H (kv=12) d_ff=3072
vocab=51865 — enc-dec, conv frontend STUB (precomputed frame embeddings)
[arXiv:2212.04356; unverified]. LayerNorm + GELU + biases. long_500k
skipped (enc-dec full attention).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small", family="audio",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_head=64, d_ff=3072, vocab=51_865,
    mlp_kind="gelu", norm_kind="ln", use_bias=True,
    # 242M params, d_model=768: over-sharded under tensor parallelism;
    # the reference trains it as pure data parallel
    pure_dp=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=128, vocab=256, attn_chunk_threshold=1 << 30,
    remat="none")
