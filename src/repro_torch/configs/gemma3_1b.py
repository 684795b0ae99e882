"""gemma3-1b [dense]: 26L d=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.

5:1 local:global sliding-window interleave, 128k context
[hf:google/gemma-3-1b-pt; unverified]. Local window 1024; every 6th
layer is global full attention. Runs long_500k via the ring-buffer
local-KV decode path (DESIGN.md §4).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_head=256,
    d_ff=6912, vocab=262_144,
    sliding_window=1024, global_every=6,
    rope_theta=1_000_000.0,
    subquadratic_decode=True,
)

SMOKE = CONFIG.replace(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=1, d_head=16,
    d_ff=128, vocab=256, sliding_window=16, global_every=3,
    attn_chunk_threshold=1 << 30, remat="none")
