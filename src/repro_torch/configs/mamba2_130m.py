"""mamba2-130m [ssm]: 24L d=768 (attn-free) vocab=50280, ssm_state=128 —
SSD state-space duality [arXiv:2405.21060; unverified]. d_inner=1536,
headdim=64 → 24 SSD heads, 1 group. O(1) decode state.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab=50_280,
    ssm=SSMConfig(d_state=128, head_dim=64, n_groups=1, expand=2, chunk=128),
    subquadratic_decode=True,
    # 130M params: on a mesh the reference runs it as pure data parallel
    pure_dp=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, vocab=256,
    ssm=SSMConfig(d_state=16, head_dim=8, n_groups=1, expand=2, chunk=16),
    remat="none")
