"""Decode-time cache write and attention (port of the single-device
branch of ``repro.models.sp_decode``).

The reference's sequence-parallel branch (a ``shard_map`` over the
"model" axis with a log-sum-exp combine) runs only on a mesh whose
"model" axis shards the cache; it goes to the mesh tier (ROADMAP Queue 1
item 7). On one device the reference takes the branch ported here. Its
``lo`` (the sliding window's lower bound) comes with the families that
use a window (item 10).
"""
from __future__ import annotations

from .layers import decode_attention
from .lm_common import update_kv_cache


def seqpar_update_and_attend(q, k_cache, v_cache, k_new, v_new, pos):
    """Cache write + decode attention.

    q: [B, 1, H, Dh]; caches: [B, S, KV, Dh]; k_new/v_new: [B, 1, KV, Dh];
    pos: int or 0-dim int tensor.
    Returns (out [B, 1, H, Dh], k_cache, v_cache).
    """
    kc, vc = update_kv_cache(k_cache, v_cache, k_new, v_new, pos)
    return decode_attention(q, kc, vc, pos + 1), kc, vc
