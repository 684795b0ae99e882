"""Sequence-parallel decode attention (flash-decoding; port of
``repro.models.sp_decode``).

A decode step over a KV cache sharded on its sequence over the "model"
axis would, left to sharding propagation, gather the whole cache every
step. The sequence-parallel branch is a ``local_map`` (the reference's
``shard_map``) over the installed mesh where each "model" shard

  1. writes the new K/V into its slice of the cache, in place, if the
     write position falls in its range, and
  2. attends over its slice, the shards' (max, Σexp, Σexp·v) combined
     by log-sum-exp: an all-reduce MAX of the max, then SUM of the
     corrected sums over the "model" group (``mesh.get_group("model")``);
     bytes moved a step: O(B·H·Dh), not O(B·S·KV·Dh).

It runs where the activation rules carry a mesh whose "model" axis
(n > 1 ranks) divides the cache's sequence S ≥ 2n, and the cache is a
DTensor sharded on S that way (``launch.sharding.cache_specs``). Elsewhere
the single-device branch runs: the in-place write
(``lm_common.update_kv_cache``, on each rank's shard for a DTensor cache)
and ``decode_attention``; so for whisper's read-only cross cache
(``seqpar_attend``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.launch.mesh import data_axes, mesh_shape

from .layers import (_NEG, _expand_kv, _scale, decode_attention,
                     installed_act_rules)
from .lm_common import update_kv_cache


def _mesh_and_dp():
    mesh = installed_act_rules().get("_mesh")
    if not isinstance(mesh, DeviceMesh) or "model" not in mesh.mesh_dim_names:
        return None, None
    return mesh, data_axes(mesh)


def _seqpar_layout(mesh, dp, k_cache):
    """(cache, q/new placements) of the branch, or None where it does not
    run: no mesh, one "model" rank, a sequence the axis does not cut into
    shards of ≥ 2, or a cache that is plain or whole along its sequence
    on every rank (pure data parallelism), which each rank writes and
    reads on its own."""
    if mesh is None or not isinstance(k_cache, DTensor):
        return None
    sizes = mesh_shape(mesh)
    n_model = sizes["model"]
    B, S = k_cache.shape[0], k_cache.shape[1]
    if (n_model == 1 or S % n_model != 0 or S < n_model * 2
            or Shard(1) not in k_cache.placements):
        return None
    n_dp = 1
    for a in dp:
        n_dp *= sizes[a]
    b_split = B % n_dp == 0 and B >= n_dp
    row = tuple(Shard(0) if (a in dp and b_split and sizes[a] > 1)
                else Replicate() for a in mesh.mesh_dim_names)
    cache = tuple(Shard(1) if a == "model" else p
                  for a, p in zip(mesh.mesh_dim_names, row))
    if tuple(k_cache.placements) != cache:
        raise ValueError(
            f"sequence-parallel decode: the cache is placed "
            f"{k_cache.placements}, not {cache}: its in-place write would "
            "land in a copy (place it by launch.sharding.cache_specs)")
    return cache, row


def _combine(s, v, group):
    """Attention of one shard's f32 scores ``s`` [B, H, 1, S_loc] over
    its values ``v`` [B, S_loc, KV, Dh], combined across ``group`` by
    log-sum-exp → [B, 1, H, Dh] f32 (``v``'s KV heads repeated to H)."""
    v = _expand_kv(v, s.shape[1])
    m = s.amax(dim=-1)                                    # [B, H, 1]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bhqd", p, v.to(torch.float32))
    M = m.clone()
    dist.all_reduce(M, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - M)
    L = l * corr
    O = o * corr[..., None]
    dist.all_reduce(L, group=group)
    dist.all_reduce(O, group=group)
    out = O / torch.clamp(L, min=1e-30)[..., None]
    return out.transpose(1, 2)


def _local_scores(q, kc, start, valid):
    """f32 scores of q [B, 1, H, Dh] against one shard ``kc``
    [B, S_loc, KV, Dh] starting at ``start``, ``_NEG`` where ``valid``
    (a function of the absolute positions) is False."""
    k = _expand_kv(kc, q.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * _scale(q.shape[-1])
    idx = start + torch.arange(kc.shape[1], device=q.device)
    return s.masked_fill_(~valid(idx)[None, None, None, :], _NEG)


def seqpar_update_and_attend(q, k_cache, v_cache, k_new, v_new, pos,
                             lo=None, valid_len=None):
    """Fused cache write + decode attention, sequence-parallel over
    "model" where the branch runs (module docstring).

    q: [B, 1, H, Dh]; caches: [B, S, KV, Dh], written in place (one
    layer's view of a stacked cache); k_new/v_new: [B, 1, KV, Dh];
    pos: int or 0-dim int tensor; lo: optional window lower bound of the
    same kinds (entries below it masked: sliding-window decode);
    valid_len: entries at position ≥ it are masked (default ``pos + 1``;
    a ring buffer's is its filled length).
    Returns (out [B, 1, H, Dh], k_cache, v_cache).
    """
    mesh, dp = _mesh_and_dp()
    layout = _seqpar_layout(mesh, dp, k_cache)
    if valid_len is None:
        valid_len = pos + 1
    if layout is None:
        kc, vc = update_kv_cache(k_cache, v_cache, k_new, v_new, pos)
        return decode_attention(q, kc, vc, valid_len, lo_idx=lo), kc, vc
    cache_pl, row = layout
    rep = (Replicate(),) * mesh.ndim
    group = mesh.get_group("model")
    pos = torch.as_tensor(pos, device=k_cache.device)
    lo = torch.as_tensor(0 if lo is None else lo, device=k_cache.device)
    valid_len = torch.as_tensor(valid_len, device=k_cache.device)

    def local_fn(q, kc, vc, kn, vn, pos, lo, valid_len):
        S_loc = kc.shape[1]
        start = mesh.get_local_rank("model") * S_loc
        li = torch.clamp(pos - start, 0, S_loc - 1).long().reshape(1)
        in_rng = (pos >= start) & (pos < start + S_loc)
        for c, n in ((kc, kn), (vc, vn)):
            old = c.index_select(1, li)
            c.index_copy_(1, li, torch.where(in_rng, n.to(c.dtype), old))
        s = _local_scores(q, kc, start,
                          lambda i: (i < valid_len) & (i >= lo))
        return _combine(s, vc, group).to(q.dtype)

    fn = local_map(local_fn, out_placements=(row,),
                   in_placements=(row, cache_pl, cache_pl, row, row, rep,
                                  rep, rep),
                   device_mesh=mesh, redistribute_inputs=True)
    return (fn(q, k_cache, v_cache, k_new, v_new, pos, lo, valid_len),
            k_cache, v_cache)


def seqpar_attend(q, k_cache, v_cache, valid_len):
    """Read-only decode attention (whisper's cross-attention against its
    static encoder memory): the same log-sum-exp combine where the
    branch runs, no cache write.

    q: [B, 1, H, Dh]; caches: [B, S, KV, Dh]; valid_len: entries at
    position ≥ it are masked. Returns [B, 1, H, Dh].
    """
    mesh, dp = _mesh_and_dp()
    layout = _seqpar_layout(mesh, dp, k_cache)
    if layout is None:
        return decode_attention(q, k_cache, v_cache, valid_len)
    cache_pl, row = layout
    rep = (Replicate(),) * mesh.ndim
    group = mesh.get_group("model")
    valid_len = torch.as_tensor(valid_len, device=k_cache.device)

    def local_fn(q, kc, vc, valid_len):
        start = mesh.get_local_rank("model") * kc.shape[1]
        s = _local_scores(q, kc, start, lambda i: i < valid_len)
        return _combine(s, vc, group).to(q.dtype)

    fn = local_map(local_fn, out_placements=(row,),
                   in_placements=(row, cache_pl, cache_pl, rep),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k_cache, v_cache, valid_len)
