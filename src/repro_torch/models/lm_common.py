"""Shared LM machinery: norms, embeddings, the chunked loss and the
tied logits head, the SSD chunk choice and cache plumbing (port of
``repro.models.lm_common``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from .layers import (fsdp, layernorm, local, rmsnorm, shard_act,
                     whole_middle, zeros_param)


class Norm(nn.Module):
    """A norm's weights: an RMSNorm's ``scale``, zeros for its
    ``1 + scale``; with ``cfg.norm_kind == "ln"`` a LayerNorm's
    ``scale`` (ones) and ``bias`` (zeros)."""

    def __init__(self, cfg, dtype, device="cuda"):
        super().__init__()
        self.scale = zeros_param(cfg.d_model, dtype, device)
        if cfg.norm_kind == "ln":
            with torch.no_grad():
                self.scale.fill_(1)
            self.bias = zeros_param(cfg.d_model, dtype, device)


def norm(x, p: Norm, cfg):
    """The norm of ``p`` (``cfg.norm_kind``), computed where ``x`` lies,
    its output made whole along the sequence (``layers.whole_middle``):
    what follows a norm is a product."""
    if cfg.norm_kind == "ln":
        return whole_middle(layernorm(x, p.scale, p.bias))
    return whole_middle(rmsnorm(x, p.scale))


def norm_params(cfg, dtype, device="cuda") -> Norm:
    return Norm(cfg, dtype, device)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 d_model: int) -> torch.Tensor:
    """Rows of the table, scaled by √d_model (an f32 square root) in the
    activation dtype."""
    embed = shard_act(embed, "vd")   # also pins d_embed's sharding in bwd
    x = _rows(embed, tokens.long())
    root = torch.sqrt(torch.tensor(float(d_model), dtype=torch.float32))
    return x * root.to(x.dtype)


def _vocab_shard_read(read, n: int, mesh, v_dims, ix):
    """(``read`` of this rank's local indices, the mask of ``ix`` that its
    vocabulary shard of ``n`` entries holds): the shard of mesh dimension
    ``v_dims[0]``, or the whole vocabulary without one; an index outside
    it reads entry 0, which the caller masks out."""
    lo = mesh.get_local_rank(v_dims[0]) * n if v_dims else 0
    hit = (ix >= lo) & (ix < lo + n)
    return read(torch.where(hit, ix - lo, 0)), hit


def _rows(embed, idx):
    """``embed[idx]``. On a DTensor table a ``local_map``, the
    vocab-parallel lookup: the table's columns gathered whole over the
    axes the indices' batch is sharded on, each rank reads the rows its
    vocabulary shard holds (zeros for the rest), a partial sum over the
    vocabulary's mesh dimensions; the table's gradient a partial sum over
    the batch's."""
    if not isinstance(embed, DTensor):
        return embed[idx]
    mesh = embed.device_mesh
    v_dims = [i for i, p in enumerate(embed.placements) if p == Shard(0)]
    if len(v_dims) > 1:                  # one mesh dimension cuts V at most
        v_dims = v_dims[:1]
    b_dims = [i for i, p in enumerate(idx.placements) if p == Shard(0)
              and i not in v_dims] if isinstance(idx, DTensor) else []
    table = tuple(Shard(0) if i in v_dims else Replicate()
                  for i in range(mesh.ndim))
    table_grad = tuple(Partial() if i in b_dims else p
                       for i, p in enumerate(table))
    ids = tuple(Shard(0) if i in b_dims else Replicate()
                for i in range(mesh.ndim))
    out = tuple(Partial() if i in v_dims else p for i, p in enumerate(ids))

    def local_fn(tab, ix):
        rows, hit = _vocab_shard_read(lambda i: tab[i], tab.shape[0], mesh,
                                      v_dims, ix)
        return torch.where(hit[..., None], rows, 0.0)

    return local_map(local_fn, out_placements=(out,),
                     in_placements=(table, ids),
                     in_grad_placements=(table_grad, ids), device_mesh=mesh,
                     redistribute_inputs=True)(embed, idx)


def _xent_chunk(xc: torch.Tensor, embed: torch.Tensor, lc: torch.Tensor):
    """(Σ token losses, count) of one chunk: f32 logits [B, C, V] against
    the tied table, log-sum-exp minus the target's logit where the label
    is not -1."""
    logits = torch.einsum("bcd,vd->bcv", xc.to(torch.float32),
                          embed.to(torch.float32))
    logits = shard_act(logits, "bcv")
    lse = _logsumexp(logits)
    tgt = _target_logit(logits, torch.clamp(lc, min=0).long())
    if isinstance(tgt, DTensor):
        tgt = tgt.redistribute(tgt.device_mesh, tuple(
            Replicate() if isinstance(p, Partial) else p
            for p in tgt.placements))
    valid = (lc >= 0).to(torch.float32)
    return torch.sum((lse - tgt) * valid), torch.sum(valid)


def _logsumexp(logits):
    """``logsumexp`` over the last dimension. Of a DTensor cut there (the
    "bcv" rule's vocabulary) as the reference's GSPMD reduces it: a max
    and a sum, each over the shards, instead of gathering the logits
    (DTensor's own ``logsumexp`` gathers them). The max is a constant of
    the gradient, which is exact."""
    v = logits.dim() - 1
    if not (isinstance(logits, DTensor) and Shard(v) in logits.placements):
        return torch.logsumexp(logits, dim=-1)
    mesh = logits.device_mesh
    rows = tuple(Replicate() if p == Shard(v) else p
                 for p in logits.placements)
    # each reduction made whole on the ranks of its shards, the rows kept
    # as they are: DTensor would otherwise choose another row layout,
    # against which the backward gathers the logits
    m = torch.amax(logits.detach(), dim=-1, keepdim=True).redistribute(
        mesh, rows)
    m = torch.where(torch.isinf(m), 0.0, m)
    s = torch.sum(torch.exp(logits - m), dim=-1).redistribute(mesh, rows)
    return torch.log(s) + m[..., 0]


def _target_logit(logits, idx):
    """logits[..., idx] of [B, C, V] logits at [B, C] indices. On a
    DTensor whose V is sharded (the "bcv" rule) a ``local_map`` where
    each rank reads the targets its vocabulary shard holds and 0 for the
    rest, a partial sum over those mesh dimensions: the vocab-parallel
    gather, without gathering the logits."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, idx[..., None])[..., 0]
    mesh, v = logits.device_mesh, logits.dim() - 1
    v_dims = [i for i, p in enumerate(logits.placements) if p == Shard(v)]
    if len(v_dims) > 1:                  # one mesh dimension cuts V at most
        keep = tuple(Replicate() if i in v_dims[1:] else p
                     for i, p in enumerate(logits.placements))
        logits = logits.redistribute(mesh, keep)
        v_dims = v_dims[:1]
    rows = tuple(Replicate() if i in v_dims else p
                 for i, p in enumerate(logits.placements))
    out = tuple(Partial() if i in v_dims else p
                for i, p in enumerate(logits.placements))

    def local_fn(lg, ix):
        got, hit = _vocab_shard_read(
            lambda i: torch.gather(lg, -1, i[..., None])[..., 0],
            lg.shape[-1], mesh, v_dims, ix)
        return torch.where(hit, got, 0.0)

    return local_map(local_fn, out_placements=(out,),
                     in_placements=(logits.placements, rows),
                     in_grad_placements=(logits.placements, rows),
                     device_mesh=mesh, redistribute_inputs=True)(logits, idx)


def chunked_xent(x: torch.Tensor, embed: torch.Tensor, labels: torch.Tensor,
                 chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy without materializing [B, S, V].

    x: [B, S, D] final hidden states; embed: [V, D] (tied head); labels:
    [B, S] int (already shifted; -1 = ignore). Sequence chunks of
    ``chunk`` run in turn, so the live logits are [B, chunk, V] f32; under
    autograd each chunk's logits are recomputed in the backward
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``).
    As in the reference, a tail of S % chunk positions is left out.
    """
    B, S, D = x.shape
    chunk = min(chunk, S)
    n = S // chunk
    grad = torch.is_grad_enabled()
    embed = shard_act(embed, "vd")   # pins d_embed accumulation sharding
    # gathered over the batch's axes once for every chunk's product, where
    # ``matmul`` in ``_xent_chunk`` would gather it again for each chunk
    embed = fsdp(embed, x)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (x[:, sl], embed, labels[:, sl])
        t, c = (checkpoint(_xent_chunk, *args, use_reentrant=False) if grad
                else _xent_chunk(*args))
        tot = tot + t
        cnt = cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def shift_labels(tokens: torch.Tensor) -> torch.Tensor:
    """Next-token labels: labels[t] = tokens[t+1], last = ignore (-1)."""
    return torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)],
                     dim=1)


def last_logits(x_last: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Decode-step logits from the tied embedding, in f32:
    x_last [B, D] → [B, V]. The "vd" rule keeps the (model, data)-sharded
    table in place: the d-contraction resolves as a sum of [B, V/shards]
    partials, not an all-gather of the table."""
    embed = shard_act(embed, "vd")
    return shard_act(x_last.to(torch.float32) @ embed.to(torch.float32).T,
                     "bv")


def pad_cache_seq(kv: torch.Tensor, pad_to: int | None, axis: int = 2):
    """Zero-pad a stacked KV cache [..., S, KV, Dh] along seq to pad_to
    (headroom for decode continuation)."""
    if pad_to is None or kv.shape[axis] >= pad_to:
        return kv
    shape = list(kv.shape)
    shape[axis] = pad_to - kv.shape[axis]
    return torch.cat([kv, kv.new_zeros(shape)], dim=axis)


def pick_chunk(seq: int, target: int) -> int:
    """Largest divisor of ``seq`` that is ≤ target (SSD chunk picking)."""
    c = min(target, seq)
    while seq % c != 0:
        c -= 1
    return c


def zeros_from_spec(spec: dict, device) -> dict:
    """A cache of zeros on ``device`` with the shapes and dtypes of a
    ``cache_spec`` (meta tensors)."""
    return {name: torch.zeros(sp.shape, dtype=sp.dtype, device=device)
            for name, sp in spec.items()}


def _kv_index(k_cache, n: int, pos) -> torch.Tensor:
    """The n sequence positions a write at ``pos`` (an int or a 0-dim
    tensor) covers: as the reference's ``dynamic_update_slice``, the start
    is clamped to [0, S - n]."""
    S = k_cache.shape[1]
    start = torch.clamp(torch.as_tensor(pos, device=k_cache.device), 0, S - n)
    return start.long() + torch.arange(n, device=k_cache.device)


def update_kv_cache(k_cache, v_cache, k_new, v_new, pos):
    """Write [B, n, KV, Dh] at position ``pos`` (an int or a 0-dim
    tensor) of [B, S, KV, Dh], in place (the caches may be views, e.g.
    one layer of a stacked cache); returns the caches. The reference
    writes into new arrays: a step here holds one cache, not two.

    A DTensor cache whose sequence is whole on every rank is written on
    each rank's shard, the new entries laid out as the cache first (a
    cache sharded on its sequence goes through ``sp_decode``'s branch)."""
    if isinstance(k_cache, DTensor):
        mesh = k_cache.device_mesh
        if any(isinstance(p, Shard) and p.dim == 1 and mesh.size(i) > 1
               for i, p in enumerate(k_cache.placements)):
            raise ValueError("update_kv_cache: the cache is sharded on its "
                             "sequence; write it through sp_decode")
        k_new, v_new = (n.redistribute(k_cache.device_mesh,
                                       k_cache.placements)
                        if isinstance(n, DTensor) else n
                        for n in (k_new, v_new))
        update_kv_cache(local(k_cache), local(v_cache), local(k_new),
                        local(v_new), local(pos))
        return k_cache, v_cache
    idx = _kv_index(k_cache, k_new.shape[1], pos)
    k_cache.index_copy_(1, idx, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, idx, v_new.to(v_cache.dtype))
    return k_cache, v_cache
