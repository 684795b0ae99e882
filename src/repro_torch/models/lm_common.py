"""Shared LM machinery: norms, embeddings, the chunked loss and the
tied logits head, the SSD chunk choice and cache plumbing (port of
``repro.models.lm_common``).

LayerNorm (``norm_kind="ln"``) comes with the families that use it
(ROADMAP Queue 1 item 10): the MoE archs use RMSNorm.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import rmsnorm


class Norm(nn.Module):
    """An RMSNorm's weights: ``scale``, zeros for its ``1 + scale``."""

    def __init__(self, cfg, dtype, device="cuda"):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(cfg.d_model, dtype=dtype,
                                              device=device),
                                  requires_grad=False)


def norm(x, p: Norm, cfg):
    return rmsnorm(x, p.scale)


def norm_params(cfg, dtype, device="cuda") -> Norm:
    return Norm(cfg, dtype, device)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 d_model: int) -> torch.Tensor:
    """Rows of the table, scaled by √d_model (an f32 square root) in the
    activation dtype."""
    x = embed[tokens.long()]
    root = torch.sqrt(torch.tensor(float(d_model), dtype=torch.float32))
    return x * root.to(x.dtype)


def _xent_chunk(xc: torch.Tensor, embed: torch.Tensor, lc: torch.Tensor):
    """(Σ token losses, count) of one chunk: f32 logits [B, C, V] against
    the tied table, log-sum-exp minus the target's logit where the label
    is not -1."""
    logits = torch.einsum("bcd,vd->bcv", xc.to(torch.float32),
                          embed.to(torch.float32))
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, torch.clamp(lc, min=0)[..., None].long())
    valid = (lc >= 0).to(torch.float32)
    return torch.sum((lse - tgt[..., 0]) * valid), torch.sum(valid)


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
    x_last [B, D] → [B, V]."""
    return x_last.to(torch.float32) @ embed.to(torch.float32).T


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


def update_kv_cache(k_cache, v_cache, k_new, v_new, pos):
    """Write [B, n, KV, Dh] at position ``pos`` (an int or a 0-dim
    tensor) of [B, S, KV, Dh], into new tensors. As the reference's
    ``dynamic_update_slice``, the start is clamped to [0, S - n]."""
    S, n = k_cache.shape[1], k_new.shape[1]
    start = torch.clamp(torch.as_tensor(pos, device=k_cache.device), 0, S - n)
    idx = start.long() + torch.arange(n, device=k_cache.device)
    k_cache = k_cache.index_copy(1, idx, k_new.to(k_cache.dtype))
    v_cache = v_cache.index_copy(1, idx, v_new.to(v_cache.dtype))
    return k_cache, v_cache
