"""Deterministic token data pipeline with CG-based heterogeneous sharding
(port of ``repro.data.pipeline``).

The paper's technique applied to training: data-parallel hosts are the
*workers*, pipeline shards are the *virtual workers*. Shard → host
assignment follows the CG runtime: hosts that fall behind (the straggler
signal of ``repro_torch.runtime.straggler``) give shards up through
paired moves; routing changes affect only future batches (no message
migration). Shards are seeded deterministically, so restart-after-
failure replays the exact stream suffix from the checkpointed step.

The reference draws a (shard, step) batch with ``jax.random.choice``,
whose stream torch cannot reproduce. Here each (shard, step) batch has
its own NumPy generator seeded from ``(seed, shard_id, step)``, whose
uniforms go through the inverse of the zipf CDF (what
``Generator.choice(vocab, p=probs)`` computes, with the CDF built once
per pipeline rather than once per batch). A batch is still a pure
function of those three, so the stream is restartable and independent
of order, but its tokens differ from the reference's (tests that
compare the two packages hand both the same tokens).
Batches are int32 tensors on the host; the trainer moves them to its
device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import streams


@dataclass(frozen=True)
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    n_shards_per_host: int = 8     # virtual workers (α)
    zipf_z: float = 1.1            # token skew of the synthetic corpus
    seed: int = 0


class ShardedTokenPipeline:
    """Synthetic skewed-corpus pipeline (the substrate the paper's WP/TW
    traces stand in for). Every (shard, step) batch is a pure function of
    (seed, shard_id, step) — restartable and order-independent."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self.n_shards = cfg.n_hosts * cfg.n_shards_per_host
        # shard → host assignment (the CG virtual-worker table)
        self.shard_owner = np.repeat(np.arange(cfg.n_hosts),
                                     cfg.n_shards_per_host)
        cdf = np.cumsum(streams.zipf_probs(cfg.vocab, cfg.zipf_z))
        self._cdf = cdf / cdf[-1]

    # -- CG pairing hook (runtime.straggler calls this) ------------------
    def move_shard(self, from_host: int, to_host: int) -> int | None:
        """Move one shard from an overloaded host to an idle one (paired
        move). Returns the shard id or None if from_host owns none."""
        owned = np.flatnonzero(self.shard_owner == from_host)
        if len(owned) == 0:
            return None
        sid = int(owned[-1])
        self.shard_owner[sid] = to_host
        return sid

    def shards_of(self, host: int) -> np.ndarray:
        return np.flatnonzero(self.shard_owner == host)

    # -- batch generation -------------------------------------------------
    def _shard_batch(self, shard_id: int, step: int,
                     n_seq: int) -> torch.Tensor:
        u = np.random.default_rng((self.cfg.seed, shard_id, step)).random(
            (n_seq, self.cfg.seq_len))
        toks = np.searchsorted(self._cdf, u, side="right")
        return torch.from_numpy(toks.astype(np.int32))

    def host_batch(self, host: int, step: int) -> torch.Tensor:
        """The host's share of the global batch at ``step``, produced by
        its currently-owned shards (CG: share follows capacity)."""
        shards = self.shards_of(host)
        per_shard = max(1, self.cfg.global_batch // self.n_shards)
        parts = [self._shard_batch(int(s), step, per_shard) for s in shards]
        if not parts:
            return torch.zeros((0, self.cfg.seq_len), dtype=torch.int32)
        return torch.cat(parts, dim=0)

    def global_batch(self, step: int) -> torch.Tensor:
        """All shards' batches in shard order (single-controller mode)."""
        per_shard = max(1, self.cfg.global_batch // self.n_shards)
        parts = [self._shard_batch(s, step, per_shard)
                 for s in range(self.n_shards)]
        out = torch.cat(parts, dim=0)
        return out[: self.cfg.global_batch]
