"""Shared block-engine math of the plain torch engines (port of the
policy-free part of ``repro.kernels.blocks``).

Candidate resolution against a frozen load snapshot and the capacity
schedule. The CUDA kernels in ``csrc/porc_snapshot.cu`` compute the same
functions; ``cap_scale`` is the one constant both take from the host.

Every function takes a leading source dimension: ``load`` is
``[S, n_bins]``, ``cap`` ``[S]``, keys ``[S, block]`` and candidates
``[S, block, C]`` (the single-source engine passes S=1), which is the
reference's ``vmap`` over sources written out.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashing import hash_to_bins


def probe_salts(count: int, start: int = 1, device=None) -> torch.Tensor:
    """Salts ``start .. start+count-1`` (Alg. 1: salt <- 1), as int64."""
    return torch.arange(start, start + count, dtype=torch.int64,
                        device=device)


# ---------------------------------------------------------------------------
# Capacity schedule
# ---------------------------------------------------------------------------
# The reference writes the cap as (1+eps)·x/n. XLA folds it on compile:
# the division by the constant n becomes a product with f32(1/n), and the
# two constant factors fold into one, so the reference computes
# x · (f32(1+eps) · f32(1/n)) in f32. Both engines of the port take that
# one f32 constant, so caps agree bit for bit with the reference.

def cap_scale(eps: float, n_bins: int) -> float:
    """The f32 factor K with cap = x·K (exactly representable in f32)."""
    f32 = np.float32
    return float(f32(f32(1.0 + eps) * (f32(1.0) / f32(n_bins))))


def snapshot_cap(eps: float, n_bins: int, m0, b, block: int):
    """Single-source capacity at the end of block ``b``:
    (1+eps)·m_t/n with m_t = m0 + (b+1)·block (f32 tensors)."""
    return (m0 + (b + 1.0) * float(block)) * cap_scale(eps, n_bins)


def view_cap(eps: float, n_bins: int, mass, lookahead: float):
    """Per-source capacity from the local-view mass (multisource §V-C):
    (1+eps)·(mass + lookahead)/n with lookahead the source's share of
    the arriving block (block/S; 1/S for the ragged tail), rounded once
    to f32."""
    return (mass + float(np.float32(lookahead))) * cap_scale(eps, n_bins)


# ---------------------------------------------------------------------------
# Snapshot probing (the plain engine)
# ---------------------------------------------------------------------------

def _gather_views(load, cand):
    """load [S, n] at candidates [S, B, C] → [S, B, C]."""
    S = cand.shape[0]
    return load.gather(1, cand.reshape(S, -1).long()).reshape(cand.shape)


def snapshot_resolve(load, cap, cand, salts, assign, max_probes):
    """First under-cap candidate per key, respecting the probe ceiling."""
    ok = (_gather_views(load, cand) < cap[:, None, None]) \
        & (salts <= max_probes)[None, None, :]
    first = torch.argmax(ok.to(torch.int8), dim=2, keepdim=True)
    pick = cand.gather(2, first)[..., 0]
    hit = (assign < 0) & ok.any(dim=2)
    return torch.where(hit, pick, assign)


def snapshot_block(load, cap, kblk, cand0, n_bins: int, block: int,
                   chunk: int):
    """Route one block of keys per source against a frozen snapshot.

    Each key walks its salted-probe chain against its source's ``load``
    row and stops at the first bin below its ``cap``. At block=1 the
    full 4·n_bins chain of Alg. 1 runs (lazily, in chunks of ``chunk``
    salts); at block>1 the budget is the ``chunk`` pre-hashed candidates
    in ``cand0``. Exhausting the budget falls back to the least-loaded
    snapshot bin (lowest index on ties).
    """
    max_probes = 4 * n_bins
    dev = load.device
    salts0 = probe_salts(chunk, device=dev)
    assign = snapshot_resolve(
        load, cap, cand0, salts0,
        torch.full(kblk.shape, -1, dtype=torch.int32, device=dev),
        max_probes)
    if block == 1:
        # exactness: continue the salted chain to the oracle ceiling
        salt0 = 1 + chunk
        while salt0 <= max_probes and bool((assign < 0).any()):
            salts = salt0 + probe_salts(chunk, start=0, device=dev)
            cand = hash_to_bins(kblk[..., None], salts, n_bins)
            assign = snapshot_resolve(load, cap, cand, salts, assign,
                                      max_probes)
            salt0 += chunk
    # probe budget exhausted: least-loaded snapshot bin (Alg. 1)
    fallback = torch.argmin(load, dim=1).to(torch.int32)[:, None]
    return torch.where(assign < 0, fallback, assign)
