"""Salted 32-bit hash family used by every partitioner (port of
``repro.core.hashing``).

Same function as the reference bit for bit: the murmur3 fmix32 finalizer
applied twice around the salt. Torch on the CPU has no ``>>``, ``+`` or
``%`` for uint32, so the arithmetic runs in int64 and is masked to 32
bits after every step; an int64 product that wraps keeps its low 32
bits exact. Keys go through the same two's-complement cast as
``astype(uint32)`` (``key & 0xFFFFFFFF``), so negative int32 keys hash
like the reference's.

``hash_u32`` returns the uint32 value held in an int64 tensor.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_GAMMA_HI = 0x9E3779B9
_GAMMA_LO = 0x7F4A7C15


def _u32(x) -> torch.Tensor:
    """Any integer tensor / Python int → its uint32 value as int64."""
    return torch.as_tensor(x).to(torch.int64) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """Finalizer with strong avalanche (murmur3 fmix32)."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    x = x ^ (x >> 16)
    return x


def hash_u32(key, salt) -> torch.Tensor:
    """Salted 32-bit hash of integer keys. Shapes broadcast."""
    k = _u32(key)
    # a Python salt stays a Python int: no host-to-device copy per call
    s = salt & _M32 if isinstance(salt, int) else _u32(salt).to(k.device)
    h = _mix32((k + ((s * _GAMMA_HI) & _M32)) & _M32)
    return _mix32(h ^ ((((s * _GAMMA_LO) & _M32) + 0x165667B1) & _M32))


def hash_to_bins(key, salt, n_bins: int) -> torch.Tensor:
    """Salted hash of ``key`` into [0, n_bins). int32 result."""
    return (hash_u32(key, salt) % n_bins).to(torch.int32)


def hash_unit_interval(key, salt) -> torch.Tensor:
    """Salted hash onto the unit circle [0, 1) — consistent hashing ring."""
    return hash_u32(key, salt).to(torch.float32) / float(2**32)


def candidate_bins(key, d: int, n_bins: int) -> torch.Tensor:
    """The first ``d`` salted choices for each key: shape key.shape + (d,).

    candidate_bins(k, d, n)[..., i] == hash_to_bins(k, i + 1, n); salts
    start at 1 to match Alg. 1 (salt <- 1).
    """
    k = torch.as_tensor(key)
    salts = torch.arange(1, d + 1, dtype=torch.int64, device=k.device)
    return hash_to_bins(k[..., None], salts, n_bins)
