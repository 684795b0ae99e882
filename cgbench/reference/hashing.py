"""The salted 32-bit hash family of CG's partitioners: the murmur3
fmix32 finalizer applied twice around the salt, in int64 masked to 32
bits after every step (torch has no unsigned 32-bit arithmetic on the
CPU). Keys go through the two's-complement cast ``key & 0xFFFFFFFF``."""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
GAMMA_HI = 0x9E3779B9
GAMMA_LO = 0x7F4A7C15


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64) & M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = _u32(x)
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def hash_u32(key, salt) -> torch.Tensor:
    """Salted hash of integer keys as an int64 holding a uint32."""
    k = _u32(key)
    s = salt & M32 if isinstance(salt, int) else _u32(salt).to(k.device)
    h = _mix32((k + ((s * GAMMA_HI) & M32)) & M32)
    return _mix32(h ^ ((((s * GAMMA_LO) & M32) + 0x165667B1) & M32))


def hash_to_bins(key, salt, n_bins: int) -> torch.Tensor:
    """``hash_u32(key, salt) % n_bins`` as int32."""
    return (hash_u32(key, salt) % n_bins).to(torch.int32)


def salts(count: int, start: int = 1, device="cpu") -> torch.Tensor:
    """Salts ``start .. start+count-1`` (Alg. 1 starts at salt 1)."""
    return torch.arange(start, start + count, dtype=torch.int64,
                        device=device)
