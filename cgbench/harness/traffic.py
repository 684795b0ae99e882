"""The general traffic generator: keys drawn on the device from a seed,
and the slot schedule a traffic mix asks for.

A key mix is Table I's form (arXiv:1705.09073): ``n_keys`` keys ranked
by frequency (key id = rank, 0 the hottest), a zipf(``z_tail``) tail,
and the top key re-weighted to carry exactly ``p1`` of the mass; with
``p1`` null the top key keeps its zipf mass, so ``z_tail`` 0 is uniform.
Keys are drawn by inverse transform: uniform doubles from a
``torch.Generator`` seeded with ``--seed`` on the device, looked up in
the float64 cumulative distribution.
"""
from __future__ import annotations

import torch

SAMPLE_CHUNK = 1 << 24        # keys drawn per call


def key_probs(keys: dict, device) -> torch.Tensor:
    """Probability of every key rank, float64 on ``device``."""
    n = int(keys["n_keys"])
    z = float(keys["z_tail"])
    ranks = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    p = ranks.pow(-z)
    p = p / p.sum()
    p1 = keys.get("p1")
    if p1 is not None and n > 1:
        tail = p[1:] * ((1.0 - float(p1)) / p[1:].sum())
        p = torch.cat([torch.full((1,), float(p1), dtype=torch.float64,
                                  device=device), tail])
    return p


def sample_keys(keys: dict, n_messages: int, seed: int,
                device) -> torch.Tensor:
    """``n_messages`` int32 keys of the mix ``keys``, the same for the
    same seed and device."""
    cdf = torch.cumsum(key_probs(keys, device), 0)
    cdf = cdf / cdf[-1]
    last = cdf.shape[0] - 1
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    out = torch.empty(n_messages, dtype=torch.int32, device=device)
    for start in range(0, n_messages, SAMPLE_CHUNK):
        stop = min(start + SAMPLE_CHUNK, n_messages)
        u = torch.rand(stop - start, dtype=torch.float64, generator=g,
                       device=device)
        idx = torch.searchsorted(cdf, u, right=True, out_int32=True)
        out[start:stop] = torch.clamp(idx, max=last)
    del cdf
    return out


def slots_needed(traffic: dict, slot_len: int, seconds: float,
                 warm_slots: int) -> int:
    """Slots of keys to make: the warm-up plus what the window can use
    at the mix's highest rate (closed loop: ``max_rate_msgs_per_s``, a
    bound above what the system sustains; open loop: its rate)."""
    rate = float(traffic["max_rate_msgs_per_s"] if traffic["loop"] == "closed"
                 else traffic["rate_msgs_per_s"])
    return warm_slots + int(rate * seconds / slot_len) + 2


def make_stream(traffic: dict, slot_len: int, n_slots: int, seed: int,
                device) -> torch.Tensor:
    """The run's keys as [n_slots, slot_len] int32 on ``device``."""
    keys = sample_keys(traffic["keys"], n_slots * slot_len, seed, device)
    return keys.reshape(n_slots, slot_len)
