"""Stream generators reproducing the paper's workloads (Table I), port
of ``repro.core.streams``.

* Zipf(z) over ``n_keys`` unique keys (the ZF dataset).
* WP-like / TW-like traces: the (p1, #keys) skew profile of Table I,
  plus the diurnal rate modulation of Fig. 5.
* Heterogeneity profiles: "y machines are z times more powerful".

Keys are int32 ids sorted by decreasing frequency (rank 0 = hottest).
The samplers take a seed and draw with numpy (the reference draws with
``jax.random``, whose bits torch cannot reproduce: tests hand the same
key arrays to both packages).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device


def zipf_probs(n_keys: int, z: float) -> np.ndarray:
    """Probability mass of the zipf(z) distribution over ranks 1..n_keys."""
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    w = ranks ** (-z)
    return (w / w.sum()).astype(np.float64)


def _sample(seed: int, p: np.ndarray, n_messages: int,
            device) -> torch.Tensor:
    keys = np.random.default_rng(seed).choice(p.shape[0], size=n_messages,
                                              p=p).astype(np.int32)
    return torch.from_numpy(keys).to(resolve_device(device))


def sample_zipf_stream(seed: int, n_messages: int, n_keys: int, z: float,
                       device="cuda") -> torch.Tensor:
    """i.i.d. zipf(z) key stream as int32 ranks (0 = most frequent)."""
    return _sample(seed, zipf_probs(n_keys, z), n_messages, device)


@dataclass(frozen=True)
class TraceSpec:
    """Reduced-scale analogue of a Table I dataset."""
    name: str
    n_messages: int
    n_keys: int
    p1: float          # mass of the most frequent key
    z_tail: float      # zipf exponent of the tail
    diurnal: bool      # Fig. 5 style rate modulation


# Table I: WP 22M msgs / 2.9M keys / p1 = 9.32%; TW 1.2G / 31M / 2.67%.
# Reduced 20x-ish in messages, keys scaled to keep keys-per-message ratio.
WP_TRACE = TraceSpec("WP", n_messages=1_000_000, n_keys=130_000, p1=0.0932,
                     z_tail=1.0, diurnal=True)
TW_TRACE = TraceSpec("TW", n_messages=2_000_000, n_keys=500_000, p1=0.0267,
                     z_tail=0.8, diurnal=True)


def trace_probs(spec: TraceSpec) -> np.ndarray:
    """Zipf tail re-weighted so the top key carries exactly spec.p1."""
    p = zipf_probs(spec.n_keys, spec.z_tail)
    p1 = spec.p1
    tail = p[1:] * (1.0 - p1) / p[1:].sum()
    return np.concatenate([[p1], tail])


def sample_trace(seed: int, spec: TraceSpec, n_messages: int | None = None,
                 device="cuda") -> torch.Tensor:
    return _sample(seed, trace_probs(spec), n_messages or spec.n_messages,
                   device)


def diurnal_rate(t_hours: np.ndarray, base: float = 1.0,
                 amplitude: float = 0.35) -> np.ndarray:
    """Fig. 5-style messages-per-hour modulation (one diurnal cycle)."""
    return base * (1.0 + amplitude * np.sin(2 * np.pi * t_hours / 24.0))


# ---------------------------------------------------------------------------
# Heterogeneity profiles (paper Q2/Q3)
# ---------------------------------------------------------------------------

def heterogeneous_capacities(n: int, y: int, zfac: float,
                             normalize: bool = True) -> np.ndarray:
    """y of n machines are zfac times more powerful than the rest,
    normalized so capacities sum to 1 (paper §VI convention)."""
    c = np.ones(n, dtype=np.float64)
    c[:y] = zfac
    if normalize:
        c /= c.sum()
    return c


def dynamic_capacity_schedule(n: int, total_messages: int
                              ) -> list[tuple[int, np.ndarray]]:
    """Fig. 13 schedule: (y,z) = (3,5) -> after 1/3 (5,4) -> after 2/3
    (2,10). Returns [(start_message_index, capacities)]."""
    return [
        (0, heterogeneous_capacities(n, 3, 5.0)),
        (total_messages // 3, heterogeneous_capacities(n, 5, 4.0)),
        (2 * total_messages // 3, heterogeneous_capacities(n, 2, 10.0)),
    ]
