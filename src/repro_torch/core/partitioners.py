"""Stream partitioners of the paper (Table II) that CG and its KG
baseline need — port of part of ``repro.core.partitioners``:

KG    key grouping                      H(j)                    stateless
SG    shuffle grouping                  round robin             stateless
PoRC  power of random choices (Alg. 1)  salted probe < cap      load state

PoRC comes in its exact sequential form (one message per unit time),
its block-parallel form (B messages per load snapshot, bit-identical at
B=1) and its multi-source form (§V-C). D-Choices and W-Choices are PoRC
with heavy-hitter-aware probe depths (arXiv:1510.05714). The other
schemes of the reference registry (PKG, PoTC, CH, Greedy-d) are not
ported yet and ``route`` rejects them.

Every partitioner routes the whole stream it is given against fresh
state and discards that state on return.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device

from .hashing import hash_to_bins

# Cap on PoRC probe chains (§VI-B): 4·n is a safe ceiling.
_MAX_PROBES_FACTOR = 4


def key_grouping(keys: torch.Tensor, n_bins: int,
                 salt: int = 1) -> torch.Tensor:
    """KG: pure hash of the key."""
    return hash_to_bins(keys, salt, n_bins)


def shuffle_grouping(keys: torch.Tensor, n_bins: int,
                     offset: int = 0) -> torch.Tensor:
    """SG: cyclic round robin, key-oblivious."""
    m = keys.shape[0]
    return ((torch.arange(m, dtype=torch.int32, device=keys.device) + offset)
            % n_bins).to(torch.int32)


# ---------------------------------------------------------------------------
# PoRC — Algorithm 1, exact sequential semantics
# ---------------------------------------------------------------------------

def porc_sequential(keys: torch.Tensor, n_bins: int, eps: float,
                    load0: torch.Tensor, t0) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Alg. 1 one message at a time from load ``load0`` and f32 clock
    ``t0``: probe H(j+salt), salt=1,2,… until load < (1+eps)·(t+1)/n,
    at most 4·n probes, else the least-loaded bin (lowest index).

    The per-message loop runs on the host (it is the oracle the block
    engines are held against, not a fast path): the clock and the loads
    are f32 values, the capacity is (t+1)·K with the block engines' f32
    factor K, and deep probes hash one salt at a time.
    Returns (assignment [m] int32, final load [n_bins] f32).
    """
    from repro_torch.kernels.blocks import cap_scale
    f32 = np.float32
    dev = keys.device
    m = keys.shape[0]
    max_probes = _MAX_PROBES_FACTOR * n_bins
    K = f32(cap_scale(eps, n_bins))
    one = f32(1.0)
    keys_c = keys.cpu()
    d = min(8, max_probes)
    cand = hash_to_bins(keys_c[:, None], torch.arange(1, d + 1),
                        n_bins).numpy()
    load = load0.detach().cpu().numpy().astype(f32).copy()
    t = f32(torch.as_tensor(t0).item())
    out = np.empty(m, np.int32)
    for i in range(m):
        cap = (t + one) * K
        pick = -1
        for s in range(1, max_probes + 1):
            c = (cand[i, s - 1] if s <= d else
                 int(hash_to_bins(keys_c[i], s, n_bins)))
            if load[c] < cap:
                pick = c
                break
        if pick < 0:
            pick = int(np.argmin(load))
        load[pick] += one
        out[i] = pick
        t = t + one
    return (torch.from_numpy(out).to(dev),
            torch.from_numpy(load).to(dev))


def power_of_random_choices(keys, n_bins: int, eps: float = 0.01,
                            device="cuda") -> torch.Tensor:
    """PoRC (Alg. 1): probe H(j+salt), salt=1,2,… until load <
    (1+eps)·m_t/n, m_t counting the arriving message."""
    keys = torch.as_tensor(keys).to(resolve_device(device))
    load0 = torch.zeros(n_bins, dtype=torch.float32, device=keys.device)
    return porc_sequential(keys, n_bins, eps, load0, 0.0)[0]


# ---------------------------------------------------------------------------
# Block-parallel and multi-source PoRC — the kernel block engines
# ---------------------------------------------------------------------------

def power_of_random_choices_blocked(keys, n_bins: int, eps: float = 0.01,
                                    block: int = 128, engine: str = "ref",
                                    device="cuda") -> torch.Tensor:
    """Batched PoRC: Alg. 1 against a per-block load snapshot.
    ``engine``: "ref" (plain torch) | "cuda" (the kernel) | "auto"."""
    from repro_torch.kernels.ref import ref_porc_route
    assign, _ = ref_porc_route(keys, n_bins, block=block, eps=eps,
                               engine=engine, device=device)
    return assign


def power_of_random_choices_multisource(keys, n_bins: int, n_sources: int,
                                        eps: float = 0.01, block: int = 128,
                                        sync_every: int = 1, hh=None,
                                        engine: str = "ref",
                                        device="cuda") -> torch.Tensor:
    """Multi-source PoRC (§V-C): round-robin split across ``n_sources``
    sources with local load views, delta-merged every ``sync_every``
    blocks."""
    from repro_torch.kernels.ref import ref_porc_multisource
    assign, _ = ref_porc_multisource(keys, n_bins, n_sources,
                                     sync_every=sync_every, block=block,
                                     eps=eps, policy=hh, engine=engine,
                                     device=device)
    return assign


# ---------------------------------------------------------------------------
# D-Choices / W-Choices — heavy-hitter-aware probe depths (1510.05714)
# ---------------------------------------------------------------------------

def _hh_choices(keys, n_bins: int, scheme: str, eps: float, block: int, hh,
                engine: str = "ref", device="cuda") -> torch.Tensor:
    from repro_torch.kernels.ref import HHPolicy, ref_porc_route
    policy = (HHPolicy(scheme=scheme) if hh is None
              else hh._replace(scheme=scheme))
    assign, _ = ref_porc_route(keys, n_bins, block=block, eps=eps,
                               policy=policy, engine=engine, device=device)
    return assign


def d_choices(keys, n_bins: int, eps: float = 0.01, block: int = 128,
              hh=None, engine: str = "ref", device="cuda") -> torch.Tensor:
    """D-Choices: PoRC block engine with per-key probe budgets — heavy
    keys (count-min estimate ≥ ``hot_fraction``·m_t) probe up to
    ``d_heavy`` salted choices, tail keys keep ``d_tail``. ``hh``
    overrides the default ``HHPolicy`` knobs (the scheme is forced)."""
    return _hh_choices(keys, n_bins, "d", eps, block, hh, engine, device)


def w_choices(keys, n_bins: int, eps: float = 0.01, block: int = 128,
              hh=None, engine: str = "ref", device="cuda") -> torch.Tensor:
    """W-Choices: like D-Choices, but a heavy key's probe ceiling is the
    full worker set, its budget set by the Eq.-2 schedule. ``hh``
    overrides the default ``HHPolicy`` knobs (the scheme is forced)."""
    return _hh_choices(keys, n_bins, "w", eps, block, hh, engine, device)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def route(scheme: str, keys, n_bins: int, *, eps: float = 0.01,
          block_size: int | None = None, sources: int = 1,
          sync_every: int = 1, hh=None, engine: str = "ref",
          device="cuda") -> torch.Tensor:
    """Route a full stream with the named scheme (KG, SG, PORC, DCHOICES
    or WCHOICES).

    ``block_size=None`` is the exact sequential oracle; ``>= 1`` the
    block path (bit-identical at 1). ``sources > 1`` is the §V-C
    multi-source PoRC. ``DCHOICES``/``WCHOICES`` are block-native
    (``block_size=None`` means 128), accept ``sources > 1``, and take
    ``hh`` (an ``HHPolicy``) to override their knobs; every other scheme
    rejects ``hh``. ``engine`` ("ref" | "cuda" | "auto") selects the
    block engine of the PoRC family's block and multi-source paths.
    """
    scheme = scheme.upper()
    if scheme not in ALL_SCHEMES + HH_SCHEMES:
        raise NotImplementedError(
            f"scheme {scheme!r} is not ported yet (ROADMAP: the rest of "
            "partitioners); the port routes KG, SG, PORC, DCHOICES and "
            "WCHOICES")
    if hh is not None and scheme not in HH_SCHEMES:
        raise ValueError(f"scheme {scheme!r} takes no heavy-hitter policy")
    if engine != "ref" and scheme not in ("PORC",) + HH_SCHEMES:
        raise ValueError(f"scheme {scheme!r} has no kernel engine variant")
    if engine != "ref" and scheme == "PORC" and not (block_size
                                                     or sources > 1):
        raise ValueError("engine applies to the block path — pass "
                         "block_size (the sequential oracle is plain only)")
    keys = torch.as_tensor(keys).to(resolve_device(device))
    if scheme in HH_SCHEMES:
        from repro_torch.kernels.ref import HHPolicy
        letter = "d" if scheme == "DCHOICES" else "w"
        if sources > 1:
            policy = (HHPolicy(scheme=letter) if hh is None
                      else hh._replace(scheme=letter))
            return power_of_random_choices_multisource(
                keys, n_bins, sources, eps=eps, block=block_size or 128,
                sync_every=sync_every, hh=policy, engine=engine,
                device=keys.device)
        return _hh_choices(keys, n_bins, letter, eps, block_size or 128, hh,
                           engine, keys.device)
    if scheme == "KG":
        return key_grouping(keys, n_bins)
    if scheme == "SG":
        return shuffle_grouping(keys, n_bins)
    if sources > 1:
        return power_of_random_choices_multisource(
            keys, n_bins, sources, eps=eps, block=block_size or 128,
            sync_every=sync_every, engine=engine, device=keys.device)
    if block_size:
        return power_of_random_choices_blocked(keys, n_bins, eps=eps,
                                               block=block_size,
                                               engine=engine,
                                               device=keys.device)
    return power_of_random_choices(keys, n_bins, eps=eps, device=keys.device)


ALL_SCHEMES = ("KG", "SG", "PORC")
HH_SCHEMES = ("DCHOICES", "WCHOICES")
