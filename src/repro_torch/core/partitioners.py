"""The stream-partitioning strategies of the paper (Table II), port of
``repro.core.partitioners``:

KG    key grouping                      H(j)                    stateless
SG    shuffle grouping                  round robin             stateless
PKG   partial key grouping              2 key-choices, argmin   load state
PoTC  power of two choices              2 msg-choices, argmin   load state
CH    consistent hashing bounded load   clockwise probe < cap   ring + load
PoRC  power of random choices (Alg. 1)  salted probe < cap      load state
GREEDY_D  Greedy-d (§VI-A-1)            d key-choices, argmin   load state

The load-stateful schemes come in their exact sequential form (one
message per unit time; the per-message loop runs on the host, as the
oracle the block engines are held against) and, PKG/PoTC/PoRC, a
block-parallel form (B messages per load snapshot, bit-identical at B=1)
that runs on the stream's device. PoRC also has its multi-source form
(§V-C) and, through ``engine="strict"``, the rank-sequential block
engine. D-Choices and W-Choices are PoRC with heavy-hitter-aware probe
depths (arXiv:1510.05714).

Every partitioner routes the whole stream it is given against fresh
state and discards that state on return.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device

from .hashing import hash_to_bins, hash_unit_interval

# Cap on PoRC/CH probe chains (§VI-B): 4·n is a safe ceiling.
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
# Greedy-d (covers PKG d=2 on keys, PoTC d=2 on message ids)
# ---------------------------------------------------------------------------

def _ids(keys: torch.Tensor, on_message_id: bool) -> torch.Tensor:
    if on_message_id:
        return torch.arange(keys.shape[0], dtype=torch.int32,
                            device=keys.device)
    return keys.to(torch.int32)


def greedy_d(keys, n_bins: int, d: int = 2, on_message_id: bool = False,
             device="cuda") -> torch.Tensor:
    """Greedy-d balls-and-bins (§VI-A-1): place on the argmin-load
    choice (the first of equal loads), loads int32.

    ``on_message_id=False`` hashes the *key* (PKG when d=2: key
    splitting); ``on_message_id=True`` hashes the *message index* (PoTC
    when d=2). The per-message loop runs on the host.
    """
    keys = torch.as_tensor(keys).to(resolve_device(device))
    ids = _ids(keys, on_message_id).cpu()
    cand = hash_to_bins(ids[:, None], torch.arange(1, d + 1),
                        n_bins).tolist()
    load = [0] * n_bins
    out = np.empty(len(cand), np.int32)
    for i, row in enumerate(cand):
        pick = row[0]
        for c in row[1:]:
            if load[c] < load[pick]:
                pick = c
        load[pick] += 1
        out[i] = pick
    return torch.from_numpy(out).to(keys.device)


def partial_key_grouping(keys, n_bins: int, device="cuda") -> torch.Tensor:
    """PKG = Greedy-2 over keys."""
    return greedy_d(keys, n_bins, d=2, on_message_id=False, device=device)


def power_of_two_choices(keys, n_bins: int, device="cuda") -> torch.Tensor:
    """PoTC = Greedy-2 over message ids."""
    return greedy_d(keys, n_bins, d=2, on_message_id=True, device=device)


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
    factor K, and a key whose walk passes its first 8 salts hashes the
    rest of its chain in doubling chunks.
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
        chain = cand[i]
        for s in range(max_probes):
            if s == len(chain):
                salts = torch.arange(s + 1, min(2 * s, max_probes) + 1)
                chain = np.concatenate(
                    [chain, hash_to_bins(keys_c[i], salts, n_bins).numpy()])
            c = chain[s]
            if load[c] < cap:
                pick = int(c)
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
# Block-parallel variants — eventually-consistent load state
# ---------------------------------------------------------------------------
#
# Each block of B messages is routed against the load snapshot taken at
# the block boundary. With block=1 every variant is bit-identical to its
# sequential oracle above.

def _greedy_blocked_core(ids: torch.Tensor, load0: torch.Tensor,
                         n_bins: int, d: int, block: int):
    """Greedy-d over full blocks: every message of a block picks the
    argmin-load candidate (the first of equal loads) against the
    block-start snapshot; int32 loads. Returns (picks, load)."""
    nb = ids.shape[0] // block
    dev = ids.device
    salts = torch.arange(1, d + 1, dtype=torch.int64, device=dev)
    cand = hash_to_bins(ids[:, None], salts, n_bins).reshape(nb, block, d)
    load = load0.clone()
    ones = torch.ones(block, dtype=torch.int32, device=dev)
    picks = torch.empty((nb, block), dtype=torch.int32, device=dev)
    for b in range(nb):
        c = cand[b].long()
        pick = c.gather(1, load[c].argmin(1, keepdim=True))[:, 0]
        load.index_add_(0, pick, ones)
        picks[b] = pick
    return picks.reshape(-1), load


def greedy_d_blocked(keys, n_bins: int, d: int = 2,
                     on_message_id: bool = False, block: int = 128,
                     device="cuda") -> torch.Tensor:
    """Block-parallel Greedy-d (batched PKG / PoTC) on the stream's
    device. Any stream length; a trailing partial block runs as
    power-of-two sub-blocks (``kernels.ref.block_spans``)."""
    from repro_torch.kernels.ref import route_in_spans
    keys = torch.as_tensor(keys).to(resolve_device(device))
    ids = _ids(keys, on_message_id)
    assign, _ = route_in_spans(
        ids, block, torch.zeros(n_bins, dtype=torch.int32, device=ids.device),
        lambda sub, blk, load: _greedy_blocked_core(sub, load, n_bins, d,
                                                    blk))
    return assign


def partial_key_grouping_blocked(keys, n_bins: int, block: int = 128,
                                 device="cuda") -> torch.Tensor:
    """Batched PKG = block-parallel Greedy-2 over keys."""
    return greedy_d_blocked(keys, n_bins, d=2, on_message_id=False,
                            block=block, device=device)


def power_of_two_choices_blocked(keys, n_bins: int, block: int = 128,
                                 device="cuda") -> torch.Tensor:
    """Batched PoTC = block-parallel Greedy-2 over message ids."""
    return greedy_d_blocked(keys, n_bins, d=2, on_message_id=True,
                            block=block, device=device)


# PoRC's block-parallel and multi-source forms: the kernel block engines

def power_of_random_choices_blocked(keys, n_bins: int, eps: float = 0.01,
                                    block: int = 128, engine: str = "ref",
                                    device="cuda") -> torch.Tensor:
    """Batched PoRC: Alg. 1 against a per-block load snapshot.
    ``engine``: "ref" (plain torch) | "cuda" (the kernel) | "auto", or
    "strict" (the rank-sequential engine, the cap held inside a
    block)."""
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
    blocks. ``engine`` as for ``power_of_random_choices_blocked``."""
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
# CH — consistent hashing with bounded loads (Mirrokni et al.)
# ---------------------------------------------------------------------------

class _Ring(NamedTuple):
    order: torch.Tensor      # bin ids sorted by ring position
    positions: torch.Tensor  # sorted ring positions (f32)


def build_ring(n_bins: int, points_per_bin: int = 1, salt0: int = 7,
               device="cuda") -> _Ring:
    """Hash each bin onto the unit circle (points_per_bin replicas)."""
    dev = resolve_device(device)
    bins = torch.arange(n_bins, dtype=torch.int32, device=dev)
    salts = torch.arange(salt0, salt0 + points_per_bin, dtype=torch.int64,
                         device=dev)
    pos = hash_unit_interval(bins[:, None], salts).reshape(-1)
    owners = bins[:, None].expand(n_bins, points_per_bin).reshape(-1)
    idx = torch.argsort(pos, stable=True)
    return _Ring(order=owners[idx], positions=pos[idx])


def consistent_hashing_bounded(keys, n_bins: int, eps: float = 0.01,
                               points_per_bin: int = 1,
                               device="cuda") -> torch.Tensor:
    """CH: walk clockwise from H(key)'s successor to the first bin with
    load < (1+eps)·m_t/n (Consistent Hashing with Bounded Loads); after
    4·(ring points) probes, the least-loaded bin (lowest index). The
    per-message loop runs on the host, with the cap (t+1)·K as in
    ``porc_sequential``."""
    from repro_torch.kernels.blocks import cap_scale
    f32 = np.float32
    keys = torch.as_tensor(keys).to(resolve_device(device))
    ring = build_ring(n_bins, points_per_bin, device="cpu")
    order = ring.order.tolist()
    n_points = len(order)
    max_probes = _MAX_PROBES_FACTOR * n_points
    K = f32(cap_scale(eps, n_bins))
    one = f32(1.0)
    p = hash_unit_interval(keys.cpu(), 1).numpy()
    start = (np.searchsorted(ring.positions.numpy(), p, side="left")
             % n_points).tolist()
    load = np.zeros(n_bins, f32)
    out = np.empty(len(start), np.int32)
    t = f32(0.0)
    for i, j in enumerate(start):
        cap = (t + one) * K
        probes = 0
        while load[order[j]] >= cap and probes < max_probes:
            j = (j + 1) % n_points
            probes += 1
        pick = int(np.argmin(load)) if probes >= max_probes else order[j]
        load[pick] += one
        out[i] = pick
        t = t + one
    return torch.from_numpy(out).to(keys.device)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def route(scheme: str, keys, n_bins: int, *, eps: float = 0.01,
          block_size: int | None = None, sources: int = 1,
          sync_every: int = 1, hh=None, engine: str = "ref",
          device="cuda") -> torch.Tensor:
    """Route a full stream with the named scheme (paper Table II symbols).

    ``block_size=None`` uses the exact sequential oracles (one message
    per unit time). Any ``block_size >= 1`` takes the block-parallel path
    for the load-stateful schemes (PKG/PoTC/PoRC) — bit-identical at 1,
    eventually consistent above. KG/SG are stateless and CH walks a ring
    sequentially; all three ignore ``block_size``.

    ``sources > 1`` is the §V-C multi-source PoRC (block path); KG/SG are
    source-oblivious, and the other load-stateful schemes reject it.
    ``DCHOICES``/``WCHOICES`` are block-native (``block_size=None`` means
    128), accept ``sources > 1``, and take ``hh`` (an ``HHPolicy``) to
    override their knobs; every other scheme rejects ``hh``.

    ``engine`` selects the block engine of the PoRC family's block and
    multi-source paths: "ref" (plain torch, the default), "cuda" (the
    kernels), "auto" (follows the device) or "strict" (the
    rank-sequential engine, PORC only; its kernel on the card). The
    sequential oracles and the other schemes reject a non-"ref" engine.
    """
    scheme = scheme.upper()
    if sources > 1 and scheme not in ("PORC", "KG", "SG") + HH_SCHEMES:
        raise ValueError(f"scheme {scheme!r} has no multi-source variant")
    if hh is not None and scheme not in HH_SCHEMES:
        raise ValueError(f"scheme {scheme!r} takes no heavy-hitter policy")
    if engine != "ref" and scheme not in ("PORC",) + HH_SCHEMES:
        raise ValueError(f"scheme {scheme!r} has no kernel engine variant")
    if engine != "ref" and scheme == "PORC" and not (block_size
                                                     or sources > 1):
        raise ValueError("engine applies to the block path — pass "
                         "block_size (the sequential oracle is plain only)")
    keys = torch.as_tensor(keys).to(resolve_device(device))
    dev = keys.device
    if scheme in HH_SCHEMES:
        from repro_torch.kernels.ref import HHPolicy
        letter = "d" if scheme == "DCHOICES" else "w"
        if sources > 1:
            policy = (HHPolicy(scheme=letter) if hh is None
                      else hh._replace(scheme=letter))
            return power_of_random_choices_multisource(
                keys, n_bins, sources, eps=eps, block=block_size or 128,
                sync_every=sync_every, hh=policy, engine=engine, device=dev)
        return _hh_choices(keys, n_bins, letter, eps, block_size or 128, hh,
                           engine, dev)
    if scheme == "KG":
        return key_grouping(keys, n_bins)
    if scheme == "SG":
        return shuffle_grouping(keys, n_bins)
    if scheme == "PKG":
        if block_size:
            return partial_key_grouping_blocked(keys, n_bins,
                                                block=block_size, device=dev)
        return partial_key_grouping(keys, n_bins, device=dev)
    if scheme == "POTC":
        if block_size:
            return power_of_two_choices_blocked(keys, n_bins,
                                                block=block_size, device=dev)
        return power_of_two_choices(keys, n_bins, device=dev)
    if scheme == "PORC":
        if sources > 1:
            return power_of_random_choices_multisource(
                keys, n_bins, sources, eps=eps, block=block_size or 128,
                sync_every=sync_every, engine=engine, device=dev)
        if block_size:
            return power_of_random_choices_blocked(
                keys, n_bins, eps=eps, block=block_size, engine=engine,
                device=dev)
        return power_of_random_choices(keys, n_bins, eps=eps, device=dev)
    if scheme == "CH":
        return consistent_hashing_bounded(keys, n_bins, eps=eps, device=dev)
    raise ValueError(f"unknown scheme {scheme!r}")


ALL_SCHEMES = ("KG", "SG", "PKG", "POTC", "CH", "PORC")
BLOCKED_SCHEMES = ("PKG", "POTC", "PORC")
HH_SCHEMES = ("DCHOICES", "WCHOICES")
