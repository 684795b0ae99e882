#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out report.json]

Phases:
  1. device: requires CUDA; prints the card's name and power limit
     (nvidia-smi);
  2. build: compiles the CUDA kernels from the checkout's sources
     (``src/repro_torch/kernels/csrc``) into ``build/repro_torch_kernels/``;
  3. kernels: holds ``porc_snapshot`` and ``porc_multisource_scan``
     against their plain torch versions on the card, bit for bit, on a
     WP-profile stream, and times both at the main path's shapes;
  4. main path: ``cg.run`` with ``engine="auto"`` on the card —
     (a) the paper's simulation setup (10 workers × α=10, ε=0.01, slot
     10,000, y=3 machines 5× faster at ρ=0.8) on a WP stream at Table I
     scale (22M messages, 2.9M keys, p1=9.32%), at block 128 and at
     block 1 on a 2.2M prefix (checked against the per-message oracle);
     (b) the Fig 14/15 deployment (24 workers, α=20, slot 5,000, 16
     moves per slot, two executors at 30%, 8 sources) on a TW-profile
     stream (31M keys, p1=2.67%) cut to 22M messages;
  5. prints the ``{"kernels": [...]}`` line and, last, the device line.

Any mismatch, build failure or launch error exits non-zero. Imports
nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
# The work is int32 hashing and compares; the guide's table of peaks has
# no int32 ALU rate, so operations are held against its nearest entry,
# float32 outside the tensor cores.
OPS_PER_S = 67e12
OPS_PER_PROBE = 24             # two fmix32 rounds + salt mix, mod, compare

WP_TABLE1 = dict(name="WP", n_messages=22_000_000, n_keys=2_900_000,
                 p1=0.0932, z_tail=1.0, diurnal=True)
TW_TABLE1 = dict(name="TW", n_messages=22_000_000, n_keys=31_000_000,
                 p1=0.0267, z_tail=0.8, diurnal=True)


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time per call of ``fn`` over ``reps`` calls (CUDA
    events, after warm-up)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def probes_used(keys, assign, n_bins: int, chunk: int):
    """Probes each key of a block>1 call walked: the first salt whose
    candidate is its assignment, or the whole chunk (fallback)."""
    import torch
    from repro_torch.core.hashing import hash_to_bins
    salts = torch.arange(1, chunk + 1, device=keys.device)
    hit = hash_to_bins(keys[:, None], salts, n_bins) == assign[:, None]
    first = torch.where(hit.any(1), hit.int().argmax(1) + 1,
                        torch.full_like(assign, chunk, dtype=torch.int64))
    return int(first.sum())


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _same(name: str, a, b) -> float:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"{name}: {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    err = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
    if not torch.equal(a, b):
        fail(f"{name}: kernel differs from the plain version "
             f"(max abs err {err})")
    return err


def check_snapshot(keys, dev) -> float:
    """porc_snapshot kernel vs ref_porc_snapshot, bit for bit."""
    import torch
    from repro_torch.kernels import porc_snapshot as ps
    from repro_torch.kernels import ref
    err = 0.0
    cases = [(n, blk) for n in (100, 480, 1000) for blk in (1, 128)]
    cases.append((60_000, 128))          # load beyond shared memory
    for n, blk in cases:
        m = 2_000 if blk == 1 else 128 * 200
        k = keys[:m].contiguous()
        # direct call with a load0/m0 continuation
        load0 = torch.arange(n, device=dev, dtype=torch.float32) % 7
        m0 = torch.full((), float(load0.sum()), device=dev)
        a_k, l_k = ps.porc_snapshot(k, n, block=blk, eps=0.01, load0=load0,
                                    m0=m0)
        a_p, l_p = ref.ref_porc_snapshot(k, n, block=blk, eps=0.01,
                                         load0=load0, m0=m0)
        err = max(err, _same(f"porc_snapshot n={n} block={blk} assign",
                             a_k, a_p),
                  _same(f"porc_snapshot n={n} block={blk} load", l_k, l_p))
        # span driver: a ragged length, the state carried across calls
        rag = m + 77
        split = (rag // 3) // blk * blk
        out = {}
        for eng in ("cuda", "snapshot"):
            a1, st = ref.ref_porc_route(keys[:split], n, block=blk, eps=0.01,
                                        engine=eng, device=dev)
            a2, st = ref.ref_porc_route(keys[split:rag], n, block=blk,
                                        eps=0.01, state=st, engine=eng,
                                        device=dev)
            out[eng] = (torch.cat([a1, a2]), st.load, st.routed)
        for what, x, y in zip(("assign", "load", "routed"), out["cuda"],
                              out["snapshot"]):
            err = max(err, _same(f"ref_porc_route n={n} block={blk} {what}",
                                 x, y))
        log(f"  porc_snapshot n_bins={n:>6} block={blk:>3}: identical "
            f"({m} + {rag} messages)")
    return err


def check_multisource(keys, dev) -> float:
    """porc_multisource_scan kernel vs _porc_multisource_scan, bit for
    bit, through the span driver with a ragged tail and a state carry."""
    import torch
    from repro_torch.kernels import ref
    err = 0.0
    for S, n in ((1, 100), (8, 480), (100, 1000)):
        for sync in (1, 3):
            m = S * 128 * 5 + S * 77 + (S // 2 if S > 1 else 0)
            split = S * 128 * 2 + S * 3 + (S // 3)
            out = {}
            for eng in ("cuda", "snapshot"):
                a1, st = ref.ref_porc_multisource(
                    keys[:split], n, S, sync_every=sync, block=128, eps=0.01,
                    engine=eng, device=dev)
                a2, st = ref.ref_porc_multisource(
                    keys[split:m], n, S, sync_every=sync, block=128,
                    eps=0.01, state=st, engine=eng, device=dev)
                out[eng] = (torch.cat([a1, a2]), st.base, st.delta,
                            st.routed, st.ticks)
            for what, x, y in zip(("assign", "base", "delta", "routed",
                                   "ticks"), out["cuda"], out["snapshot"]):
                err = max(err, _same(f"multisource S={S} n={n} sync={sync} "
                                     f"{what}", x, y))
            log(f"  porc_multisource_scan S={S:>3} n_bins={n:>5} "
                f"sync={sync}: identical ({m} messages)")
    return err


def time_snapshot(keys, dev, n: int, slot: int, block: int) -> dict:
    """porc_snapshot at the main path's shape: one slot's full blocks."""
    import torch
    from repro_torch.kernels import porc_snapshot as ps
    from repro_torch.kernels import ref
    M = slot // block * block
    k = keys[:M].contiguous()
    load0 = torch.zeros(n, device=dev)
    m0 = torch.zeros((), device=dev)
    ms = cuda_ms(lambda: ps.porc_snapshot(k, n, block=block, eps=0.01,
                                          load0=load0, m0=m0), reps=50)
    plain_ms = cuda_ms(lambda: ref.ref_porc_snapshot(
        k, n, block=block, eps=0.01, load0=load0, m0=m0), reps=3, warmup=1)
    a, _ = ps.porc_snapshot(k, n, block=block, eps=0.01, load0=load0, m0=m0)
    nbytes = 4 * M * 2 + 4 * n * 2 + 4
    ops = probes_used(k, a, n, 8) * OPS_PER_PROBE + M
    return dict(shape=f"M={M} n_bins={n} block={block}", ms=ms,
                plain_ms=plain_ms, bytes=nbytes, ops=ops)


def time_multisource(keys, dev, n: int, S: int, slot: int,
                     block: int) -> dict:
    """porc_multisource_scan at the main path's shape: one slot's span
    of full per-source blocks."""
    import torch
    from repro_torch.kernels import porc_snapshot as ps
    from repro_torch.kernels import ref
    per = slot // S // block * block
    M = per * S
    k = keys[:M].contiguous()
    base0 = torch.zeros(n, device=dev)
    delta0 = torch.zeros((S, n), device=dev)
    ticks0 = torch.zeros((), dtype=torch.int32, device=dev)
    args = (k, n, S, 1, block, 0.01, 8, base0, delta0, ticks0)
    ms = cuda_ms(lambda: ps.porc_multisource_scan(*args), reps=50)
    plain_ms = cuda_ms(lambda: ref._porc_multisource_scan(
        *args[:7], "snapshot", *args[7:]), reps=3, warmup=1)
    a = ps.porc_multisource_scan(*args)[0]
    steps = M // (S * block)
    nbytes = 4 * M * 2 + 4 * n * 2 + 4 * S * n * 2 + 8
    ops = (probes_used(k, a, n, 8) * OPS_PER_PROBE + M
           + steps * (S + 1) * n * 2)
    return dict(shape=f"M={M} S={S} n_bins={n} block={block}", ms=ms,
                plain_ms=plain_ms, bytes=nbytes, ops=ops)


def bound(t: dict) -> tuple[float, str]:
    by_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
    by_ops = t["ops"] / OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

def run_cg(name: str, cfg, keys, caps, frac, dev, kernel: str,
           check_launches: bool = True):
    """Drive ``cg.run`` once with the launch counts zeroed just before
    and read just after; check and summarize what came out. Returns
    (summary dict, CGResult)."""
    import torch
    from repro_torch.core import cg, partitioners, simulation
    from repro_torch.kernels import porc_snapshot as ps
    ps.porc_snapshot.launches = 0
    ps.porc_multisource_scan.launches = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = cg.run(cfg, keys, caps, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    launches = {"porc_snapshot": ps.porc_snapshot.launches,
                "porc_multisource_scan": ps.porc_multisource_scan.launches}
    if check_launches and launches[kernel] <= 0:
        fail(f"{name}: the main path never launched {kernel}")
    m = keys.shape[0]
    V = cfg.n_workers * cfg.alpha
    owner = res.state.vw_owner
    owned = torch.bincount(owner.long(), minlength=cfg.n_workers)
    conserved = bool(owner.shape[0] == V and int(owner.min()) >= 0
                     and int(owner.max()) < cfg.n_workers
                     and int(owned.sum()) == V)
    if not conserved:
        fail(f"{name}: VW population not conserved")
    if res.assignment.shape != (m,) or int(res.assignment.min()) < 0 \
            or int(res.assignment.max()) >= cfg.n_workers:
        fail(f"{name}: assignment out of range")
    for f in ("imbalance", "mean_latency", "utilization"):
        if not bool(torch.isfinite(getattr(res, f)).all()):
            fail(f"{name}: non-finite {f}")
    if float(res.state.vw_load.double().sum()) != float(m):
        fail(f"{name}: routed load does not add up to the stream")
    # Fig 14/15 analogue on the last third (bench_deployment.py:35-37)
    tail = res.assignment[2 * m // 3:]
    kg = partitioners.key_grouping(keys[2 * m // 3:], cfg.n_workers)
    fr = torch.as_tensor(frac, dtype=torch.float32, device=dev)
    service_ms = 0.5
    offered = float(frac.sum()) / (service_ms * 1e-3) * 0.75
    d_cg = simulation.simulate_deployment(tail, cfg.n_workers, service_ms,
                                          fr, offered)
    d_kg = simulation.simulate_deployment(kg, cfg.n_workers, service_ms,
                                          fr, offered)
    imb = res.imbalance
    out = dict(
        run=name, messages=m, seconds=secs, msgs_per_s=m / secs,
        imbalance_first3=float(imb[:3].mean()),
        imbalance_last3=float(imb[-3:].mean()),
        moves=int(res.moves), vw_conserved=conserved, launches=launches,
        kg_cg_mean_latency_ratio=float(d_kg.mean_latency_ms
                                       / d_cg.mean_latency_ms),
        kg_cg_throughput_ratio=float(d_kg.throughput / d_cg.throughput))
    log(f"  {name}: {m} msgs in {secs:.3f} s = {m / secs:,.0f} msgs/s; "
        f"imbalance first3 {out['imbalance_first3']:.4f} last3 "
        f"{out['imbalance_last3']:.4f}; moves {out['moves']}; VWs conserved "
        f"{conserved}; launches {launches}; KG/CG mean latency "
        f"{out['kg_cg_mean_latency_ratio']:.3f}")
    return out, res


def main_path(dev, seed: int, wp_keys, scale: float = 1.0,
              check_launches: bool = True) -> list[dict]:
    """The two main-path configurations; ``scale`` < 1 cuts the stream
    for a rehearsal on the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_stream import (CPULIMIT_FRACTION, PAPER_CG,
                                                  RHO, STORM_SOURCES,
                                                  STORM_WORKERS)
    from repro_torch.core import cg, streams
    runs = []
    # (a) the paper's simulation setup, heterogeneous y=3 z=5 at rho=0.8
    n = PAPER_CG.n_workers
    caps = streams.heterogeneous_capacities(n, 3, 5.0) / RHO
    frac = caps / caps.max()
    slot = PAPER_CG.slot_len
    m = int(WP_TABLE1["n_messages"] * scale) // slot * slot
    cfg128 = PAPER_CG._replace(block_size=128, engine="auto")
    out, _ = run_cg("paper_wp_block128", cfg128, wp_keys[:m], caps, frac, dev,
                    "porc_snapshot", check_launches)
    runs.append(out)
    m1 = max(m // 10 // slot, 2) * slot
    cfg1 = PAPER_CG._replace(block_size=1, engine="auto")
    out, res1 = run_cg("paper_wp_block1", cfg1, wp_keys[:m1], caps, frac,
                       dev, "porc_snapshot", check_launches)
    # block 1 is bit-identical to PAPER_CG's per-message oracle
    m_or = 2 * slot
    oracle = cg.run(PAPER_CG, wp_keys[:m_or].cpu(), caps, device="cpu")
    same = torch.equal(oracle.vw_assignment, res1.vw_assignment[:m_or].cpu())
    if not same:
        fail("block_size=1 differs from the block_size=0 oracle")
    out["oracle_prefix_identical"] = m_or
    log(f"  paper_wp_block1: first {m_or} messages identical to the "
        "per-message oracle (block_size=0, CPU)")
    runs.append(out)
    del res1, oracle

    # (b) the Fig 14/15 deployment: 24 workers, two executors at 30%
    W = STORM_WORKERS
    frac_b = np.concatenate([[CPULIMIT_FRACTION] * 2, np.ones(W - 2)])
    caps_b = frac_b / frac_b.sum() / RHO
    cfg_b = cg.CGConfig(n_workers=W, alpha=20, eps=0.01, slot_len=5_000,
                        max_moves_per_slot=16, n_sources=STORM_SOURCES,
                        engine="auto")
    mb = int(TW_TABLE1["n_messages"] * scale) // cfg_b.slot_len \
        * cfg_b.slot_len
    tw_keys = sample(TW_TABLE1, seed + 1, mb, dev)
    out, _ = run_cg("deployment_tw_sources8", cfg_b, tw_keys, caps_b, frac_b,
                    dev, "porc_multisource_scan", check_launches)
    runs.append(out)
    return runs


def sample(spec: dict, seed: int, n_messages: int, dev):
    from repro_torch.core import streams
    t0 = time.perf_counter()
    keys = streams.sample_trace(seed, streams.TraceSpec(**spec), n_messages,
                                device=dev)
    log(f"  sampled {n_messages} {spec['name']} messages over "
        f"{spec['n_keys']} keys in {time.perf_counter() - t0:.1f} s")
    return keys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the full report as JSON here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    # 1. device
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log("== device")
    log(card)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")

    # 2. build
    log("== build")
    t0 = time.perf_counter()
    lib = build.build("porc_snapshot")
    build_s = time.perf_counter() - t0
    log(f"  built {lib.relative_to(ROOT)} in {build_s:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            log("  ptxas:", line.strip())

    # 3. kernels vs plain, on the card
    log("== kernels vs plain (bit for bit, WP stream)")
    wp_keys = sample(WP_TABLE1, args.seed, WP_TABLE1["n_messages"], dev)
    err_s = check_snapshot(wp_keys, dev)
    err_m = check_multisource(wp_keys, dev)
    t_s = time_snapshot(wp_keys, dev, n=100, slot=10_000, block=128)
    t_m = time_multisource(wp_keys, dev, n=480, S=8, slot=5_000, block=128)
    for name, t in (("porc_snapshot", t_s), ("porc_multisource_scan", t_m)):
        b, by = bound(t)
        log(f"  {name} at {t['shape']}: kernel {t['ms']:.4f} ms/launch, "
            f"plain {t['plain_ms']:.3f} ms, bound {b:.6f} ms ({by})")

    # 4. the main path
    log("== main path: cg.run(engine='auto')")
    runs = main_path(dev, args.seed, wp_keys)
    launches_s = sum(r["launches"]["porc_snapshot"] for r in runs)
    launches_m = sum(r["launches"]["porc_multisource_scan"] for r in runs)

    # 5. report
    src = "src/repro_torch/kernels/csrc/porc_snapshot.cu"
    kernels = []
    for name, t, err, launches, line in (
            ("porc_snapshot", t_s, err_s, launches_s, 78),
            ("porc_multisource_scan", t_m, err_m, launches_m, 207)):
        b, by = bound(t)
        kernels.append(dict(
            name=name, route="cuda", source=src,
            replaces=f"src/repro/kernels/porc_snapshot.py:{line}",
            launches=launches, max_abs_err=err, ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=b, bound_by=by,
            library_ms=None))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(
            card=card, build_s=build_s, timing=dict(porc_snapshot=t_s,
                                                    porc_multisource_scan=t_m),
            runs=runs, kernels=kernels), indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
