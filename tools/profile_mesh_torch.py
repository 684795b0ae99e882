#!/usr/bin/env python3
"""Where the time of the mesh route goes, on one CUDA device.

    python3 tools/profile_mesh_torch.py [--ranks 8] [--sync 1] [--out F]

Routes ``chip_smoke.py``'s demo stream (``MESH_DEMO``: 2^21 + 7
zipf(1.2) keys, 8,192 bins, block 2,048, 8 sources) through
``kernels.mesh.mesh_porc_multisource`` twice:
- on one rank over NCCL in this process;
- on ``--ranks`` ranks on this card over gloo (``spawn_ranks``), each
  in its own process;
each time three calls without the profiler (wall ms a call, after a
warm-up call), then one under ``torch.profiler``: the device time of
the call's kernels, the device's busy share (device time over the
unprofiled wall time) and the ops that take the most host time. For
the ranks also the seconds from the spawn to each rank's program. The
ranks share one card, so their figures are no scale-out figures.

Needs CUDA; imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def split(mesh, sync_every: int) -> dict:
    """The demo route on ``mesh``: wall ms a call (3 calls after a warm
    one), then one call profiled. Rank 0 also returns the top host ops."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke
    from repro_torch.kernels.mesh import mesh_porc_multisource
    d = chip_smoke.MESH_DEMO
    keys = torch.from_numpy(chip_smoke.mesh_demo_keys(0, d["M"])).to(
        mesh.device)
    kw = dict(n_sources=d["n_sources"], sync_every=sync_every,
              block=d["block"], chunk=d["chunk"], eps=d["eps"])

    def call():
        mesh_porc_multisource(keys, d["n_bins"], mesh, **kw)
        torch.cuda.synchronize(mesh.device)
        dist.barrier(group=mesh.group)

    call()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        call()
        walls.append((time.perf_counter() - t0) * 1e3)
    mesh.collectives.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
    ev = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in ev) / 1e3
    kernels = {e.key: e.self_device_time_total / 1e3 for e in ev
               if e.self_device_time_total > 0}
    host = sorted(((e.key, e.cpu_time_total / 1e3, e.count) for e in ev),
                  key=lambda x: -x[1])[:10]
    wall = float(np.median(walls))
    return dict(wall_ms=wall, walls_ms=walls, device_ms=device_ms,
                busy=device_ms / wall,
                collectives=dict(mesh.collectives),
                kernels=dict(sorted(kernels.items(), key=lambda x: -x[1])[:5]),
                host_ms=host if mesh.index == 0 else None)


def _timed_rank(mesh, t_spawn: float, sync_every: int) -> dict:
    """``split`` on a spawned rank, with the seconds from the spawn to
    this program."""
    started = time.time() - t_spawn
    out = split(mesh, sync_every)
    out["started_s"] = started
    return out


def show(title: str, r: dict) -> None:
    print(f"{title}: {r['wall_ms']:.1f} ms a call (calls "
          f"{', '.join(f'{w:.1f}' for w in r['walls_ms'])}), device "
          f"{r['device_ms']:.3f} ms, busy {r['busy']:.4f}, collectives "
          f"{r['collectives']}", flush=True)
    for k, v in r["kernels"].items():
        print(f"  device {v:.3f} ms  {k[:80]}")
    for k, ms, n in r["host_ms"] or []:
        print(f"  host {ms:.3f} ms  {n:>5} calls  {k[:80]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--sync", type=int, default=1)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import subprocess
    import torch
    if not torch.cuda.is_available():
        print("profile_mesh_torch: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.launch.mesh import make_source_mesh, spawn_ranks
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda:0")
    chip_smoke.build_all(["porc_snapshot"])
    mesh = make_source_mesh(backend="nccl", device=dev)
    try:
        one = split(mesh, args.sync)
    finally:
        mesh.close()
    show(f"1 rank (nccl), sync {args.sync}", one)
    t0 = time.time()
    ranks = spawn_ranks(_timed_rank, args.ranks, t0, args.sync,
                        backend="gloo", device=str(dev))
    spawn_s = time.time() - t0
    show(f"rank 0 of {args.ranks} (gloo, one card), sync {args.sync}",
         ranks[0])
    started = ", ".join(f"{r['started_s']:.1f}" for r in ranks)
    walls = ", ".join(f"{r['wall_ms']:.1f}" for r in ranks)
    print(f"{args.ranks} ranks: started after {started} s; wall ms a call "
          f"{walls}; the spawn took {spawn_s:.1f} s", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, one_rank=one,
                                            ranks=ranks, spawn_s=spawn_s),
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
