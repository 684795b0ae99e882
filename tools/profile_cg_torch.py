#!/usr/bin/env python3
"""Where the time of the port's ``cg.run`` goes, on one CUDA device.

    python3 tools/profile_cg_torch.py [--slots 200] [--out profile.json]

Runs four main-path configurations of ``chip_smoke.py`` (the paper's
setup at block 128, single-source kernel; the same with
``engine="strict"``, the rank-sequential ``porc_assign`` kernel; the Fig
14/15 deployment with 8 sources, multi-source kernel; the same
deployment with W-Choices, the HHPolicy kernel) over a window of
``--slots`` slots, after one warm-up slot:
- once without the profiler: wall time, messages/s, host ms per slot;
- once under ``torch.profiler``: the device's busy share (kernel time
  over wall time), kernel launches per slot, and the ops that take the
  most host time and the most device time.

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


def configs():
    """(name, CGConfig, capacities, trace spec) of the main paths."""
    import chip_smoke
    from repro_torch.configs.paper_stream import PAPER_CG
    caps_a = chip_smoke.paper_caps()
    cfg_b, caps_b, _ = chip_smoke.deployment_config()
    return [("paper_wp_block128", PAPER_CG._replace(block_size=128,
                                                    engine="auto"),
             caps_a, chip_smoke.WP_TABLE1),
            ("paper_wp_block128_strict",
             PAPER_CG._replace(block_size=128, engine="strict"), caps_a,
             chip_smoke.WP_TABLE1),
            ("deployment_tw_sources8", cfg_b, caps_b, chip_smoke.TW_TABLE1),
            ("deployment_tw_sources8_wchoices",
             cfg_b._replace(hh_scheme="WCHOICES"), caps_b,
             chip_smoke.TW_TABLE1)]


def profile(name, cfg, caps, spec, slots: int, seed: int, dev) -> dict:
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    import chip_smoke
    from repro_torch.core import cg
    m = (slots + 1) * cfg.slot_len
    keys = chip_smoke.sample(spec, seed, m, dev)
    warm = cg.run(cfg, keys[: cfg.slot_len], caps, device=dev)
    rest = keys[cfg.slot_len:]

    def window():
        cg.run(cfg, rest, caps, state=warm.state, device=dev)
        torch.cuda.synchronize(dev)

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    window()
    wall = time.perf_counter() - t0
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window()
        wall_prof = time.perf_counter() - t0
    avgs = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in avgs)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    top_host = sorted(avgs, key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:12]
    top_dev = sorted(avgs, key=lambda e: e.self_device_time_total,
                     reverse=True)[:8]
    out = dict(
        run=name, slots=slots, messages=slots * cfg.slot_len,
        wall_s=wall, msgs_per_s=slots * cfg.slot_len / wall,
        host_ms_per_slot=wall / slots * 1e3,
        profiled_wall_s=wall_prof,
        device_busy_share=(device_us / 1e6 / wall_prof
                           if device_us else None),
        device_kernels_per_slot=len(kernels) / slots,
        top_host_ops=[(e.key, e.count, e.self_cpu_time_total / 1e3)
                      for e in top_host],
        top_device_ops=[(e.key, e.count, e.self_device_time_total / 1e3)
                        for e in top_dev])
    print(f"{name}: {out['messages']} msgs in {wall:.3f} s = "
          f"{out['msgs_per_s']:,.0f} msgs/s, host {out['host_ms_per_slot']:.3f}"
          f" ms/slot; profiled: device busy "
          f"{out['device_busy_share']}, {out['device_kernels_per_slot']:.1f}"
          " kernels/slot", flush=True)
    print("  top host ops (name, calls, self ms):", flush=True)
    for row in out["top_host_ops"]:
        print(f"    {row[0]:<40} {row[1]:>7} {row[2]:10.2f}", flush=True)
    print("  top device ops (name, calls, self ms):", flush=True)
    for row in out["top_device_ops"]:
        print(f"    {row[0][:60]:<60} {row[1]:>7} {row[2]:10.2f}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slots", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_cg_torch: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    print(torch.cuda.get_device_name(0), flush=True)
    runs = [profile(*c, slots=args.slots, seed=args.seed, dev=dev)
            for c in configs()]
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
