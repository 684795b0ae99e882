#!/usr/bin/env python3
"""Time both branches of ``porc_multisource_scan`` of one source tree on
one CUDA device.

    python3 tools/bench_multisource_torch.py [--src DIR] [--seed 0]

Builds ``porc_snapshot.cu`` of the package under ``--src`` (default:
this checkout's ``src``) and times 50 launches each
(``chip_smoke.time_ms``), from the state that ten slots of the same
stream leave:
- phase 3's shape for both branches: 4 steps of 8 sources × 128 keys
  over 480 bins, sync 1 (the HHPolicy branch W-Choices, chain 480, on a
  TW-profile stream; the policy-free branch on WP);
- the five spans of one (c) slot (5,000 messages over 8 sources: 512,
  64, 32, 16 and 1 per source), per span and summed per slot, both
  branches;
- Fig 11's shape: 100 sources × 1,000 bins, block 128, 10 steps, sync 1
  (policy-free);
- a split of the time at phase 3's shape: the 4-step span with sync 1
  against no merge inside it (sync every 10^6 steps), and 1 step
  against 4 steps, which separates the fixed, per-step and merge cost;
- end to end, ``chip_smoke.fig11_path``: (g) ``partitioners.route``
  at the Fig 11 point on 22M WP messages, strict and auto (messages/s,
  max VW load, imbalance over workers).
Prints one JSON line: per shape the pair [the kernel's own device time
per launch (``torch.profiler``), the time per call between CUDA events
(host issue included)], and (g)'s results.

To compare two trees, run it once per tree in one machine, in turns:
``git archive`` the other commit into an ignored directory and pass its
``src`` (parent, change, change, parent). Imports nothing of the JAX
package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import chip_smoke      # puts this checkout's src on the path first
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("bench_multisource_torch: CUDA is not available",
              file=sys.stderr)
        return 2
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != args.src.resolve():
        raise SystemExit(f"imported {repro_torch.__file__}, not --src")
    from repro_torch.kernels.blocks import HHPolicy
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    wp = chip_smoke.sample(chip_smoke.WP_TABLE1, args.seed,
                           chip_smoke.WP_TABLE1["n_messages"], dev)
    tw = chip_smoke.sample(chip_smoke.TW_TABLE1, args.seed + 1, 100_000,
                           dev)
    pol = HHPolicy(scheme="w")
    warm = 50_000                               # ten 5,000-message slots

    def ms(keys, n, S, block, steps, p=None, sync=1, warm_n=warm):
        t = chip_smoke.time_ms(keys, dev, n, S, block, steps, p, sync,
                               warm_n, plain=False)
        return [t["device_ms"], t["ms"]]

    # each time: [kernel device ms per launch, ms per call between CUDA
    # events (host issue included)]
    out = {"src": str(args.src), "card": card}
    for branch, keys, p in (("hh", tw, pol), ("plain", wp, None)):
        spans = chip_smoke.time_slot_spans(keys, dev, 480, 8, 5_000, 128, p)
        out[branch] = dict(
            phase3_4steps=ms(keys, 480, 8, 128, 4, p),
            slot_spans=[[t["device_ms"], t["ms"]] for t in spans["spans"]],
            slot_ms=[spans["device_ms"], spans["ms"]],
            one_step=ms(keys, 480, 8, 128, 1, p),
            four_steps_no_merge=ms(keys, 480, 8, 128, 4, p, sync=10**6))
    out["fig11_10steps"] = ms(wp, 1000, 100, 128, 10, warm_n=1_280_000)
    out["fig11_route"] = {
        r["run"]: {k: r[k] for k in ("seconds", "msgs_per_s", "max_vw_load",
                                     "imbalance_workers", "memory_vws")}
        for r in chip_smoke.fig11_path(dev, wp)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
