#!/usr/bin/env python3
"""Time the strict kernels of one source tree on one CUDA device.

    python3 tools/bench_strict_torch.py [--src DIR] [--seed 0]

Builds ``porc_assign.cu`` of the package under ``--src`` (default: this
checkout's ``src``) and times ``porc_assign`` and
``porc_multisource_strict`` at ``chip_smoke.py``'s phase-3 shapes
(``time_assign``: 10,000-message slots, 100 bins, block 128, from a
state warmed by ten slots; ``time_multisource_strict``: 10 steps of 100
sources × 1,000 bins, block 128, sync 1) on the first 1.5M messages of a
WP-profile stream. Prints one JSON line: per kernel ms per launch, the
ranks the plain engine walks for the same input, and ns per rank.

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
        print("bench_strict_torch: CUDA is not available", file=sys.stderr)
        return 2
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != args.src.resolve():
        raise SystemExit(f"imported {repro_torch.__file__}, not --src")
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    keys = chip_smoke.sample(chip_smoke.WP_TABLE1, args.seed, 1_500_000, dev)
    out = {"src": str(args.src), "card": card}
    for name, t in (
            ("porc_assign", chip_smoke.time_assign(keys, dev, n=100,
                                                   slot=10_000, block=128)),
            ("porc_multisource_strict", chip_smoke.time_multisource_strict(
                keys, dev, n=1000, S=100, steps=10, block=128))):
        out[name] = dict(shape=t["shape"], ms=t["ms"], ranks=t["ranks"],
                         blocks=t["blocks"], ns_per_rank=t["ms"] * 1e6
                         / t["ranks"], ranks_per_block=t["ranks_per_block"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
