#!/usr/bin/env python3
"""Time gemma3-1b's decode caches of one source tree on one CUDA device.

    python3 tools/bench_decode_cache_torch.py [--src DIR] [--seed 0]

Runs ``chip_smoke.py``'s phase-12 gemma3-1b path (``dense_path`` with
``ring=RING``) on the package under ``--src`` (default: this checkout's
``src``), at full size with random bf16 weights: prefill 8 × 1,024 and
32 decode steps; (v2) 64 ring-buffer decode steps at 8 × 131,072
against 8 of the uniform cache of the same length; then the ring past
its wrap at B 1 (``ring_wrap``). Prints one JSON line: the card, decode
ms/step, and per cache its ms/step and peak device memory, with the
ring's errors against the uniform decode.

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
        print("bench_decode_cache_torch: CUDA is not available",
              file=sys.stderr)
        return 2
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != args.src.resolve():
        raise SystemExit(f"imported {repro_torch.__file__}, not --src")
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    o = chip_smoke.dense_path(dev, args.seed, "gemma3-1b",
                              **chip_smoke.DENSE_RUNS["gemma3-1b"],
                              ring=chip_smoke.RING)
    caches = {kind: {k: o["ring"][kind][k]
                     for k in ("ms_mean", "ms_median", "peak_gb",
                               "cache_gb")}
              for kind in ("ring", "uniform")}
    print(json.dumps(dict(
        src=str(args.src), card=card,
        decode_ms_mean=o["run"]["decode_ms_mean"], peak_gb=o["peak_gb"],
        caches=caches, ring_max_rel_err=o["ring"]["max_rel_err"],
        wrap=o["ring_wrap"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
