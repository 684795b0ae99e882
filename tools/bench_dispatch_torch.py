#!/usr/bin/env python3
"""Time ``cg_dispatch`` of one source tree on one CUDA device, at the MoE
path's launch shapes.

    python3 tools/bench_dispatch_torch.py [--src DIR] [--reps 3]

Builds ``cg_dispatch.cu`` of the package under ``--src`` (default: this
checkout's ``src``) and times it with ``chip_smoke.time_dispatch`` at
qwen3-moe-235b-a22b's shapes (E=128, k=8, D=12): prefill, G=8 groups ×
T=1,024 tokens in blocks of 128, and decode, G=1 × T=8, each with the
router's uniform capacities and with those of ``capacity_skew=3.0``, on
router-like inputs made on the card, with the kernel the plan picks and,
for a tree that has two, the other one too. Prints one JSON line:
per shape ``--reps`` pairs [the kernel's own device time per launch
(``torch.profiler``), the time per call between CUDA events (host issue
included)], and the card with its power limit.

With ``--ranks`` it instead times what one rank costs: G=8 × T=1,024
over E=128 with capacities so large that no bid is refused, so a block
routes in k ranks and stops at the next, for k = 1, 2, 4, 8, blocks of
32 and 128, each kernel; it prints the device µs per launch and the
least-squares µs per rank and µs per launch beyond the ranks.

To compare two trees, run it once per tree in one machine, in turns:
``git archive`` the other commit into an ignored directory and pass its
``src`` (parent, change, change, parent). Imports nothing of the JAX
package.
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = (("prefill", 8, 1024), ("decode", 1, 8))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--reps", type=int, default=3,
                    help="timings of each shape, each over 50 launches")
    ap.add_argument("--ranks", action="store_true",
                    help="time the cost of a rank instead")
    args = ap.parse_args()
    import chip_smoke      # puts this checkout's src on the path first
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("bench_dispatch_torch: CUDA is not available", file=sys.stderr)
        return 2
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != args.src.resolve():
        raise SystemExit(f"imported {repro_torch.__file__}, not --src")
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    # the module (repro_torch.kernels exports a function of its name)
    wrapper = importlib.import_module("repro_torch.kernels.cg_dispatch")
    # a tree with both kernels times the planned one and the other; an
    # older tree its only kernel
    both = "kernel" in inspect.signature(wrapper.cg_dispatch).parameters
    if args.ranks:
        return rank_costs(chip_smoke, wrapper, dev, card)
    out = {}
    for label, G, T in SHAPES:
        kernels = [None]
        if both:
            planned = wrapper.dispatch_plan(128, min(128, T), 12, 8)[0]
            kernels = [planned, "warp" if planned == "cta" else "cta"]
        for caps, kernel in ((c, k) for c in ("uniform", "skewed")
                             for k in kernels):
            runs = [chip_smoke.time_dispatch(dev, G, T,
                                             skewed_caps=caps == "skewed",
                                             plain=False, kernel=kernel)
                    for _ in range(args.reps)]
            name = f"{label} G={G} T={T} {caps}" + (
                "" if kernel is None else f" {kernel} kernel" + (
                    " (planned)" if kernel == kernels[0] else ""))
            out[name] = [[t["device_ms"], t["ms"]] for t in runs]
            t = runs[0]
            print(f"{name} ({t['shape']}, {t['bids']} bids, drop "
                  f"frac {t['drop_frac']:.4f}): device ms "
                  + ", ".join(f"{r['device_ms']:.5f}" for r in runs)
                  + "; CUDA-event ms "
                  + ", ".join(f"{r['ms']:.5f}" for r in runs), flush=True)
    print(json.dumps({"src": str(args.src), "card": card,
                      "cg_dispatch": out}), flush=True)
    return 0


def rank_costs(chip_smoke, wrapper, dev, card) -> int:
    """Device µs of a launch at k = 1, 2, 4, 8 with no bid refused; a
    straight line through (ranks, µs) per kernel and block."""
    G, T, E, D = 8, 1024, 128, 12
    pref, gates = chip_smoke.dispatch_inputs(G, T, E, D, 0.0, dev, seed=99)
    out = {}
    for kernel in ("cta", "warp"):
        for block in (32, 128):
            pts = []
            for k in (1, 2, 4, 8):
                args = dict(n_experts=E, k=k, block=block,
                            capacity=10**6, kernel=kernel)
                us = 1e3 * chip_smoke.kernel_ms(
                    lambda: wrapper.cg_dispatch(pref, gates, **args), 30,
                    "cg_dispatch_kernel")
                pts.append((T // block * (k + 1), us))
            n = len(pts)
            mx = sum(x for x, _ in pts) / n
            my = sum(y for _, y in pts) / n
            slope = (sum((x - mx) * (y - my) for x, y in pts)
                     / sum((x - mx) ** 2 for x, _ in pts))
            name = f"{kernel} kernel, blocks of {block}"
            out[name] = dict(points=pts, us_per_rank=slope,
                             us_fixed=my - slope * mx)
            print(f"{name}: " + ", ".join(f"{r} ranks {u:.2f} us"
                                          for r, u in pts)
                  + f"; {slope:.3f} us a rank + {my - slope * mx:.2f} us",
                  flush=True)
    print(json.dumps({"card": card, "rank_costs": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
