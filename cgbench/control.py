#!/usr/bin/env python3
"""The control of ``correct``, on one CUDA device: a cell run with the
plain reference in the program's place, routing with twice the
configuration's eps (``harness/control.py``), on each of several seeds.
Every run has to come out not correct; it prints each run's numbers
compared and their limits, one JSON line a seed.

    python3 cgbench/control.py --workload storm-tw24.hh --seconds 5 --seeds 11 12 13
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from cgbench.harness.control import ReferenceProgram  # noqa: E402
from cgbench.harness.spec import load_cell  # noqa: E402
from cgbench.run import run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    cell = load_cell(args.workload)
    for seed in args.seeds:
        prog = ReferenceProgram(cell, device, eps_scale=2.0)
        out = run_cell(cell, seed, args.seconds, False, device, program=prog)
        print(json.dumps(dict(workload=cell.name, seed=seed,
                              eps_scale=2.0,
                              correct=out["correct"],
                              attempted=out["attempted"],
                              checks=out["checks"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
