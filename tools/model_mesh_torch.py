#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 14, the model mesh, alone (or some of its
cells), after building the two kernels its paths launch.

    python3 tools/model_mesh_torch.py [a] [b] [c] [d] [--dryrun] [--out F]

(a), (b): the placed train step against the unplaced one on a one-rank
NCCL mesh (gemma3-1b 8 × 1,024, mamba2-130m 8 × 4,096); (c): the
placed prefill and serve steps (qwen3-moe-235b-a22b cut to 1 layer,
gemma3-1b); (d): the 2×2 mesh (gemma3-1b at full width cut to 2
layers, mamba2-130m at full width cut to 2 layers and the MoE's smoke
config), NCCL ranks on a machine with 4 cards or, on one card, the
probe of gloo's DTensor collectives. Without cells, all four.
``--dryrun``: then phase 15, the dry run on fake CUDA tensors (needs
(a) and (b): their real peaks). Prints what the phase prints; with ``--out``, writes
the results there as JSON.

Needs CUDA; imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cells", nargs="*", choices=["a", "b", "c", "d"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("model_mesh_torch: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False      # f32 stays f32
    print(torch.__version__, torch.cuda.get_device_name(0),
          torch.cuda.device_count(), flush=True)
    cs.build_all(["cg_dispatch", "ssd_scan"])
    cells = args.cells or ["a", "b", "c", "d"]
    t0 = time.perf_counter()
    out = cs.model_mesh_phase(dev, args.seed, "".join(cells))
    print(f"phase 14 ({' '.join(cells)}) took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.dryrun:
        t0 = time.perf_counter()
        out["dryrun"] = cs.dryrun_phase(dev, out)
        print(f"phase 15 took {time.perf_counter() - t0:.1f} s", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
