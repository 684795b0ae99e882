#!/usr/bin/env python3
"""Time ``porc_snapshot`` and ``ssd_scan`` of one source tree on one CUDA
device, at the main path's launch shapes.

    python3 tools/bench_snapshot_ssd_torch.py [--src DIR] [--seed 0]

Builds ``porc_snapshot.cu`` and ``ssd_scan.cu`` of the package under
``--src`` (default: this checkout's ``src``) and times, with
``chip_smoke.time_snapshot`` and ``chip_smoke.time_ssd``:
- ``porc_snapshot`` at the three shapes of (a)'s slots over 100 bins,
  each from the state that ten slots leave: 78 blocks of 128 keys, the
  slot's 16-key tail, and a block-1 slot of 10,000 keys;
- ``ssd_scan`` in bf16 with the final state at zamba2-2.7b's 8 × 1,024
  and 8 × 4,096 prefills and mamba2-130m's 8 × 4,096;
- ``ssd_scan_bwd`` in bf16 at phase 9's training shapes, zamba2-2.7b on
  8 × 1,024 and 2 × 4,096 tokens and mamba2-130m on 8 × 4,096
  (``chip_smoke.time_ssd_bwd``): its device time a call is the sum over
  every kernel the call launches, so trees that split the backward into
  different kernels are counted alike.
With ``--e2e`` also the main paths that run them: (a) ``cg.run`` at
block 128 on 22M WP messages and at block 1 on the 2.2M prefix
(messages/s, imbalance of the first and last three slots, moves), the
prefills of phase 7 with random bf16 weights: zamba2-2.7b on 8 ×
1,024 and 8 × 4,096 tokens, mamba2-130m on 8 × 4,096 (tokens/s, after a
warm-up of the same shape), with phase 7's prefill(prompt[:-1]) +
decode(last) against prefill(prompt) gap at (k)'s and (l)'s shapes, and
phase 9's train steps (``chip_smoke.ssm_train_path``): (q) mamba2-130m,
5 steps of 8 × 4,096, and (r) zamba2-2.7b, 5 steps of 8 × 1,024 and one
of 2 × 4,096 (per step ms, tokens/s and loss; the mean of the steady
steps and the peak device memory). Prints one JSON line: per shape the
pair [the kernels' own device time per call (``torch.profiler``), the
time per call between CUDA events (host issue included)], for
``ssd_scan`` and ``ssd_scan_bwd`` followed by the CTAs an SM holds (the
occupancy calculator; null for a tree without it), the end-to-end
results, and the card with its power limit.

To compare two trees, run it once per tree in one machine, in turns:
``git archive`` the other commit into an ignored directory and pass its
``src`` (parent, change, change, parent). Imports nothing of the JAX
package.
"""
from __future__ import annotations

import argparse
import collections
import importlib
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
    ap.add_argument("--e2e", action="store_true",
                    help="also (a)'s cg.run, the Mamba-2 prefills and "
                         "phase 9's train steps")
    args = ap.parse_args()
    import chip_smoke      # puts this checkout's src on the path first
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("bench_snapshot_ssd_torch: CUDA is not available",
              file=sys.stderr)
        return 2
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != args.src.resolve():
        raise SystemExit(f"imported {repro_torch.__file__}, not --src")
    # the module (repro_torch.kernels exports a function of its name)
    ssd_module = importlib.import_module("repro_torch.kernels.ssd_scan")
    for name in ("resident_ctas", "ctas_per_sm", "bwd_resident_ctas"):
        if not hasattr(ssd_module, name):
            # a tree from before the SSD kernel's sizing functions
            setattr(ssd_module, name, lambda *args, **kwargs: None)
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    wp = chip_smoke.sample(chip_smoke.WP_TABLE1, args.seed, 200_000, dev)

    def pair(t: dict) -> list:
        return [t["device_ms"], t["ms"]]

    def ssd_row(t: dict) -> list:
        return pair(t) + [t["ctas_per_sm"]]

    out = {"src": str(args.src), "card": card}
    snap = chip_smoke.time_snapshot
    out["porc_snapshot"] = {
        "78x128": pair(snap(wp, dev, 100, 9_984, 128, warm=100_000,
                            plain=False)),
        "tail16": pair(snap(wp, dev, 100, 16, 16, warm=109_984,
                            plain=False)),
        "10000x1": pair(snap(wp, dev, 100, 10_000, 1, warm=100_000,
                             warm_block=1, plain=False))}
    zamba2, mamba2 = chip_smoke.ssd_model_shapes()
    ssd = chip_smoke.time_ssd
    out["ssd_scan"] = {
        "zamba2 8x1024": ssd_row(ssd(dev, *zamba2, plain=False)),
        "zamba2 8x4096": ssd_row(ssd(dev, *zamba2[:2], 4096, *zamba2[3:],
                                     plain=False)),
        "mamba2 8x4096": ssd_row(ssd(dev, *mamba2, plain=False))}
    out["ssd_scan_bwd"] = {
        f"{arch.split('-')[0]} {B}x{L}": ssd_row(chip_smoke.time_ssd_bwd(
            dev, arch, B, L, *rest, plain=False))
        for arch, B, L, *rest in chip_smoke.ssd_train_shapes()}
    if args.e2e:
        out["e2e"] = end_to_end(chip_smoke, dev, args.seed)
    print(json.dumps(out), flush=True)
    return 0


def end_to_end(chip_smoke, dev, seed: int) -> dict:
    """(a)'s two ``cg.run``s and the three Mamba-2 prefills."""
    import torch
    from repro_torch import configs
    from repro_torch.configs.paper_stream import PAPER_CG
    from repro_torch.kernels.porc_snapshot import porc_snapshot
    from repro_torch.models import model_zoo as zoo
    if not hasattr(porc_snapshot, "blocks"):
        # a tree from before the per-block launch counter
        porc_snapshot.blocks = collections.Counter()
    out = {}
    wp = chip_smoke.sample(chip_smoke.WP_TABLE1, seed,
                           chip_smoke.WP_TABLE1["n_messages"], dev)
    caps = chip_smoke.paper_caps()
    frac = caps / caps.max()
    slot = PAPER_CG.slot_len
    m = wp.shape[0] // slot * slot
    for block, n in ((128, m), (1, m // 10 // slot * slot)):
        cfg = PAPER_CG._replace(block_size=block, engine="auto")
        run, _ = chip_smoke.run_cg(f"paper_wp_block{block}", cfg, wp[:n],
                                   caps, frac, dev, "porc_snapshot")
        out[f"a_block{block}"] = {k: run[k] for k in (
            "messages", "msgs_per_s", "imbalance_first3", "imbalance_last3",
            "moves")}
    del wp
    for arch, seq in (("zamba2-2.7b", 1024), ("zamba2-2.7b", 4096),
                      ("mamba2-130m", 4096)):
        cfg = configs.get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = zoo.init_params(cfg, gen, device=dev)
        tokens = torch.randint(0, cfg.vocab, (8, seq), generator=gen,
                               device=dev, dtype=torch.int32)
        zoo.prefill_step(model, cfg, {"tokens": tokens})      # warm-up
        run = chip_smoke.timed_run(f"{arch} 8x{seq}", model, cfg, tokens,
                                   0, dev)
        out[f"{arch} 8x{seq}"] = run["prefill_tokens_per_s"]
        if seq == chip_smoke.SSM_PROMPTS[arch]:
            out[f"{arch} 8x{seq} gap"] = chip_smoke.prefill_decode_gap(
                model, cfg, tokens)
        del model
        torch.cuda.empty_cache()
    # phase 9's train steps: (q), then (r) and its 2 × 4,096 step
    for arch, B, S, long in (("mamba2-130m", 8, 4096, None),
                             ("zamba2-2.7b", 8, 1024, (2, 4096))):
        run = chip_smoke.ssm_train_path(dev, seed, arch, B, S, long=long)
        for key, part in (("", run["run"]), (" long", run.get("long"))):
            if part is not None:
                out[f"{arch} train {part['batch'][0]}x{part['batch'][1]}"
                    f"{key}"] = dict(
                    steps=[[r["ms"], r["tokens_per_s"], r["loss"]]
                           for r in part["steps"]],
                    step_ms_mean=part["step_ms_mean"],
                    tokens_per_s=part["tokens_per_s"],
                    peak_gb=part["peak_gb"])
    return out


if __name__ == "__main__":
    sys.exit(main())
