#!/usr/bin/env python3
"""The MoE train step on a token stream, at several peak lrs, on one
CUDA device: what the loss of ``chip_smoke.py``'s (t) says.

    python3 tools/moe_stream_torch.py [--lrs 3e-4,3e-5,1e-5] [--out F]

The model is (t)'s: qwen3-moe-235b-a22b at full width, 1 of 94 layers,
router "cg", random bf16 weights from seed 0, remat "full", grad_accum
8; step i trains on ``ShardedTokenPipeline(PipelineConfig(vocab,
seq_len=1,024, global_batch=8, n_hosts=4)).global_batch(i)``. First, at
the initial weights, the cross-entropy of batches 0–7 and of each
sequence of batch 0 (how far a batch's loss moves with the batch
alone). Then for each peak lr, from the same initial weights: 5 AdamW
steps (warm-up 2, as in (t)), each step's train loss (the cross-entropy
plus the routers' load-balance and z terms) and ``moe_drop_frac``, and
the cross-entropy and drop of a held-out set (batches 100–103, never
trained on) before the first step and after every step. Prints one JSON
line (the card with its power limit); ``--out`` also writes it there.
Imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lrs", default="3e-4,3e-5,1e-5",
                    help="peak lrs, comma-separated")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import chip_smoke      # puts this checkout's src on the path first
    import torch
    if not torch.cuda.is_available():
        print("moe_stream_torch: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch import optim
    from repro_torch.data import PipelineConfig, ShardedTokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import moe_transformer as mt
    from repro_torch.models.lm_common import (chunked_xent, embed_tokens,
                                              shift_labels)
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False      # as chip_smoke.py
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    chip_smoke.build_all(["cg_dispatch"])
    cfg = chip_smoke.moe_config(1)
    pipe = ShardedTokenPipeline(PipelineConfig(
        vocab=cfg.vocab, seq_len=1024, global_batch=8, n_hosts=4))

    def batch(i):
        return pipe.global_batch(i).to(dev)

    @torch.no_grad()
    def evaluate(model, tokens) -> tuple[float, float]:
        """(cross-entropy, drop_frac) of ``tokens`` [B, S]."""
        x = embed_tokens(model.embed, tokens, cfg.d_model)
        B, S = tokens.shape
        positions = torch.arange(S, device=dev).expand(B, S)
        x, _, _, rm = mt.hidden_states(model, cfg, x, positions)
        ce = chunked_xent(x, model.embed, shift_labels(tokens))
        return float(ce), float(rm["drop_frac"])

    out = dict(card=card, arch=cfg.arch_id, n_layers=cfg.n_layers,
               batch=[8, 1024], held_out=[100, 101, 102, 103])
    model = zoo.init_params(cfg, 0, device=dev)
    out["init_ce_by_batch"] = [evaluate(model, batch(i))[0]
                               for i in range(8)]
    first = batch(0)
    out["init_ce_by_sequence"] = [evaluate(model, first[j:j + 1])[0]
                                  for j in range(first.shape[0])]
    print(f"initial weights: cross-entropy of batches 0-7 "
          f"{out['init_ce_by_batch']}, of batch 0's sequences "
          f"{out['init_ce_by_sequence']}", flush=True)
    del model
    held = [batch(i) for i in out["held_out"]]
    out["runs"] = []
    for lr in (float(x) for x in args.lrs.split(",")):
        gc.collect()
        torch.cuda.empty_cache()
        model = zoo.init_params(cfg, 0, device=dev)
        state = optim.init(model)
        step = make_train_step(cfg, optim.AdamWConfig(
            lr_peak=lr, warmup_steps=2, total_steps=args.steps))

        def held_out():
            ce, drop = zip(*(evaluate(model, h) for h in held))
            return sum(ce) / len(ce), sum(drop) / len(drop)

        ce0, drop0 = held_out()
        run = dict(lr_peak=lr, held_out_ce_before=ce0,
                   held_out_drop_before=drop0, steps=[])
        for i in range(args.steps):
            model, state, m = step(model, state, {"tokens": batch(i)})
            ce, drop = held_out()
            run["steps"].append(dict(
                step=i + 1, lr=float(m["lr"]), loss=float(m["loss"]),
                grad_norm=float(m["grad_norm"]),
                drop_frac=float(m["moe_drop_frac"]), held_out_ce=ce,
                held_out_drop=drop))
            print(f"lr_peak {lr:g} step {i + 1}: {run['steps'][-1]}",
                  flush=True)
        out["runs"].append(run)
        del model, state, step
    line = json.dumps(out)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
