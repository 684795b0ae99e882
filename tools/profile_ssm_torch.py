#!/usr/bin/env python3
"""Where the time of the port's Mamba-2 serving path goes, on one CUDA
device.

    python3 tools/profile_ssm_torch.py [--arch zamba2-2.7b]
                                      [--decode-steps 8] [--train]
                                      [--out profile.json]

Builds ``chip_smoke.py``'s phase 7 model (``--arch``, zamba2-2.7b or
mamba2-130m, at its full config, random bf16 weights), warms it up,
then for ``prefill_step`` on 8 prompts (1,024 tokens for zamba2-2.7b,
4,096 for mamba2-130m) and for a window of ``--decode-steps``
``decode_step``s at batch 8:
- once without the profiler: wall time;
- once under ``torch.profiler``: the device's busy share (kernel time
  over wall time), kernels per step, the host ops (by input shape) whose
  kernels take the most device time, and the ``ssd_scan`` kernel's
  device time.

With ``--train`` it profiles ``chip_smoke.py``'s phase 9 instead: one
``make_train_step`` step (after two unprofiled ones) on 8 × 1,024
zipf(1.3) tokens for zamba2-2.7b, 8 × 4,096 for mamba2-130m (remat
"full", AdamW), with the device time of the ``ssd_scan`` forward, of
the backward (every kernel ``ssd_scan_bwd`` launches: names holding
"_bwd_") and the top ops.

Needs CUDA; imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2-2.7b",
                    choices=("zamba2-2.7b", "mamba2-130m"))
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--train", action="store_true",
                    help="profile a train step instead of serving")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_ssm_torch: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from profile_moe_torch import profile
    from repro_torch import configs
    from repro_torch.models import model_zoo as zoo
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    chip_smoke.build_all(["ssd_scan"])
    cfg = configs.get_config(args.arch)
    if args.train:
        runs = [train_profile(cfg, args.seed, dev, profile)]
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(dict(
                card=torch.cuda.get_device_name(0), arch=args.arch,
                runs=runs), indent=1))
        return 0
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = zoo.init_params(cfg, gen, device=dev)
    B, S, n = 8, chip_smoke.SSM_PROMPTS[args.arch], args.decode_steps
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev,
                           dtype=torch.int32)
    _, cache = zoo.prefill_step(model, cfg, {"tokens": tokens},
                                pad_to=S + 4 * n)
    tok = tokens[:, :1]

    def prefill():
        zoo.prefill_step(model, cfg, {"tokens": tokens}, pad_to=S + 4 * n)

    def decode():
        c = cache
        for _ in range(n):
            _, c = zoo.decode_step(model, cfg, c, tok)

    decode()                                            # warm-up
    runs = [profile(f"{args.arch} prefill {B}x{S}", prefill, 1, dev,
                    kernel="ssd_scan"),
            profile(f"{args.arch} decode B={B}", decode, n, dev,
                    kernel="ssd_scan")]
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(
            card=torch.cuda.get_device_name(0), arch=args.arch, runs=runs),
            indent=1))
    return 0


def train_profile(cfg, seed: int, dev, profile) -> dict:
    """One train step of ``cfg`` at its phase 9 batch, profiled after two
    unprofiled steps (the allocator's pools, cuBLAS's handles)."""
    from repro_torch import optim
    from repro_torch.core import streams
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model_zoo as zoo
    B, S = 8, 4096 if cfg.family == "ssm" else 1024
    model = zoo.init_params(cfg, seed, device=dev)
    state = optim.init(model)
    step = make_train_step(cfg, optim.AdamWConfig(warmup_steps=2,
                                                  total_steps=5))
    tokens = streams.sample_zipf_stream(seed, B * S, cfg.vocab, 1.3,
                                        device=dev).reshape(B, S)

    def train():
        step(model, state, {"tokens": tokens})

    train()
    train()
    return profile(f"{cfg.arch_id} train step {B}x{S}", train, 1, dev,
                   kernel="ssd_scan_kernel", also=("_bwd_",))


if __name__ == "__main__":
    sys.exit(main())
