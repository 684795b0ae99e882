#!/usr/bin/env python3
"""Where the time of the port's MoE serving path goes, on one CUDA
device.

    python3 tools/profile_moe_torch.py [--layers 8] [--decode-steps 8]
                                      [--out profile.json]

Builds ``chip_smoke.py``'s MoE model (qwen3-moe-235b-a22b at full width,
``--layers`` of its 94 layers, random bf16 weights), warms it up, then
for ``prefill_step`` on 8 × 1,024 tokens and for a window of
``--decode-steps`` ``decode_step``s at batch 8, with router "cg":
- once without the profiler: wall time;
- once under ``torch.profiler``: the device's busy share (kernel time
  over wall time), kernels per step, the host ops (by input shape) whose
  kernels take the most device time, and the ``cg_dispatch`` kernel's
  share.

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


def profile(name: str, fn, steps: int, dev,
            kernel: str = "cg_dispatch") -> dict:
    """Run ``fn`` (``steps`` steps) once unprofiled and once under the
    profiler; ``kernel`` names the hand-written kernel whose device time
    is reported beside the totals."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall_prof = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    kernel_us = sum(e.time_range.elapsed_us() for e in kernels
                    if kernel in e.name)
    # host ops by input shape, ranked by the device time of their kernels
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.key.startswith("aten::")]
    top = sorted(ops, key=lambda e: e.device_time_total, reverse=True)[:14]
    out = dict(run=name, steps=steps, wall_s=wall,
               ms_per_step=wall / steps * 1e3, profiled_wall_s=wall_prof,
               device_ms=device_us / 1e3,
               device_busy_share=device_us / 1e6 / wall_prof,
               kernels_per_step=len(kernels) / steps,
               **{f"{kernel}_device_ms": kernel_us / 1e3},
               top_device_ops=[(e.key, str(e.input_shapes)[:90], e.count,
                                e.device_time_total / 1e3)
                               for e in top])
    print(f"{name}: {wall * 1e3:.2f} ms unprofiled = "
          f"{out['ms_per_step']:.2f} ms/step; profiled: device busy "
          f"{out['device_busy_share']:.4f} ({out['device_ms']:.2f} ms of "
          f"{wall_prof * 1e3:.2f}), {out['kernels_per_step']:.1f} kernels/"
          f"step, {kernel} {out[f'{kernel}_device_ms']:.3f} ms",
          flush=True)
    print("  top ops by the device time of their kernels (op, input "
          "shapes, calls, ms):", flush=True)
    for row in out["top_device_ops"]:
        print(f"    {row[0]:<24} {row[1]:<90} {row[2]:>5} {row[3]:9.3f}",
              flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_moe_torch: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.models import model_zoo as zoo
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    chip_smoke.build_all(["cg_dispatch"])
    cfg = chip_smoke.moe_config(args.layers)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = zoo.init_params(cfg, gen, device=dev)
    B, S, n = 8, 1024, args.decode_steps
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
    runs = [profile(f"prefill {B}x{S}", prefill, 1, dev),
            profile(f"decode B={B}", decode, n, dev)]
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(
            card=torch.cuda.get_device_name(0), layers=args.layers,
            runs=runs), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
