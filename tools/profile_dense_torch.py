#!/usr/bin/env python3
"""Where the time of the port's dense serving path goes, on one CUDA
device.

    python3 tools/profile_dense_torch.py [--arch gemma3-1b]
                                        [--decode-steps 8] [--ring]
                                        [--out profile.json]

Builds ``chip_smoke.py``'s phase 12 model (``--arch``, a dense or VLM
arch at its full config; command-r-plus-104b cut to 8 layers, as there;
random bf16 weights), warms it up, then for ``prefill_step`` on the
phase's prompts and for a window of ``--decode-steps`` ``decode_step``s
after it:
- once without the profiler: wall time;
- once under ``torch.profiler``: the device's busy share (kernel time
  over wall time), kernels per step, the host ops whose kernels take
  the most device time, and the aten ops a step with the host time
  they take themselves (the most first).

With ``--ring`` (gemma3-1b) it also profiles one decode step at phase
12's (v2) shape, B 8 from the zoo's cache of 131,072 positions (the ring
buffer), then from the uniform cache of the same length (a step holds
the cache and its copy: a second step from the first's output would
hold three uniform caches, 84 GB).

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


def host_ops(fn, steps: int, dev, top: int = 12) -> dict:
    """The aten ops of ``fn`` (``steps`` steps) under the profiler, CPU
    only: how many a step, and the ``top`` by their own host time."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    calls = sum(e.count for e in ops)
    ranked = sorted(ops, key=lambda e: e.self_cpu_time_total, reverse=True)
    out = dict(aten_calls_per_step=calls / steps,
               self_cpu_ms_per_step=sum(e.self_cpu_time_total
                                        for e in ops) / 1e3 / steps,
               top_host_ops=[(e.key, e.count, e.self_cpu_time_total / 1e3)
                             for e in ranked[:top]])
    print(f"  host: {out['aten_calls_per_step']:.0f} aten calls a step, "
          f"{out['self_cpu_ms_per_step']:.2f} ms of their own host time a "
          "step; top (op, calls, ms): " + ", ".join(
              f"{k} {n} {ms:.2f}" for k, n, ms in out["top_host_ops"]),
          flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--ring", action="store_true",
                    help="also profile gemma3's (v2) decode at 131,072")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_dense_torch: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from profile_moe_torch import profile
    from repro_torch import configs
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import transformer
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    run = dict(chip_smoke.DENSE_RUNS[args.arch])
    cfg = configs.get_config(args.arch)
    if run.get("n_layers"):
        cfg = cfg.replace(n_layers=run["n_layers"])
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = zoo.init_params(cfg, gen, device=dev)
    B, S, n = run["batch"], run["seq"], args.decode_steps
    tokens, patches = chip_smoke.dense_inputs(cfg, B, S, gen, dev)
    batch = {"tokens": tokens}
    if patches is not None:
        batch["patches"] = patches
    P = 0 if patches is None else patches.shape[1]
    _, cache = zoo.prefill_step(model, cfg, batch, pad_to=P + S + 4 * n)
    tok = tokens[:, :1]

    def prefill():
        zoo.prefill_step(model, cfg, batch, pad_to=P + S + 4 * n)

    def decode(c=cache):
        for _ in range(n):
            _, c = zoo.decode_step(model, cfg, c, tok)

    decode()                                            # warm-up
    runs = [profile(f"{args.arch} prefill {B}x{P + S}", prefill, 1, dev,
                    kernel="gemm"),
            profile(f"{args.arch} decode B={B}", decode, n, dev,
                    kernel="gemm")]
    runs[-1]["host"] = host_ops(decode, n, dev)
    if args.ring:
        B, max_len = chip_smoke.RING[:2]
        for kind, make in (("ring", zoo.init_cache),
                           ("uniform", transformer.init_cache)):
            c0 = make(cfg, B, max_len, device=dev)

            def step(c0=c0):
                zoo.decode_step(model, cfg, c0, tok)

            step()                                      # warm-up
            runs.append(profile(f"{args.arch} decode B={B} {kind} "
                                f"{max_len:,}", step, 1, dev,
                                kernel="gemm"))
            del step, c0
            torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(
            card=torch.cuda.get_device_name(0), arch=args.arch, runs=runs),
            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
