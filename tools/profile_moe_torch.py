#!/usr/bin/env python3
"""Where the time of the port's MoE serving path goes, on one CUDA
device.

    python3 tools/profile_moe_torch.py [--layers 8] [--decode-steps 8]
                                      [--train] [--out profile.json]

Builds ``chip_smoke.py``'s MoE model (qwen3-moe-235b-a22b at full width,
``--layers`` of its 94 layers, random bf16 weights), warms it up, then
for ``prefill_step`` on 8 × 1,024 tokens and for a window of
``--decode-steps`` ``decode_step``s at batch 8, with router "cg":
- once without the profiler: wall time;
- once under ``torch.profiler``: the device's busy share (kernel time
  over wall time), kernels per step, the host ops (by input shape) whose
  kernels take the most device time, and the ``cg_dispatch`` kernel's
  share.

With ``--train`` it profiles ``chip_smoke.py``'s phase 8 step (p)
instead: one ``make_train_step`` step (after two unprofiled ones) of
qwen3-moe-235b-a22b at full width, ``--layers`` (default 1) of its 94
layers, remat "full", grad_accum 8, on 8 × 1,024 zipf(1.3) tokens,
router "cg": the busy share, the ``cg_dispatch`` kernel's device time
(its forward and recompute launches), the device time of the loss
(``chunked_xent``'s f32 logits: every chunk's forward and recompute,
and the backward of their operations, matched to them by autograd
sequence number), of AdamW (``optim.update``) and the top ops.

Needs CUDA; imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def profile(name: str, fn, steps: int, dev,
            kernel: str = "cg_dispatch", also: tuple = (),
            split=None) -> dict:
    """Run ``fn`` (``steps`` steps) once unprofiled and once under the
    profiler; ``kernel`` (and each of ``also``) names hand-written
    kernels, by a part of their name, whose device time is reported
    beside the totals; ``split`` (the profiler's events → {label: device
    ms}) adds labelled parts of the device time."""
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
    events = prof.events()
    # a record_function range also appears on the device's timeline
    # under its own name, spanning its kernels: keep kernels only
    cpu_names = {e.name for e in events
                 if e.device_type == torch.autograd.DeviceType.CPU}
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in cpu_names]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    named = {k: sum(e.time_range.elapsed_us() for e in kernels
                    if k in e.name) / 1e3 for k in (kernel, *also)}
    # host ops by input shape, ranked by the device time of their kernels
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.key.startswith("aten::")]
    top = sorted(ops, key=lambda e: e.device_time_total, reverse=True)[:14]
    parts = split(events) if split else {}
    out = dict(run=name, steps=steps, wall_s=wall,
               ms_per_step=wall / steps * 1e3, profiled_wall_s=wall_prof,
               device_ms=device_us / 1e3,
               device_busy_share=device_us / 1e6 / wall_prof,
               kernels_per_step=len(kernels) / steps,
               **{f"{k}_device_ms": ms for k, ms in named.items()},
               parts_device_ms=parts,
               top_device_ops=[(e.key, str(e.input_shapes)[:90], e.count,
                                e.device_time_total / 1e3)
                               for e in top])
    print(f"{name}: {wall * 1e3:.2f} ms unprofiled = "
          f"{out['ms_per_step']:.2f} ms/step; profiled: device busy "
          f"{out['device_busy_share']:.4f} ({out['device_ms']:.2f} ms of "
          f"{wall_prof * 1e3:.2f}), {out['kernels_per_step']:.1f} kernels/"
          f"step, " + ", ".join(f"{k} {ms:.3f} ms"
                                for k, ms in named.items()),
          flush=True)
    for label, ms in parts.items():
        print(f"  {label}: {ms:.3f} device ms = "
              f"{ms / (device_us / 1e3):.4f} of the device time", flush=True)
    print("  top ops by the device time of their kernels (op, input "
          "shapes, calls, ms):", flush=True)
    for row in out["top_device_ops"]:
        print(f"    {row[0]:<24} {row[1]:<90} {row[2]:>5} {row[3]:9.3f}",
              flush=True)
    return out


def loss_and_adamw_split(events) -> dict:
    """The loss's and AdamW's device ms in one train step's events, from
    the ranges ``annotated`` opens: "xent_chunk" (each chunk's f32 logits
    and loss, forward and recompute) with the backward nodes of the
    operations inside those ranges (autograd records a node's backward
    under its forward op's sequence number), and "adamw". An op belongs
    to a range when it runs on the range's thread within its span; each
    kernel counts once, with the op that launched it."""
    import torch
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]

    def spans(pred):
        return [(e.thread, e.time_range.start, e.time_range.end)
                for e in cpu if pred(e)]

    def within(e, sp):
        return any(e.thread == t and a <= e.time_range.start
                   and e.time_range.end <= b for t, a, b in sp)

    def device_ms(sp, but=()):
        return sum(k.duration for e in cpu
                   if e.kernels and within(e, sp) and not within(e, but)
                   for k in e.kernels) / 1e3

    xent = spans(lambda e: e.name == "xent_chunk")
    seq = {e.sequence_nr for e in cpu
           if e.sequence_nr >= 0 and within(e, xent)}
    backward = spans(
        lambda e: e.name.startswith("autograd::engine::evaluate_function")
        and e.sequence_nr in seq)
    # the recompute runs inside a backward node: count it once
    return {"chunked_xent forward and recompute": device_ms(xent),
            "chunked_xent backward": device_ms(backward, but=xent),
            "AdamW (optim.update)": device_ms(
                spans(lambda e: e.name == "adamw"))}


@contextlib.contextmanager
def annotated():
    """Open a ``record_function`` range around every call of the loss's
    chunk (``lm_common._xent_chunk``) and of AdamW's ``optim.update``,
    for ``loss_and_adamw_split``; the functions are restored after."""
    import torch
    from repro_torch import optim
    from repro_torch.models import lm_common

    def wrap(fn, label):
        def wrapped(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return wrapped

    chunk, update = lm_common._xent_chunk, optim.update
    lm_common._xent_chunk = wrap(chunk, "xent_chunk")
    optim.update = wrap(update, "adamw")
    try:
        yield
    finally:
        lm_common._xent_chunk, optim.update = chunk, update


def train_profile(layers: int, seed: int, dev) -> dict:
    """One train step of phase 8's (p) (router cg, uniform capacities),
    profiled after two unprofiled steps, with the loss and AdamW split
    out."""
    from repro_torch import optim
    from repro_torch.core import streams
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model_zoo as zoo
    import chip_smoke
    cfg = chip_smoke.moe_config(layers)
    B, S = 8, 1024
    model = zoo.init_params(cfg, seed, device=dev)
    state = optim.init(model)
    step = make_train_step(cfg, optim.AdamWConfig(warmup_steps=2,
                                                  total_steps=5))
    tokens = streams.sample_zipf_stream(seed, B * S, cfg.vocab, 1.3,
                                        device=dev).reshape(B, S)

    def train():
        step(model, state, {"tokens": tokens})

    with annotated():
        train()
        train()
        return profile(f"{cfg.arch_id} {cfg.n_layers}L train step {B}x{S} "
                       f"(grad_accum {cfg.grad_accum}, remat {cfg.remat})",
                       train, 1, dev, split=loss_and_adamw_split)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=None,
                    help="depth: 8 by default, 1 with --train")
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--train", action="store_true",
                    help="profile a train step instead of serving")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_moe_torch: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    chip_smoke.build_all(["cg_dispatch"])
    if args.train:
        layers = args.layers or 1
        runs = [train_profile(layers, args.seed, dev)]
    else:
        layers = args.layers or 8
        runs = serve_profile(layers, args.decode_steps, args.seed, dev)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(
            card=torch.cuda.get_device_name(0), layers=layers,
            train=args.train, runs=runs), indent=1))
    return 0


def serve_profile(layers: int, n: int, seed: int, dev) -> list:
    """Prefill 8 × 1,024 and ``n`` decode steps at batch 8 of the model
    cut to ``layers``, router "cg", each profiled."""
    import chip_smoke
    import torch
    from repro_torch.models import model_zoo as zoo
    cfg = chip_smoke.moe_config(layers)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = zoo.init_params(cfg, gen, device=dev)
    B, S = 8, 1024
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
    return [profile(f"prefill {B}x{S}", prefill, 1, dev),
            profile(f"decode B={B}", decode, n, dev)]


if __name__ == "__main__":
    sys.exit(main())
