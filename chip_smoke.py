#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out report.json]

Phases:
  1. device: requires CUDA; prints the card's name and power limit
     (nvidia-smi);
  2. build: compiles the CUDA kernels from the checkout's sources
     (``src/repro_torch/kernels/csrc``: ``porc_snapshot.cu``,
     ``porc_assign.cu``, ``cg_dispatch.cu`` and ``ssd_scan.cu``, one
     ``nvcc`` each, started together) into
     ``build/repro_torch_kernels/``;
  3. kernels: holds ``porc_snapshot``, ``porc_multisource_scan`` and its
     HHPolicy branch (over the cluster grid: S 1, 7, 8, 9, 17, 100 ×
     n_bins 8, 480, 1,000, 60,000 × sync 1, 3 × block 1, 16, 128, every
     HHPolicy of ``hh_policy``), ``porc_assign`` and
     ``porc_multisource_strict`` against their plain torch versions on
     the card, bit for bit, on WP- and TW-profile streams, and prints
     each launch plan of ``porc_multisource_scan`` (grid, cluster,
     shared-memory bytes); ``cg_dispatch`` over the JAX tests' grid,
     the MoE path's prefill and decode shapes and the kernel's edges,
     with the kernel its plan picks and the other where it fits, and
     ``ssd_scan`` (y
     and the final state) against the sequential ``ref_ssd_scan`` and
     the plain ``ssd_chunked`` within the JAX tests' tolerances, over
     their grid, chunk invariance, C ≡ 0 and both Mamba-2 models'
     prefill shapes, and ``ssd_scan_bwd`` (the SSD scan's CUDA
     backward, every gradient) against the plain ``ssd_chunked_bwd``
     over the same grid in f32 and bf16, chunk invariance, C ≡ 0 and
     phase 9's three training shapes; the strict kernels also over edge
     grids (blocks of
     1 to 1,000, S 1, 7 and 100, one key repeated, the L2 paths, the
     leftover fallback); times each at the main path's shapes, every
     kernel both ways: ``ms`` between CUDA events (host issue included)
     and ``device_ms``, the kernel's own device time (``kernel_ms``,
     ``torch.profiler``); the strict ones also in ns per rank,
     ``porc_multisource_scan`` also over the five spans of one (c) slot
     and at Fig 11's shape; ``porc_snapshot`` at its three launch shapes
     on (a) (a slot's 78 blocks of 128, its 16-key tail, a block-1 slot
     of 10,000 keys), ``ssd_scan`` at its three prefill shapes, its
     operations held against the bf16 tensor-core rate, and
     ``ssd_scan_bwd`` at its three training shapes against the f32 rate;
  4. main path: ``cg.run`` with ``engine="auto"`` on the card —
     (a) the paper's simulation setup (10 workers × α=10, ε=0.01, slot
     10,000, y=3 machines 5× faster at ρ=0.8) on a WP stream at Table I
     scale (22M messages, 2.9M keys, p1=9.32%), at block 128 and at
     block 1 on a 2.2M prefix (checked against the per-message oracle);
     (b) the Fig 14/15 deployment (24 workers, α=20, slot 5,000, 16
     moves per slot, two executors at 30%, 8 sources) on a TW-profile
     stream at Table I scale (22M messages, 31M keys, p1=2.67%);
     (c) (b) with ``hh_scheme="WCHOICES"`` on the same stream, and (d)
     (a) at block 128 with ``hh_scheme="DCHOICES"`` on the 2.2M prefix:
     the heavy-hitter path through the HHPolicy kernel;
     the strict engine and the partitioner registry:
     (f) (a) with ``engine="strict"`` (the ``porc_assign`` kernel), at
     block 128 and at block 1 on the 2.2M prefix, which must equal (a)'s
     block-1 run;
     (g) the Fig 11 point, ``partitioners.route("PORC", ...,
     sources=100, block_size=128, engine="strict")`` over 1,000 VWs (100
     workers × α=10) on (a)'s 22M-message stream, and the same with
     ``engine="auto"`` (the snapshot kernel), within the staleness
     envelope of the JAX tests;
     (h) the Fig 7/8 table at ``bench_schemes_workers.py``'s size: the
     first 200,000 WP messages over 5, 10, 50 and 100 workers × α=10,
     every scheme of the registry, sequential and blocked at 128;
  5. serving: a ``ServingEngine`` on the card over a W-Choices
     ``CGRequestRouter`` (24 replicas × α=20, 8 sources) under a chaos
     schedule (replicas 0 and 1 at 30% from tick 1, replica 3 crashed at
     tick 200 and back at 350), 2,048 TW-profile requests per tick for
     500 ticks, then drained: nothing may be lost;
  6. MoE: qwen3-moe-235b-a22b at full width (d 4096, 64 query / 4 KV
     heads, 128 experts top-8, vocab 151,936) with its depth cut from 94
     to 8 layers (the reduction: 41 GB of bf16 weights on the 80 GB
     card), random weights from a seeded ``torch.Generator``:
     ``prefill_step`` on 8 × 1,024 tokens and 32 ``decode_step``s with
     router "cg" and with "topk" (prefill tokens/s, decode ms/step,
     ``drop_frac``, ``max_load_frac``), and one prefill of 2 × 4,096
     past ``attn_chunk_threshold`` (2,048), so every layer's attention
     takes ``chunked_attention``; then ``launch/serve.py``'s
     ``ServingEngine`` with 4 replicas of the model, one slow, serving
     64 requests; then the smoke config in f32 on the card against the
     same weights on the CPU;
  7. Mamba-2: first ``chunked_attention`` against ``dense_attention`` in
     f32 at 1 × 4,096 tokens with zamba2's and qwen3-moe's attention
     shapes (≤ 1e-5 relative); (k) zamba2-2.7b at full size (54 Mamba-2
     layers in 9 groups, d 2,560, 80 SSD heads of 64, N 64, a shared
     attention block of 32 heads × 80 and d_ff 10,240, vocab 32,000) and
     (l) mamba2-130m at full size (24 layers, d 768, 24 heads, N 128),
     random bf16 weights from a seeded ``torch.Generator``:
     ``prefill_step`` on 8 prompts of 1,024 (k) or 4,096 (l) tokens and
     32 greedy ``decode_step``s, one ``ssd_scan`` launch per SSM layer,
     and ``prefill(prompt[:-1])`` + ``decode(last)`` against
     ``prefill(prompt)``; (m) ``launch/serve.py``'s ``ServingEngine``
     over (k)'s model with 4 replicas, one slow, serving 64 requests;
     (o) (k)'s model on 8 prompts of 4,096 tokens, past the attention
     threshold: the 9 shared-attention calls take ``chunked_attention``
     (tokens/s, peak memory), then 4 decode steps; (n) both smoke
     configs in f32 on the card against the same weights on the CPU;
  8. MoE training: (p) qwen3-moe-235b-a22b at full width with its depth
     cut from 94 to 1 layer (its training state, 20 bytes a parameter,
     is 62.2 GB: two layers would not fit the 80 GB card), random bf16
     weights from a seeded ``torch.Generator``, the config's remat
     "full" and grad_accum 8: 5 AdamW steps (warm-up 2) of
     ``launch/steps.make_train_step`` on one fixed batch of 8 × 1,024
     zipf(1.3) tokens, router "cg" and "topk" × uniform and
     ``capacity_skew=3.0`` capacities (loss each step, grad_norm, step
     ms, tokens/s, peak memory, ``moe_drop_frac``,
     ``moe_max_load_frac``, ``cg_dispatch`` launches per step: two a
     micro-step); the loss must fall and CG drop no more than top-k;
     then the smoke config's train step in f32 on the card against the
     CPU (loss, every gradient, the weights after the step);
  9. SSM training: (q) mamba2-130m at full size (24 layers, d 768, 24
     heads of 64, N 128, vocab 50,280), 5 AdamW steps (warm-up 2) on
     one fixed batch of 8 × 4,096 zipf(1.3) tokens; (r) zamba2-2.7b at
     full size (54 layers, 2,340,750,240 parameters; 37.5 GB of training
     state), 5 steps on 8 × 1,024 tokens, then one step on 2 × 4,096
     past the attention threshold (the 9 shared-attention calls take
     ``chunked_attention``, again in the recompute); the configs' remat
     "full", grad_accum 1, random bf16 weights from a seeded
     ``torch.Generator``; per step the loss (which must fall), grad_norm,
     step ms, train tokens/s, and the launches: ``ssd_scan`` twice a
     layer (forward and recompute), ``ssd_scan_bwd`` once; peak memory
     beside the reckoning; then both smoke configs' train step in f32
     on the card against the CPU;
 10. the training feed and its failure path: (s) ``launch/train.py``'s
     driver (``Trainer.run``, what ``train()`` runs) on mamba2-130m at
     full size, 8 × 4,096 tokens a step from the sharded pipeline, 4
     hosts, a checkpoint every 4 steps: run A trains 9 steps and loses
     host 3 at step 6 (its shards must land where the reference's
     capacity rule puts them, none on a dead host, none lost), run B
     resumes to 12 (the restored state must equal A's final one bit for
     bit; B trains from step 8 again, as the reference does); per step
     the loss, step ms, train tokens/s and the launches (``ssd_scan``
     twice a layer, ``ssd_scan_bwd`` once), the save and restore seconds,
     peak memory; (t) (p)'s model on a zipf(1.1) token stream, step i
     on the pipeline's ``global_batch(i)``, routers cg and topk at
     phase 8's lr: ``moe_drop_frac`` and ``moe_max_load_frac`` each
     step beside phase 8's fixed batch, CG dropping no more than top-k;
     then the smoke config's 5 train steps on the stream in f32 on the
     card against the CPU (loss, lr, grad_norm, routing telemetry);
 11. the mesh tier: (u1) ``MeshCGRequestRouter`` on one rank over NCCL
     (``launch.mesh.make_source_mesh``) at phase 5's deployment and
     schedule without its policy (the mesh refuses W-Choices), under
     ``ServingEngine(async_submit=True)``, against the single-host
     ``CGRequestRouter`` of the same configuration: every admitted
     batch's replica ids, every tick's counts, the served counts, the
     owner map and every latency must be equal, nothing lost; then that
     rank routes the demo stream below; (u2) 8 ranks on the one card over
     gloo (``launch.mesh.spawn_ranks``; NCCL refuses two ranks on one
     device), one source a rank, each routing its lane with the
     multisource kernel on ``bench_multihost.py --demo``'s deployment
     (2^21 + 7 zipf(1.2) keys, 8,192 bins, block 2,048, chunk 16) at
     sync 1 and 3: assignment, base, every lane, ticks and routed equal
     to ``ref_porc_multisource(engine="cuda")`` in this process bit for
     bit on every rank, and a kill-one serving run (4 replicas, 30
     ticks, async) that loses nothing; msgs/s of the mesh route at 1
     and 8 ranks beside the single-process kernel route, launches and
     collectives a call; the kernel timed at a rank's launch shape (1
     lane, 8,192 bins, block 2,048, the cap of 8 sources);
 12. the dense decoder family and its VLM variant, served, random bf16
     weights from a seeded ``torch.Generator``, each model freed before
     the next: (v) gemma3-1b at full size (26 layers, 22 local with
     window 1,024 and 4 global, d 1,152, 4 query and 1 KV head of 256,
     vocab 262,144): prefill 8 × 1,024 + 32 greedy decode steps,
     ``prefill(prompt[:-1])`` + ``decode(last)`` against
     ``prefill(prompt)`` (bf16, then f32 on 2 × 1,536, past the window),
     a 2 × 4,096 prefill past ``attn_chunk_threshold`` (26
     ``chunked_attention`` calls, the local layers masked by the window)
     + 4 steps; (v2) 64 decode steps at B 8 from the zoo's cache at
     131,072 positions (gemma3's ring: ``_use_longctx``) and from the
     uniform cache of the same length for the first 8, fed the same
     tokens: ms/step, cache bytes, peak memory, the logits within the
     bf16 bound; then past the ring's wrap at B 1 (a prefill of W - 8
     tokens copied into the ring, 8 + 24 steps against the uniform
     cache, each step's logits within the same bound); (v3)
     ``launch/serve.py``'s ``serve`` over (v)'s model, 4 replicas (one
     slow), 64 requests, the router's ``porc_multisource_scan``
     launches; (w) internlm2-20b at full size (48 layers, d 6,144, 48/8
     heads, 19.3 B parameters): prefill 8 × 1,024 + 32 steps; (x)
     starcoder2-3b at full size (LayerNorm, GELU MLP, biases, window
     4,096 on every layer): prefill 2 × 8,192 (30 ``chunked_attention``
     calls, the kv chunks below the window skipped) + 16 steps, where the
     window's lower bound masks; (y) internvl2-2b at full size: prefill
     8 × (256 patches + 768 tokens) + 32 steps; (z) command-r-plus-104b
     at full width (d 12,288, 96/8 heads, vocab 256,000, rope θ 7.5e7)
     with its depth cut from 64 to 8 layers: prefill 2 × 1,024 + 8
     steps; each with prefill tokens/s, decode ms/step and peak memory
     beside its weights' bytes; then the five smoke configs in f32 on
     the card against the same weights on the CPU, and gemma3's ring
     against the uniform decode on the card over 40 steps, past the smoke
     window's wrap (within 1e-5);
 13. whisper-small served and trained, the dense and VLM families
     trained, random bf16 weights from a seeded ``torch.Generator``, each
     model freed before the next: (aa) whisper-small at full size (12 +
     12 layers, d 768, 12 heads, vocab 51,865): ``encode`` of 8 × 1,500
     frame embeddings (30 s of audio after the stubbed conv frontend),
     ``prefill_step`` of the 4-token start-of-transcript prompt, 64
     greedy decode steps in a self cache of 448 positions: encode,
     prefill and decode ms against the read time of the decoder's
     weights, peak memory; ``prefill(prompt[:-1])`` + ``decode(last)``
     against ``prefill(prompt)`` (bf16, then f32 on the smoke config);
     (aa2) ``launch/serve.py``'s ``serve`` over it (4 replicas, one
     slow, 64 requests, nothing lost; row 2a counts its launch); (ab)
     gemma3-1b (8 × 1,024, remat "full"), (ac) starcoder2-3b (8 × 1,024:
     LayerNorm's VJP, biases, GELU MLP), (ad) internvl2-2b (8 × (256
     patches + 768 tokens)), (ae) whisper-small (8 × (1,500 frames + 448
     tokens)) trained, 5 AdamW steps each on one fixed batch: the loss
     must fall; train tokens/s, step ms and peak memory against the
     training state; gemma3-1b again under remat "none", "dots" and
     "attn_out" (the same losses); ``launch/train.py``'s ``Trainer`` on
     whisper-small at full size, 6 steps; then the four smoke configs'
     train step in f32 card vs CPU (every gradient within 1e-4),
     whisper's logits card vs CPU (1e-4), and "dots" and "attn_out"
     against "none" on the card (loss and gradients within 1e-6);
 14. prints the ``{"kernels": [...]}`` line and, last, the device line.

Any mismatch, build failure or launch error exits non-zero. Imports
nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
# The work is int32 hashing and compares; the guide's table of peaks has
# no int32 ALU rate, so operations are held against its nearest entry,
# float32 outside the tensor cores.
OPS_PER_S = 67e12
OPS_PER_PROBE = 24             # two fmix32 rounds + salt mix, mod, compare
BF16_TC_OPS_PER_S = 989e12     # bf16 tensor cores, dense

WP_TABLE1 = dict(name="WP", n_messages=22_000_000, n_keys=2_900_000,
                 p1=0.0932, z_tail=1.0, diurnal=True)
TW_TABLE1 = dict(name="TW", n_messages=22_000_000, n_keys=31_000_000,
                 p1=0.0267, z_tail=0.8, diurnal=True)
# (b) and (c) route the whole TW stream
TW_MAIN_MESSAGES = 22_000_000


def log(*a):
    print(*a, flush=True)


def counters() -> dict:
    """(object, attribute) of every kernel's launch counter, of the
    plain strict engine's, plain dispatch's and plain SSD scan's tallies
    of calls on CUDA tensors, and of the calls of ``chunked_attention``
    (plain torch: the reference has no kernel there)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.cg_dispatch import cg_dispatch
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    from repro_torch.models.layers import chunked_attention
    from repro_torch.models.mamba2 import ssd_chunked
    from repro_torch.kernels.porc_assign import (porc_assign,
                                                 porc_multisource_strict)
    from repro_torch.kernels.porc_snapshot import (porc_multisource_scan,
                                                   porc_snapshot)
    return {"porc_snapshot": (porc_snapshot, "launches"),
            "porc_snapshot_block1": (porc_snapshot.blocks, 1),
            "porc_snapshot_block128": (porc_snapshot.blocks, 128),
            "porc_multisource_scan": (porc_multisource_scan, "launches"),
            "porc_multisource_scan_hh": (porc_multisource_scan,
                                         "hh_launches"),
            "porc_assign": (porc_assign, "launches"),
            "porc_multisource_strict": (porc_multisource_strict,
                                        "launches"),
            "cg_dispatch": (cg_dispatch, "launches"),
            "ssd_scan": (ssd_scan, "launches"),
            "ssd_scan_bwd": (ssd_scan_bwd, "launches"),
            "plain_strict_on_cuda": (ref._porc_block.tally, "cuda_calls"),
            "plain_dispatch_on_cuda": (ref.ref_cg_dispatch.tally,
                                       "cuda_calls"),
            "plain_ssd_on_cuda": (ssd_chunked.tally, "cuda_calls"),
            "chunked_attention": (chunked_attention, "calls")}


def zero_counts():
    for obj, attr in counters().values():
        if isinstance(obj, dict):
            obj[attr] = 0
        else:
            setattr(obj, attr, 0)


def read_counts() -> dict:
    return {k: obj[attr] if isinstance(obj, dict) else getattr(obj, attr)
            for k, (obj, attr) in counters().items()}


def check_counts(name: str, counts: dict, kernel: str | None, dev,
                 check_launches: bool):
    """A main-path run launched its kernel (when it names one), and never
    ran the plain strict engine, the plain dispatch or the plain SSD scan
    on the card."""
    if check_launches and kernel and counts[kernel] <= 0:
        fail(f"{name}: the main path never launched {kernel}")
    if dev.type == "cuda" and counts["plain_strict_on_cuda"]:
        fail(f"{name}: the plain strict engine ran on CUDA tensors")
    if dev.type == "cuda" and counts["plain_dispatch_on_cuda"]:
        fail(f"{name}: the plain cg_dispatch ran on CUDA tensors")
    if dev.type == "cuda" and counts["plain_ssd_on_cuda"]:
        fail(f"{name}: the plain ssd_chunked ran on CUDA tensors")


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time per call of ``fn`` over ``reps`` calls (CUDA
    events, after warm-up)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps: int, match: str) -> float:
    """Mean device time of one launch of the kernel whose name holds
    ``match``, launched once a call of ``fn``, over ``reps`` calls
    (``call_kernels_ms``). Unlike ``cuda_ms`` it leaves out the gaps in
    which the device waits for the host to issue the next launch."""
    return call_kernels_ms(fn, reps, match)[0]


def call_kernels_ms(fn, reps: int, match: str) -> tuple[float, dict]:
    """Device time of one call of ``fn`` summed over the CUDA kernels whose
    name holds ``match``, each launched once a call: per kernel the mean
    of its launches in a ``torch.profiler`` trace of ``reps`` calls, and
    the sum of those means. A trace may drop a record at its edge: one in
    which a kernel has fewer than ``reps`` - 1 launches is taken again, up
    to three times; one with more than ``reps`` fails. Returns the sum and
    the per-kernel means by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if match in e.key]
        count = {e.key: e.count for e in hits}
        counts.append(sorted(count.values()))
        if not hits:
            continue
        if max(count.values()) > reps:
            break
        if min(count.values()) >= reps - 1:
            each = {e.key: e.self_device_time_total / 1e3 / e.count
                    for e in hits}
            return sum(each.values()), each
    fail(f"call_kernels_ms: launches {counts} of the kernels matching "
         f"{match!r} in the traces of {reps} calls each")


def probes_used(keys, assign, n_bins: int, budget: int):
    """Probes the keys of a call walked, each up to ``budget`` salts (the
    chunk at block > 1, the whole chain of 4·n_bins at block 1): the
    first salt whose candidate is its assignment, or the whole budget
    (fallback). At block 1 this is exact: a chain that meets the
    least-loaded bin stops there or earlier, as that bin is under the
    cap."""
    import torch
    from repro_torch.core.hashing import hash_to_bins
    salts = torch.arange(1, budget + 1, device=keys.device)
    hit = hash_to_bins(keys[:, None], salts, n_bins) == assign[:, None]
    first = torch.where(hit.any(1), hit.int().argmax(1) + 1,
                        torch.full_like(assign, budget, dtype=torch.int64))
    return int(first.sum())


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _same(name: str, a, b) -> float:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"{name}: {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    err = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
    if not torch.equal(a, b):
        fail(f"{name}: kernel differs from the plain version "
             f"(max abs err {err})")
    return err


def check_snapshot(keys, dev) -> float:
    """porc_snapshot kernel vs ref_porc_snapshot, bit for bit."""
    import torch
    from repro_torch.kernels.porc_snapshot import porc_snapshot
    from repro_torch.kernels import ref
    err = 0.0
    # 60,000 bins: the load beyond shared memory
    cases = [(n, blk) for n in (100, 480, 1000, 60_000) for blk in (1, 128)]
    for n, blk in cases:
        m = 2_000 if blk == 1 else 128 * 200
        k = keys[:m].contiguous()
        # direct call with a load0/m0 continuation
        load0 = torch.arange(n, device=dev, dtype=torch.float32) % 7
        m0 = torch.full((), float(load0.sum()), device=dev)
        a_k, l_k = porc_snapshot(k, n, block=blk, eps=0.01, load0=load0,
                                    m0=m0)
        a_p, l_p = ref.ref_porc_snapshot(k, n, block=blk, eps=0.01,
                                         load0=load0, m0=m0)
        err = max(err, _same(f"porc_snapshot n={n} block={blk} assign",
                             a_k, a_p),
                  _same(f"porc_snapshot n={n} block={blk} load", l_k, l_p))
        # span driver: a ragged length, the state carried across calls
        rag = m + 77
        split = (rag // 3) // blk * blk
        out = {}
        for eng in ("cuda", "snapshot"):
            a1, st = ref.ref_porc_route(keys[:split], n, block=blk, eps=0.01,
                                        engine=eng, device=dev)
            a2, st = ref.ref_porc_route(keys[split:rag], n, block=blk,
                                        eps=0.01, state=st, engine=eng,
                                        device=dev)
            out[eng] = (torch.cat([a1, a2]), st.load, st.routed)
        for what, x, y in zip(("assign", "load", "routed"), out["cuda"],
                              out["snapshot"]):
            err = max(err, _same(f"ref_porc_route n={n} block={blk} {what}",
                                 x, y))
        log(f"  porc_snapshot n_bins={n:>6} block={blk:>3}: identical "
            f"({m} + {rag} messages)")
    return err


# The cluster grid of porc_multisource_scan, both branches: sources
# around the cluster size of 8, views from 8 bins to 60,000 (loads in
# global memory), blocks 1, 16 and 128
MS_SOURCES = (1, 7, 8, 9, 17, 100)
MS_BINS = (8, 480, 1000, 60_000)
MS_SYNC = (1, 3)
MS_BLOCKS = (1, 16, 128)


def ms_lengths(S: int, block: int, sync: int) -> tuple[int, int]:
    """(m, split) of a grid case: five blocks per source, a ragged
    remainder of 77 mod block per source (power-of-two spans: 64, 8, 4,
    1 at block 128; 8, 4, 1 at 16) and a sub-S tail. With sync 3 the
    first call ends at a step boundary, so the second enters mid-phase
    (ticks 2, lanes and sketch lanes non-zero); with sync 1 it ends with
    ragged spans and a sub-S tail of its own."""
    m = S * block * 5 + S * (77 % block) + (S // 2 if S > 1 else 0)
    if sync == 1:
        return m, S * block * 2 + S * (3 % block) + S // 3
    return m, S * block * 2


def run_both(keys, n, S, sync, block, split, m, dev, pol=None) -> dict:
    """ref_porc_multisource on the kernel and on the plain engine, the
    state carried across a split at ``split``."""
    import torch
    from repro_torch.kernels import ref
    out = {}
    for eng in ("cuda", "snapshot"):
        a1, st = ref.ref_porc_multisource(
            keys[:split], n, S, sync_every=sync, block=block, eps=0.01,
            engine=eng, policy=pol, device=dev)
        a2, st = ref.ref_porc_multisource(
            keys[split:m], n, S, sync_every=sync, block=block, eps=0.01,
            state=st, engine=eng, policy=pol, device=dev)
        out[eng] = (torch.cat([a1, a2]),) + tuple(st)
    return out


MS_FIELDS = ("assign", "base", "delta", "routed", "ticks", "sketch_base",
             "sketch_delta")


def check_multisource(streams: dict, dev) -> float:
    """porc_multisource_scan kernel vs _porc_multisource_scan, bit for
    bit, through the span driver with a ragged tail and a state carry,
    over streams × S × n_bins × sync × block (the cluster grid)."""
    err = 0.0
    for sname, keys in streams.items():
        for S in MS_SOURCES:
            for n in MS_BINS:
                for sync in MS_SYNC:
                    for block in MS_BLOCKS:
                        m, split = ms_lengths(S, block, sync)
                        out = run_both(keys, n, S, sync, block, split, m, dev)
                        for what, x, y in zip(MS_FIELDS, out["cuda"],
                                              out["snapshot"]):
                            if x is not None or y is not None:
                                err = max(err, _same(
                                    f"multisource {sname} S={S} n={n} "
                                    f"sync={sync} block={block} {what}",
                                    x, y))
            log(f"  porc_multisource_scan {sname} S={S:>3}: identical over "
                f"n_bins {MS_BINS} x sync {MS_SYNC} x block {MS_BLOCKS}")
    return err


def log_plans(title: str):
    """One line per launch plan of porc_multisource_scan counted since
    the counters were last cleared: grid, cluster, threads, shared-memory
    bytes and where the state lives."""
    from repro_torch.kernels.porc_snapshot import porc_multisource_scan
    for plan, count in sorted(porc_multisource_scan.plans.items()):
        where = "loads " + ("shared" if plan.loads_smem else "global")
        if plan.branch == "hh":
            where += ", sketch " + ("shared" if plan.sketch_smem
                                    else "global")
        log(f"  launch plan ({title}) porc_multisource_scan[{plan.branch}]:"
            f" grid {plan.cluster}, cluster {plan.cluster}, "
            f"{plan.threads} threads, {plan.smem_bytes} B shared memory, "
            f"{plan.lanes_per_cta} sources per CTA, {where}; {count} "
            f"launches")
    porc_multisource_scan.plans.clear()


def time_snapshot(keys, dev, n: int, M: int, block: int, warm: int = 0,
                  warm_block: int = 128, plain: bool = True) -> dict:
    """porc_snapshot on ``M`` keys in blocks of ``block``, from the state
    that the first ``warm`` messages leave (the span driver on the card
    at ``warm_block``): ``ms`` between CUDA events (host issue included),
    ``device_ms`` the kernel's own device time (``kernel_ms``), the plain
    engine on the same inputs, and the bytes and operations of the bound.
    The main path's three launch shapes: a slot's 78 blocks of 128, its
    16-key tail, and a block-1 slot of 10,000 keys."""
    from repro_torch.kernels.porc_snapshot import porc_snapshot
    from repro_torch.kernels import ref
    st = ref.porc_state_init(n, device=dev)
    if warm:
        _, st = ref.ref_porc_route(keys[:warm], n, block=warm_block,
                                   eps=0.01, state=st, engine="cuda",
                                   device=dev)
    k = keys[warm: warm + M].contiguous()
    kw = dict(block=block, eps=0.01, load0=st.load, m0=st.routed)
    reps = 50 if block > 1 else 10
    ms = cuda_ms(lambda: porc_snapshot(k, n, **kw), reps=reps)
    device_ms = kernel_ms(lambda: porc_snapshot(k, n, **kw), reps,
                          "porc_snapshot_kernel")
    plain_ms = cuda_ms(lambda: ref.ref_porc_snapshot(k, n, **kw),
                       reps=1 if block == 1 else 3, warmup=1) if plain \
        else None
    a, _ = porc_snapshot(k, n, **kw)
    nbytes = 4 * M * 2 + 4 * n * 2 + 4
    probes = probes_used(k, a, n, 4 * n if block == 1 else 8)
    return dict(shape=f"M={M} n_bins={n} block={block} after {warm}",
                ms=ms, device_ms=device_ms, plain_ms=plain_ms, bytes=nbytes,
                ops=probes * OPS_PER_PROBE + M, probes=probes)


def time_ms(keys, dev, n: int, S: int, block: int, steps: int, pol=None,
            sync: int = 1, warm: int = 0, plain: bool = True,
            eps: float = 0.01, chunk: int = 8,
            global_sources: int | None = None, compare: bool = False) -> dict:
    """porc_multisource_scan (``pol``: its HHPolicy branch) on one span
    of ``steps`` steps of ``block`` keys per source, from the state the
    first ``warm`` messages leave (span driver on the card, block 128,
    sync 1): ``ms``, the time per call between CUDA events over 50 calls
    (``cuda_ms``, host issue included, as every kernel's row is timed);
    ``device_ms``, the kernel's own device time per launch
    (``kernel_ms``); the plain engine on the same inputs; and the bytes
    and operations of the bound. ``global_sources``: the lanes are one
    rank's of a mesh (``kernels.mesh``). ``compare`` (policy-free only):
    the kernel's outputs must equal the plain engine's on these inputs,
    and ``max_abs_err`` is their largest difference."""
    from repro_torch.kernels.porc_snapshot import porc_multisource_scan
    from repro_torch.kernels import ref
    st = ref.multisource_state_init(n, S, pol, device=dev)
    if warm:
        _, st = ref.ref_porc_multisource(keys[:warm], n, S, block=128,
                                         eps=0.01, state=st, engine="cuda",
                                         policy=pol, device=dev)
    M = S * block * steps
    k = keys[warm: warm + M].contiguous()
    args = (k, n, S, sync, block, eps, chunk, st.base, st.delta, st.ticks,
            st.sketch_base, st.sketch_delta, pol)
    kw = dict(global_sources=global_sources)
    ms = cuda_ms(lambda: porc_multisource_scan(*args, **kw), reps=50)
    device_ms = kernel_ms(lambda: porc_multisource_scan(*args, **kw), 50,
                          "porc_multisource")
    plain_ms = cuda_ms(lambda: ref._porc_multisource_scan(
        *args[:7], "snapshot", *args[7:], **kw), reps=3, warmup=1) if plain \
        else None
    shape = f"M={M} S={S} n_bins={n} block={block} steps={steps}"
    if pol is None:
        got = porc_multisource_scan(*args, **kw)
        a = got[0]
        nbytes = 4 * M * 2 + 4 * n * 2 + 4 * S * n * 2 + 8
        ops = (probes_used(k, a, n, chunk) * OPS_PER_PROBE + M
               + steps * (S + 1) * n * 2)
        out = dict(shape=shape, ms=ms, device_ms=device_ms,
                   plain_ms=plain_ms, bytes=nbytes, ops=ops)
        if compare:
            want = ref._porc_multisource_scan(*args[:7], "snapshot",
                                              *args[7:], **kw)
            out["max_abs_err"] = max(
                _same(f"{shape}: {f}", x, y)
                for f, x, y in zip(("assign", "base", "delta", "ticks"),
                                   got, want))
        return out
    D, W = pol.depth, pol.width
    lanes = (1 + S) * D * W
    nbytes = (4 * M * 2 + 4 * n * 2 + 4 * S * n * 2 + 8
              + 4 * lanes * 2)                # sketch lanes in and out
    probes = hh_probes(*args)
    ops = ((probes + 2 * D * M) * OPS_PER_PROBE        # chain + sketch hashes
           + M * (2 * D + 1)                           # sketch reads, adds
           + steps * S * block * block                 # duplicate ranks
           + steps * (S + 1) * n * 2 + steps * lanes)  # masses, merges
    return dict(shape=f"{shape} W-Choices chain={n}", ms=ms,
                device_ms=device_ms, plain_ms=plain_ms, bytes=nbytes,
                ops=ops, probes=probes)


def time_multisource(keys, dev, n: int, S: int, slot: int,
                     block: int) -> dict:
    """porc_multisource_scan at the main path's shape: one slot's span
    of full per-source blocks, from the empty state."""
    return time_ms(keys, dev, n, S, block, slot // S // block)


def time_slot_spans(keys, dev, n: int, S: int, slot: int, block: int,
                    pol=None) -> dict:
    """Every span of one slot as the span driver cuts it (``block_spans``
    of the slot's messages per source: at (c) 512, 64, 32, 16 and 1), each
    timed from the state ten slots leave; ``ms`` is their sum, the
    kernel's time per slot."""
    from repro_torch.kernels import ref
    spans = [time_ms(keys, dev, n, S, blk, length // blk, pol,
                     warm=10 * slot)
             for _, length, blk in ref.block_spans(slot // S, block)]
    return dict(shape=f"one slot of {slot} messages, S={S} n_bins={n}, "
                f"spans {[t['shape'].split(' block=')[1] for t in spans]}"
                + (" W-Choices" if pol is not None else ""),
                spans=spans, **{k: sum(t[k] for t in spans)
                                for k in ("ms", "device_ms", "plain_ms",
                                          "bytes", "ops")})


HH_POLICIES = ("w", "d", "w_no_rotate", "d_chain4_spread",
               "d_chain4_argmin", "neutral", "neutral_spread")


def hh_policy(name: str, n_bins: int):
    """The HHPolicy grid of the kernel check: W- and D-Choices at their
    defaults, rotation off, a 4-candidate chain whose heavy budgets take
    the full-set fallback (spread in load order, or rotation and spread
    off: the argmin bin), and the neutral policy with and without them."""
    from repro_torch.kernels.blocks import HHPolicy, neutral_hh_policy
    short = dict(scheme="d", chain=4, d_tail=6)
    neutral = neutral_hh_policy(n_bins)
    return {
        "w": HHPolicy(scheme="w"),
        "d": HHPolicy(scheme="d"),
        "w_no_rotate": HHPolicy(scheme="w", rotate_duplicates=False),
        "d_chain4_spread": HHPolicy(**short),
        "d_chain4_argmin": HHPolicy(**short, rotate_duplicates=False,
                                    spread_fallback=False),
        "neutral": neutral,
        "neutral_spread": neutral._replace(rotate_duplicates=True,
                                           spread_fallback=True),
    }[name]


def check_multisource_hh(streams: dict, dev) -> float:
    """The HHPolicy branch of porc_multisource_scan vs the plain
    _porc_multisource_scan(policy=...), bit for bit — assignments, base,
    delta, routed, ticks and both sketch lanes — through the span driver
    with a ragged tail and the state carried across two calls, over
    streams × the cluster grid (S × n_bins × sync × block) × every policy
    of ``hh_policy``. 60,000 bins put the loads in global memory, 17 and
    100 sources the sketch lanes. Also: the kernel split at a step
    boundary equals one call."""
    import torch
    from repro_torch.kernels import ref
    err = 0.0
    for sname, keys in streams.items():
        for S in MS_SOURCES:
            for n in MS_BINS:
                for sync in MS_SYNC:
                    for block in MS_BLOCKS:
                        m, split = ms_lengths(S, block, sync)
                        for pname in HH_POLICIES:
                            out = run_both(keys, n, S, sync, block, split, m,
                                           dev, hh_policy(pname, n))
                            for what, x, y in zip(MS_FIELDS, out["cuda"],
                                                  out["snapshot"]):
                                err = max(err, _same(
                                    f"HH {sname} {pname} S={S} n={n} "
                                    f"sync={sync} block={block} {what}",
                                    x, y))
                    # split at a step boundary == one call, on the kernel
                    pol = hh_policy("w", n)
                    aligned = S * 128 * 4
                    one, st1 = ref.ref_porc_multisource(
                        keys[:aligned], n, S, sync_every=sync, block=128,
                        eps=0.01, engine="cuda", policy=pol, device=dev)
                    parts, st2 = [], None
                    for lo, hi in ((0, S * 128 * 2), (S * 128 * 2, aligned)):
                        a, st2 = ref.ref_porc_multisource(
                            keys[lo:hi], n, S, sync_every=sync, block=128,
                            eps=0.01, state=st2, engine="cuda", policy=pol,
                            device=dev)
                        parts.append(a)
                    for what, x, y in zip(MS_FIELDS, (one,) + tuple(st1),
                                          (torch.cat(parts),) + tuple(st2)):
                        _same(f"HH split {sname} S={S} n={n} sync={sync} "
                              f"{what}", x, y)
            log(f"  HHPolicy {sname} S={S:>3}: {len(HH_POLICIES)} policies "
                f"identical over n_bins {MS_BINS} x sync {MS_SYNC} x block "
                f"{MS_BLOCKS}; split == one call")
    return err


def hh_probes(keys, n, S, sync, block, eps, chunk, base, delta, ticks, skb,
              skd, pol) -> int:
    """Candidates the HHPolicy scan hashes on these inputs: per key, its
    first-fit position + 1 when it resolves, else its whole window
    (replayed with the plain engine's block math)."""
    import torch
    from repro_torch.core.hashing import hash_to_bins
    from repro_torch.kernels import blocks as B
    dev = keys.device
    C = B.hh_chunk(pol, chunk, n)
    salts = B.probe_salts(C, device=dev)
    nb = keys.shape[0] // (S * block)
    kb = keys.reshape(nb, block, S).permute(0, 2, 1)
    base, delta, skb, skd = (x.clone() for x in (base, delta, skb, skd))
    lane = (torch.arange(S, device=dev) * n)[:, None]
    idx = torch.arange(C, device=dev)
    total = 0
    for b in range(nb):
        kblk = kb[b]
        mass = base.sum() + delta.sum(1)
        cap = B.view_cap(eps, n, mass, block / S)
        views = base[None] + delta
        cand = hash_to_bins(kblk[..., None], salts, n)
        bud = B.hh_budgets(pol, n, eps, B.sketch_query_lanes(pol, skb, skd,
                                                             kblk),
                           mass[:, None])
        window = torch.clamp(bud.long(), max=C)
        pos = idx.expand(S, block, C)
        if pol.rotate_duplicates:
            i = torch.arange(block, device=dev)
            eq = kblk[:, :, None] == kblk[:, None, :]
            dup = (eq & (i[None, :] < i[:, None])[None]).sum(2)
            offset = (dup * window) // torch.clamp(eq.sum(2), min=1)
            pos = torch.remainder(idx - offset[..., None],
                                  torch.clamp(window, min=1)[..., None])
        ok = ((views.gather(1, cand.reshape(S, -1).long()).reshape(cand.shape)
               < cap[:, None, None]) & (idx < window[..., None]))
        first = torch.where(ok, pos, torch.full_like(pos, C)).amin(2)
        total += int(torch.where(ok.any(2), first + 1, window).sum())
        a = B.snapshot_block_hh(views, cap, kblk, cand, bud, n,
                                pol.rotate_duplicates, pol.spread_fallback)
        delta.view(-1).index_add_(0, (lane + a.long()).reshape(-1),
                                  torch.ones(S * block, device=dev))
        skd = B.sketch_add_lanes(pol, skd, kblk)
        if (int(ticks) + b + 1) % sync == 0:
            base, delta = base + delta.sum(0), torch.zeros_like(delta)
            skb, skd = skb + B.lane_sum(skd), torch.zeros_like(skd)
    return total


def time_multisource_hh(keys, dev, n: int, S: int, slot: int,
                        block: int) -> dict:
    """The HHPolicy branch at the main path's span shape (one slot's
    128-block span, W-Choices chain of n_bins candidates), from a state
    warmed by ten slots of the same stream."""
    from repro_torch.kernels.blocks import HHPolicy
    return time_ms(keys, dev, n, S, block, slot // S // block,
                   HHPolicy(scheme="w"), warm=10 * slot)


# ---------------------------------------------------------------------------
# Phase 3, the strict engine: porc_assign and porc_multisource_strict
# ---------------------------------------------------------------------------

def check_assign(streams: dict, dev) -> float:
    """porc_assign vs ref_porc_assign, bit for bit, over streams × n_bins
    {8, 100, 480, 1,000, 60,000} × block {1, 64, 128}: a direct call from
    a (load0, m0) continuation; the span driver over a ragged length with
    the state carried across two calls; split at a block boundary == one
    call; block 1 == the per-message oracle. 60,000 bins put the load in
    global memory."""
    import torch
    from repro_torch.core.partitioners import power_of_random_choices
    from repro_torch.kernels import ref
    from repro_torch.kernels.porc_assign import porc_assign
    err = 0.0
    for sname, keys in streams.items():
        for n in (8, 100, 480, 1000, 60_000):
            for blk in (1, 64, 128):
                m = 400 if blk == 1 else 128 * 30
                k = keys[:m].contiguous()
                load0 = torch.arange(n, device=dev, dtype=torch.float32) % 7
                m0 = load0.sum()
                got = porc_assign(k, n, block=blk, eps=0.01, load0=load0,
                                  m0=m0)
                want = ref.ref_porc_assign(k, n, block=blk, eps=0.01,
                                           load0=load0, m0=m0)
                for what, x, y in zip(("assign", "load"), got, want):
                    err = max(err, _same(f"porc_assign {sname} n={n} "
                                         f"block={blk} {what}", x, y))
                rag, split = m + 77, 256
                out = {}
                for eng in ("strict", "strict_ref"):
                    a1, st = ref.ref_porc_route(keys[:split], n, block=blk,
                                                eps=0.01, engine=eng,
                                                device=dev)
                    a2, st = ref.ref_porc_route(keys[split:rag], n,
                                                block=blk, eps=0.01,
                                                state=st, engine=eng,
                                                device=dev)
                    out[eng] = (torch.cat([a1, a2]), st.load, st.routed)
                one, st1 = ref.ref_porc_route(keys[:rag], n, block=blk,
                                              eps=0.01, engine="strict",
                                              device=dev)
                for what, x, y, z in zip(("assign", "load", "routed"),
                                         out["strict"], out["strict_ref"],
                                         (one, st1.load, st1.routed)):
                    err = max(err, _same(f"strict route {sname} n={n} "
                                         f"block={blk} {what}", x, y))
                    _same(f"strict split {sname} n={n} block={blk} {what}",
                          x, z)
                if blk == 1:
                    _same(f"strict block 1 {sname} n={n} vs the oracle", one,
                          power_of_random_choices(keys[:rag], n, eps=0.01,
                                                  device=dev))
            log(f"  porc_assign {sname} n_bins={n:>6} block 1/64/128: "
                "identical (direct, span driver, split == one call; block 1"
                " == oracle)")
    return err


def check_assign_fallback(keys, dev) -> float:
    """The leftover fallback: porc_assign with d=1 or 2 and eps=0 from a
    continuation, against ref_porc_assign, which must show leftovers."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.porc_assign import porc_assign
    err = 0.0
    tally = ref._porc_block.tally
    for n in (100, 60_000):
        for d in (1, 2):
            k = keys[:128 * 20].contiguous()
            load0 = torch.arange(n, device=dev, dtype=torch.float32) % 3
            m0 = load0.sum()
            got = porc_assign(k, n, d=d, block=128, eps=0.0, load0=load0,
                              m0=m0)
            left0 = tally["leftovers"]
            want = ref.ref_porc_assign(k, n, d=d, block=128, eps=0.0,
                                       load0=load0, m0=m0)
            left = tally["leftovers"] - left0
            if left < 1:
                fail(f"fallback n={n} d={d}: the plain version has no "
                     "leftover")
            for what, x, y in zip(("assign", "load"), got, want):
                err = max(err, _same(f"porc_assign fallback n={n} d={d} "
                                     f"{what}", x, y))
            log(f"  porc_assign fallback n_bins={n:>6} d={d} eps=0: "
                f"identical, {left} leftovers")
    return err


def check_multisource_strict(streams: dict, dev) -> float:
    """porc_multisource_strict vs _porc_multisource_scan(engine="strict"),
    bit for bit, through the span driver with a ragged sub-S tail and
    the state carried across two calls, over streams × S {1, 8, 100} ×
    sync {1, 3} × n_bins {20, 480, 1,000} × block {8, 128}; S=1 at sync 1
    equals ref_porc_route(engine="strict")."""
    import torch
    from repro_torch.kernels import ref
    err = 0.0
    fields = ("assign", "base", "delta", "routed", "ticks")
    for sname, keys in streams.items():
        for S in (1, 8, 100):
            for n in (20, 480, 1000):
                for blk in (8, 128):
                    for sync in (1, 3):
                        m = S * blk * 5 + S * 77 + S // 2
                        split = S * blk * 2 + S * 3 + S // 3
                        out = {}
                        for eng in ("strict", "strict_ref"):
                            a1, st = ref.ref_porc_multisource(
                                keys[:split], n, S, sync_every=sync,
                                block=blk, eps=0.01, engine=eng, device=dev)
                            a2, st = ref.ref_porc_multisource(
                                keys[split:m], n, S, sync_every=sync,
                                block=blk, eps=0.01, state=st, engine=eng,
                                device=dev)
                            out[eng] = (torch.cat([a1, a2]), st.base,
                                        st.delta, st.routed, st.ticks)
                        for what, x, y in zip(fields, out["strict"],
                                              out["strict_ref"]):
                            err = max(err, _same(
                                f"multisource strict {sname} S={S} n={n} "
                                f"block={blk} sync={sync} {what}", x, y))
                if S == 1:
                    m = 128 * 5 + 77
                    a_r, s_r = ref.ref_porc_route(keys[:m], n, block=128,
                                                  eps=0.01, engine="strict",
                                                  device=dev)
                    a_m, s_m = ref.ref_porc_multisource(
                        keys[:m], n, 1, block=128, eps=0.01,
                        engine="strict", device=dev)
                    _same(f"S=1 strict {sname} n={n} assign", a_r, a_m)
                    _same(f"S=1 strict {sname} n={n} load", s_r.load,
                          s_m.base + s_m.delta.sum(0))
                log(f"  porc_multisource_strict {sname} S={S:>3} "
                    f"n_bins={n:>5} block 8/128 sync 1/3: identical")
    return err


def check_strict_edges(keys, dev) -> float:
    """The strict kernels at the edges of their design, against the plain
    engines, bit for bit, each from a (load, mass) continuation:
    porc_assign over blocks {1, 33, 128, 1,000} × n_bins {8, 100, 60,000}
    (60,000: the load in global memory, read through L2) and
    porc_multisource_strict over S {1, 7, 100} (source-major warps) ×
    blocks {1, 33, 128, 1,000} × n_bins {8, 10,000} (10,000 at S 7 and
    100: the views through L2; block 1,000 at S 100: the bidder lists in
    global memory), two steps with a merge between, each on the WP
    stream and, at the smaller n_bins, on one key repeated: every key of
    a block bids one bin at every rank, so positions reach block − 1,
    most keys are refused and, at 8 bins, the 32 ranks leave keys to the
    leftover fallback (required at S 7, block 33, eps 0)."""
    import itertools
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.porc_assign import (porc_assign,
                                                 porc_multisource_strict)
    tally = ref._porc_block.tally
    streams = {"WP": keys, "one key": torch.full_like(keys[:200_000],
                                                     int(keys[0]))}
    err = 0.0
    for (sname, k), blk, n in itertools.product(streams.items(),
                                                (1, 33, 128, 1000),
                                                (8, 100, 60_000)):
        if sname == "one key" and n > 100:
            continue
        kk = k[:blk * (64 if blk == 1 else 4)].contiguous()
        load0 = torch.arange(n, device=dev, dtype=torch.float32) % 7
        m0 = load0.sum()
        left0 = tally["leftovers"]
        want = ref.ref_porc_assign(kk, n, block=blk, eps=0.01, load0=load0,
                                   m0=m0)
        got = porc_assign(kk, n, block=blk, eps=0.01, load0=load0, m0=m0)
        for what, x, y in zip(("assign", "load"), got, want):
            err = max(err, _same(f"porc_assign edge {sname} block={blk} "
                                 f"n={n} {what}", x, y))
        log(f"  porc_assign edge {sname:>7} block {blk:>4} n_bins {n:>6}: "
            f"identical, {tally['leftovers'] - left0} leftovers")
    cases = [(sname, k, S, blk, n, 0.01)
             for (sname, k), S, blk, n in itertools.product(
                 streams.items(), (1, 7, 100), (1, 33, 128, 1000),
                 (8, 10_000)) if sname == "WP" or n == 8]
    cases.append(("one key", streams["one key"], 7, 33, 8, 0.0))
    for sname, k, S, blk, n, eps in cases:
        kk = k[:2 * S * blk].contiguous()
        base0 = torch.arange(n, device=dev, dtype=torch.float32) % 5
        delta0 = (torch.arange(S * n, device=dev, dtype=torch.float32)
                  % 3).reshape(S, n)
        ticks0 = torch.tensor(1, dtype=torch.int32, device=dev)
        left0 = tally["leftovers"]
        want = ref._porc_multisource_scan(kk, n, S, 2, blk, eps, 8,
                                          "strict", base0, delta0,
                                          ticks0)[:4]
        left = tally["leftovers"] - left0
        got = porc_multisource_strict(kk, n, S, 2, blk, eps, base0, delta0,
                                      ticks0)
        for what, x, y in zip(("assign", "base", "delta", "ticks"), got,
                              want):
            err = max(err, _same(f"multisource strict edge {sname} S={S} "
                                 f"block={blk} n={n} eps={eps} {what}", x,
                                 y))
        if eps == 0.0 and left < 1:
            fail("multisource strict edge: the eps 0 case left no key to "
                 "the fallback")
        log(f"  porc_multisource_strict edge {sname:>7} S {S:>3} block "
            f"{blk:>4} n_bins {n:>5} eps {eps}: identical, {left} "
            "leftovers")
    return err


def strict_work(run) -> dict:
    """Run the plain strict engine once and read what it walked: source
    blocks, ranks and bids (each bid one hash, a position and a compare)
    and leftovers."""
    from repro_torch.kernels import ref
    tally = ref._porc_block.tally
    before = dict(tally)
    run()
    return {k: tally[k] - before[k] for k in ("blocks", "ranks", "bids",
                                              "leftovers")}


def time_assign(keys, dev, n: int, slot: int, block: int) -> dict:
    """porc_assign at the main path's shape (one slot's full blocks),
    from a state warmed by ten slots of the stream."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.porc_assign import porc_assign
    M = slot // block * block
    warm = 10 * slot
    _, st = ref.ref_porc_route(keys[:warm], n, block=block, eps=0.01,
                               engine="strict", device=dev)
    k = keys[warm: warm + M].contiguous()
    args = dict(block=block, eps=0.01, load0=st.load, m0=st.routed)
    ms = cuda_ms(lambda: porc_assign(k, n, **args), reps=20)
    device_ms = kernel_ms(lambda: porc_assign(k, n, **args), 20,
                          "porc_assign_kernel")
    plain_ms = cuda_ms(lambda: ref.ref_porc_assign(k, n, **args), reps=2,
                       warmup=1)
    work = strict_work(lambda: ref.ref_porc_assign(k, n, **args))
    nbytes = 4 * M * 2 + 4 * n * 2 + 4
    ops = work["bids"] * (OPS_PER_PROBE + 2) + work["ranks"] * block
    return dict(shape=f"M={M} n_bins={n} block={block}", ms=ms,
                device_ms=device_ms, plain_ms=plain_ms, bytes=nbytes,
                ops=ops, ranks_per_block=work["ranks"] / work["blocks"],
                ns_per_rank=ms * 1e6 / work["ranks"], **work)


def time_multisource_strict(keys, dev, n: int, S: int, steps: int,
                            block: int) -> dict:
    """porc_multisource_strict at the Fig 11 shape: ``steps`` steps of S
    blocks, sync 1, from a state warmed by ten such spans of the
    stream."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.porc_assign import porc_multisource_strict
    M = steps * S * block
    warm = 10 * M
    _, st = ref.ref_porc_multisource(keys[:warm], n, S, block=block,
                                     eps=0.01, engine="strict", device=dev)
    k = keys[warm: warm + M].contiguous()
    args = (k, n, S, 1, block, 0.01)
    state = (st.base, st.delta, st.ticks)
    ms = cuda_ms(lambda: porc_multisource_strict(*args, *state), reps=10)
    device_ms = kernel_ms(lambda: porc_multisource_strict(*args, *state),
                          10, "porc_multisource_strict_kernel")

    def plain():
        return ref._porc_multisource_scan(*args, 8, "strict", *state)

    plain_ms = cuda_ms(plain, reps=1, warmup=1)
    work = strict_work(plain)
    nbytes = 4 * M * 2 + 4 * n * 2 + 4 * S * n * 2 + 8
    ops = (work["bids"] * (OPS_PER_PROBE + 2) + work["ranks"] * block
           + steps * (S + 1) * n * 2)                 # masses, merges
    return dict(shape=f"M={M} S={S} n_bins={n} block={block} sync=1", ms=ms,
                device_ms=device_ms, plain_ms=plain_ms, bytes=nbytes, ops=ops,
                ranks_per_block=work["ranks"] / work["blocks"],
                ns_per_rank=ms * 1e6 / work["ranks"], **work)


# ---------------------------------------------------------------------------
# Phase 3, the MoE dispatch: cg_dispatch
# ---------------------------------------------------------------------------

def dispatch_inputs(G: int, T: int, E: int, D: int, skew, dev,
                    seed: int):
    """pref/gates as the router makes them, made on the card: softmax of
    normal logits with a per-expert bias of scale ``skew`` per group,
    experts in stable descending order of probability. ``skew="hot"``
    lifts expert 0 above every other, so every token bids it first."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn((G, T, E), generator=gen, device=dev)
    if skew == "hot":
        logits[..., 0] += 20.0
    else:
        logits += skew * torch.randn((G, 1, E), generator=gen, device=dev)
    gates, pref = torch.sort(torch.softmax(logits, -1), dim=-1,
                             descending=True, stable=True)
    return (pref[..., :D].to(torch.int32).contiguous(),
            gates[..., :D].contiguous())


def skewed_caps(E: int, base: int, ratio: float = 4.0) -> tuple:
    """The capacity vector of ``tests/test_cg_dispatch_properties.py``."""
    w = [ratio ** (-i / max(E - 1, 1)) for i in range(E)]
    return tuple(max(1, int(round(E * base * wi / sum(w)))) for wi in w)


def dispatch_grid():
    """(label, G, T, E, k, D, block, skew, capacity kwargs): the JAX
    tests' grid (``tests/test_kernels_dispatch.py``, the scalar and
    vector sweeps of ``tests/test_cg_dispatch_properties.py``) on three
    groups, the slice's shapes — prefill G=8 × T=1,024 and decode G=1 ×
    T=8 over E=128, k=8, D=12, with uniform and ``capacity_skew`` caps —
    and the kernel's edges: blocks of 2,048 tokens (their rows read from
    global memory), E=16,384 experts (shared memory above 48 KB), D=32,
    k=1 at capacity 1, every token bidding one expert first, G=0."""
    from repro_torch.configs import get_config
    from repro_torch.moe.router import expert_capacity_vector
    moe = get_config("qwen3-moe-235b-a22b").moe
    skew3 = dataclasses.replace(moe, capacity_skew=3.0)
    grid = []
    for T, E, k, D in ((256, 8, 1, 4), (512, 16, 2, 6), (1024, 128, 8, 16),
                       (128, 4, 2, 4)):
        grid.append((f"JAX T={T} E={E} k={k} D={D}", 3, T, E, k, D, 128, 2.0,
                     dict(capacity=max(1, int(1.25 * T * k / E)))))
    for E, k, cf, block in ((4, 1, 1.0, 64), (8, 2, 1.25, 128),
                            (16, 2, 1.25, 64), (16, 4, 1.5, 128),
                            (32, 2, 1.1, 256), (64, 8, 1.25, 128)):
        grid.append((f"scalar E={E} k={k} cf={cf} block={block}", 3, 512, E,
                     k, min(E, k + 4), block, 2.0,
                     dict(capacity=max(1, int(cf * 512 * k / E)))))
    for E, k, block in ((8, 2, 64), (16, 2, 128), (16, 4, 64), (32, 8, 128)):
        grid.append((f"vector E={E} k={k} block={block}", 3, 512, E, k,
                     min(E, k + 4), block, 2.0,
                     dict(capacities=skewed_caps(
                         E, max(1, int(1.25 * 512 * k / E))))))
    for label, G, T in (("prefill", 8, 1024), ("decode", 1, 8)):
        for skew, caps in ((0.0, expert_capacity_vector(moe, T)),
                           (2.0, expert_capacity_vector(moe, T)),
                           (2.0, expert_capacity_vector(skew3, T))):
            kw = (dict(capacity=caps[0]) if len(set(caps)) == 1
                  else dict(capacities=caps))
            grid.append((f"{label} G={G} T={T} skew={skew} "
                         f"{'uniform' if 'capacity' in kw else 'skewed'}",
                         G, T, 128, 8, 12, min(128, T), skew, kw))
    grid.append(("block 2048", 2, 4096, 64, 4, 8, 2048, 2.0,
                 dict(capacity=int(1.25 * 4096 * 4 / 64))))
    grid.append(("E=16384", 2, 256, 16384, 2, 6, 128, 1.0, dict(capacity=1)))
    # the edges of the one-warp design: a long row (D=32), k=1 at
    # capacity 1, every token bidding one expert first, no group at all
    grid.append(("D=32", 2, 512, 64, 8, 32, 128, 2.0,
                 dict(capacity=int(1.25 * 512 * 8 / 64))))
    grid.append(("k=1 capacity 1", 3, 256, 16, 1, 4, 128, 2.0,
                 dict(capacity=1)))
    grid.append(("one expert hot", 2, 1024, 128, 8, 12, 128, "hot",
                 dict(capacity=80)))
    grid.append(("G=0", 0, 256, 16, 2, 6, 128, 1.0, dict(capacity=8)))
    return grid


def check_dispatch(dev) -> float:
    """cg_dispatch vs ref_cg_dispatch on the card, bit for bit (assign,
    slot, weights, load) over ``dispatch_grid``, with the kernel the plan
    picks and with the other one where it fits; the group axis equals
    per-group calls."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.cg_dispatch import cg_dispatch, dispatch_plan
    err = 0.0
    for i, (label, G, T, E, k, D, block, skew, kw) in enumerate(
            dispatch_grid()):
        pref, gates = dispatch_inputs(G, T, E, D, skew, dev, seed=i)
        args = dict(n_experts=E, k=k, block=block, **kw)
        got = cg_dispatch(pref, gates, **args)
        want = ref.ref_cg_dispatch(pref, gates, **args)
        for what, x, y in zip(("assign", "slot", "weights", "load"), got,
                              want):
            err = max(err, _same(f"cg_dispatch {label} {what}", x, y))
        # the kernel the plan did not pick, where it fits too
        other = "warp" if dispatch_plan(E, block, D, k)[0] == "cta" \
            else "cta"
        try:
            dispatch_plan(E, block, D, k, other)
        except ValueError:
            other = None
        if other:
            for what, x, y in zip(("assign", "slot", "weights", "load"),
                                  cg_dispatch(pref, gates, kernel=other,
                                              **args), want):
                _same(f"cg_dispatch {label} {other} kernel {what}", x, y)
        if G:
            one = cg_dispatch(pref[-1], gates[-1], **args)
            for what, x, y in zip(("assign", "slot", "weights", "load"),
                                  one, got):
                _same(f"cg_dispatch {label} last group alone {what}", x,
                      y[-1])
        elif got[3].shape != (0, E):
            fail(f"cg_dispatch {label}: load of shape {got[3].shape}")
        drop = float((got[0] < 0).float().mean()) if G else 0.0
        log(f"  cg_dispatch {label}: identical (G={G}, drop frac "
            f"{drop:.4f}; {dispatch_plan(E, block, D, k)[0]} kernel"
            + (f", and the {other} kernel" if other else "") + ")")
    return err


def dispatch_bids(pref, assign, k: int) -> int:
    """Bids the dispatch makes on these inputs: a token bids at every
    rank up to the one that gives it its k-th slot, or at all D ranks."""
    import torch
    last = assign[..., k - 1:k]
    at = (pref == last).to(torch.int32).argmax(-1) + 1
    return int(torch.where(last[..., 0] >= 0, at,
                           torch.full_like(at, pref.shape[-1])).sum())


def time_dispatch(dev, G: int, T: int, skew: float = 0.0,
                  skewed_caps: bool = False, plain: bool = True,
                  kernel: str | None = None) -> dict:
    """cg_dispatch at a main-path shape of qwen3-moe-235b-a22b (E=128,
    k=8, D=12, capacities from the router's formula: uniform, or with
    ``skewed_caps`` those of ``capacity_skew=3.0``, made on the card
    once), on router-like inputs, with the kernel the plan picks or
    ``kernel``; with ``plain`` the plain version's time too."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.cg_dispatch import cg_dispatch
    from repro_torch.moe.router import expert_capacity_vector
    moe = get_config("qwen3-moe-235b-a22b").moe
    if skewed_caps:
        moe = dataclasses.replace(moe, capacity_skew=3.0)
    E, k = moe.n_experts, moe.top_k
    D = k + moe.overflow_depth
    caps = expert_capacity_vector(moe, T)
    pref, gates = dispatch_inputs(G, T, E, D, skew, dev, seed=99)
    args = dict(n_experts=E, k=k, block=min(128, T),
                capacities=torch.tensor(caps, dtype=torch.float32,
                                        device=dev))
    if kernel:
        args["kernel"] = kernel
    C = caps[0] if len(set(caps)) == 1 else f"{min(caps)}-{max(caps)}"
    ms = cuda_ms(lambda: cg_dispatch(pref, gates, **args), reps=50)
    device_ms = kernel_ms(lambda: cg_dispatch(pref, gates, **args), 50,
                          "cg_dispatch_kernel")
    plain_ms = (cuda_ms(lambda: ref.ref_cg_dispatch(
        pref, gates, **{a: v for a, v in args.items() if a != "kernel"}),
        reps=3, warmup=1) if plain else None)
    assign = cg_dispatch(pref, gates, **args)[0]
    bids = dispatch_bids(pref, assign, k)
    placed = int((assign >= 0).sum())
    # pref read at the ranks bid, gates at the bids accepted, caps once;
    # assign, slot and weights written, the load written per group
    nbytes = 4 * (bids + placed) + 4 * E + 12 * G * T * k + 4 * G * E
    # per bid: its position, a load read, an add, a compare, three
    # writes and the load's add; per token the k-term sum and k divisions
    ops = bids * 8 + G * T * 2 * k
    return dict(shape=f"G={G} T={T} E={E} k={k} D={D} C={C} skew={skew}",
                ms=ms, device_ms=device_ms, plain_ms=plain_ms, bytes=nbytes,
                ops=ops, bids=bids,
                drop_frac=float((assign < 0).float().mean()))


# ---------------------------------------------------------------------------
# Phase 3, the Mamba-2 scan: ssd_scan
# ---------------------------------------------------------------------------

# tests/test_kernels_ssd.py's bounds on max|a - b| / max|a|: against the
# sequential recurrence in f32, against the plain chunked scan in f32,
# and in bf16 (both rounded to bf16 at the end)
SSD_TOL = {"ref": 1e-4, "chunked": 1e-5, "bf16": 3e-2}


def ssd_inputs(B: int, L: int, H: int, P: int, G: int, N: int, dev,
               dtype=None, seed: int = 0):
    """The inputs of ``tests/test_kernels_ssd.py::_inputs``, drawn on the
    card: x normal; dt = softplus(normal)·0.1 (f32); A = −exp(0.5·normal);
    B, C normal/√N; x, B and C in ``dtype`` (f32 by default)."""
    import torch
    dtype = dtype or torch.float32
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = normal(B, L, H, P).to(dtype)
    dt = torch.nn.functional.softplus(normal(B, L, H)) * 0.1
    A = -torch.exp(normal(H) * 0.5)
    Bm = (normal(B, L, G, N) / N ** 0.5).to(dtype)
    Cm = (normal(B, L, G, N) / N ** 0.5).to(dtype)
    return x, dt, A, Bm, Cm


def relerr(a, b) -> float:
    """max|a − b| / max|a|, the tests' measure."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / (a.abs().max() + 1e-9))


def ssd_model_shapes():
    """(arch, B, L, H, P, G, N, Q) of the SSD scan in phase 7's prefills:
    zamba2-2.7b on 8 × 1,024 tokens, mamba2-130m on 8 × 4,096."""
    from repro_torch.configs import get_config
    shapes = []
    for arch, L in (("zamba2-2.7b", 1024), ("mamba2-130m", 4096)):
        cfg = get_config(arch)
        s = cfg.ssm
        H = s.expand * cfg.d_model // s.head_dim
        shapes.append((arch, 8, L, H, s.head_dim, s.n_groups, s.d_state,
                       s.chunk))
    return shapes


def check_ssd(dev, model_shapes=None) -> dict:
    """ssd_scan (y and the final state) against ``ref_ssd_scan``, the
    exact sequential recurrence, and against the plain ``ssd_chunked``,
    on the card, within ``SSD_TOL``: the JAX tests' grid
    (``tests/test_kernels_ssd.py``) in f32 and bf16, chunk invariance
    Q ∈ {16, 32, 64, 128}, C ≡ 0 (y exactly 0), a chunk that divides
    neither 16 nor 128 (Q = 93, as ``pick_chunk`` gives a 1,023-token
    prompt), and the two models' prefill shapes in f32 and bf16. Returns
    the largest absolute and relative errors against the plain version."""
    import torch
    from repro_torch.kernels.ref import ref_ssd_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.mamba2 import ssd_chunked
    bf16 = torch.bfloat16
    worst = dict(max_abs_err=0.0, max_rel_err=0.0)

    def hold(label, inputs, Q, against_ref=True):
        x = inputs[0]
        before = ssd_scan.launches
        y, h = ssd_scan(*inputs, chunk=Q, return_state=True)
        if x.is_cuda:
            torch.cuda.synchronize()
        if not (bool(y.isfinite().all()) and bool(h.isfinite().all())):
            fail(f"ssd_scan {label}: not finite")
        if not torch.equal(ssd_scan(*inputs, chunk=Q), y):
            fail(f"ssd_scan {label}: y differs without return_state")
        if x.is_cuda and ssd_scan.launches != before + 2:
            fail(f"ssd_scan {label}: the kernel did not launch")
        yc, hc = ssd_chunked(*inputs, Q, return_state=True)
        tol = SSD_TOL["chunked" if x.dtype == torch.float32 else "bf16"]
        errs = [relerr(yc, y), relerr(hc, h)]
        worst["max_abs_err"] = max(worst["max_abs_err"],
                                   float((yc.float() - y.float()).abs().max()),
                                   float((hc - h).abs().max()))
        worst["max_rel_err"] = max(worst["max_rel_err"], *errs)
        msg = f"vs ssd_chunked y {errs[0]:.2e} h {errs[1]:.2e}"
        if max(errs) >= tol:
            fail(f"ssd_scan {label}: {msg} (bound {tol})")
        if against_ref:
            yr, hr = ref_ssd_scan(*inputs, return_state=True)
            tol = SSD_TOL["ref" if x.dtype == torch.float32 else "bf16"]
            ref_errs = [relerr(yr, y), relerr(hr, h)]
            msg += f"; vs ref_ssd_scan y {ref_errs[0]:.2e} h {ref_errs[1]:.2e}"
            if max(ref_errs) >= tol:
                fail(f"ssd_scan {label}: {msg} (bound {tol})")
        log(f"  ssd_scan {label}: {msg}")
        return y

    grid = [(2, 128, 4, 32, 1, 64, 32), (1, 256, 8, 64, 2, 128, 64),
            (1, 256, 6, 16, 3, 32, 128)]
    for i, (B, L, H, P, G, N, Q) in enumerate(grid):
        hold(f"JAX grid B={B} L={L} H={H} P={P} G={G} N={N} Q={Q}",
             ssd_inputs(B, L, H, P, G, N, dev, seed=i), Q)
    inputs = ssd_inputs(1, 128, 4, 16, 1, 32, dev, seed=5)
    y128 = ssd_scan(*inputs, chunk=128)
    for Q in (16, 32, 64, 128):
        yq = hold(f"chunk invariance Q={Q}", inputs, Q)
        if relerr(y128, yq) >= SSD_TOL["ref"]:
            fail(f"ssd_scan: chunk {Q} differs from chunk 128 "
                 f"({relerr(y128, yq):.2e})")
    hold("bf16 B=1 L=128 H=4 P=32 N=64 Q=64",
         ssd_inputs(1, 128, 4, 32, 1, 64, dev, bf16, seed=6), 64)
    hold("Q=93 L=1023 H=8 P=64 N=64",
         ssd_inputs(2, 1023, 8, 64, 1, 64, dev, seed=7), 93)
    x, dt, A, Bm, Cm = ssd_inputs(1, 64, 2, 8, 1, 16, dev, seed=8)
    y, h = ssd_scan(x, dt, A, Bm, torch.zeros_like(Cm), chunk=16,
                    return_state=True)
    if float(y.abs().max()) != 0.0 or float(h.abs().max()) == 0.0:
        fail("ssd_scan: C ≡ 0 must give y exactly 0 (and a state)")
    log("  ssd_scan C ≡ 0: y exactly 0")
    for arch, B, L, H, P, G, N, Q in model_shapes or ssd_model_shapes():
        for dtype in (torch.float32, bf16):
            hold(f"{arch} prefill B={B} L={L} H={H} P={P} N={N} Q={Q} "
                 f"{str(dtype).split('.')[1]}",
                 ssd_inputs(B, L, H, P, G, N, dev, dtype, seed=9), Q)
    return worst


def time_ssd(dev, arch: str, B: int, L: int, H: int, P: int, G: int,
             N: int, Q: int, plain: bool = True) -> dict:
    """ssd_scan at a prefill shape of the main path, bf16 as the model
    runs it, with the final state (as ``prefill_step`` asks); the plain
    ``ssd_chunked`` on the same inputs. The operations are held against
    the bf16 tensor-core rate (bf16 × bf16 products are exact in an f32
    accumulator); ``bound_f32_ms`` keeps them at the f32 FMA rate, the
    bound of the rows before the kernel ran on tensor cores."""
    import torch
    from repro_torch.kernels.ssd_scan import (ctas_per_sm, resident_ctas,
                                              ssd_scan)
    from repro_torch.models.mamba2 import ssd_chunked
    inputs = ssd_inputs(B, L, H, P, G, N, dev, torch.bfloat16, seed=11)
    ms = cuda_ms(lambda: ssd_scan(*inputs, chunk=Q, return_state=True),
                 reps=20)
    device_ms = kernel_ms(lambda: ssd_scan(*inputs, chunk=Q,
                                           return_state=True), 20,
                          "ssd_scan_kernel")
    plain_ms = cuda_ms(lambda: ssd_chunked(*inputs, Q, return_state=True),
                       reps=3, warmup=1) if plain else None
    # x, B, C in bf16 and dt, A in f32 read once; y in bf16 and the
    # final state in f32 written once
    nbytes = (2 * B * L * H * P + 4 * B * L * H + 4 * H
              + 2 * 2 * B * L * G * N + 2 * B * L * H * P + 4 * B * H * P * N)
    # per chunk: C·Bᵀ over N and the weights times x over P, each on the
    # Q(Q+1)/2 entries of the causal lower triangle with its diagonal
    # (the rest is masked to 0 and needs no work); C·h0ᵀ [Q, P] over N
    # and the state update [P, N] over Q
    ops = B * H * (L // Q) * (Q * (Q + 1) * (N + P) + 4 * Q * P * N)
    return dict(shape=f"{arch} B={B} L={L} H={H} P={P} G={G} N={N} Q={Q} "
                "bf16", ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                bytes=nbytes, ops=ops, ops_per_s=BF16_TC_OPS_PER_S,
                bound_f32_ms=max(nbytes / HBM_BYTES_PER_S,
                                 ops / OPS_PER_S) * 1e3,
                ctas_per_sm=resident_ctas(P, N, Q),
                ctas_per_sm_planned=ctas_per_sm(P, N, Q))


# the backward against the plain ``ssd_chunked_bwd`` on the same CUDA
# tensors, max|a − b| / max|a| per gradient: 1e-4 for what is f32 (every
# gradient of f32 inputs; ddt and dA of bf16 ones), where the two differ
# in the order of their sums (the bound of the forward against the
# sequential recurrence); 3e-2 for dx, dB and dC of bf16 inputs, each
# rounded once to bf16 from f32 sums (the forward's bf16 bound)
SSD_BWD_TOL = {"f32": 1e-4, "bf16": 3e-2}
SSD_GRADS = ("dx", "ddt", "dA", "dBm", "dCm")
# the backward's rows of the kernels line, one per shape of
# ``ssd_train_shapes``; it replaces no TPU kernel, but XLA's autodiff of
# the reference's ssd_chunked (the "replaces" of its rows)
BWD_ROWS = ("ssd_scan_bwd", "ssd_scan_bwd[zamba2 2x4096]",
            "ssd_scan_bwd[mamba2]")


def ssd_train_shapes():
    """(label, B, L, H, P, G, N, Q) of the SSD backward in phase 9's train
    steps: zamba2-2.7b on 8 × 1,024 and 2 × 4,096 tokens, mamba2-130m on
    8 × 4,096."""
    (_, _, _, *zamba2), (_, _, _, *mamba2) = ssd_model_shapes()
    return [("zamba2-2.7b", 8, 1024, *zamba2),
            ("zamba2-2.7b", 2, 4096, *zamba2),
            ("mamba2-130m", 8, 4096, *mamba2)]


def ssd_cotangent(x, seed: int):
    """A normal cotangent of y, in x's dtype, drawn on x's device."""
    import torch
    gen = torch.Generator(device=x.device).manual_seed(seed)
    return torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)


def check_ssd_bwd(dev) -> dict:
    """ssd_scan_bwd (the CUDA backward) against the plain
    ``ssd_chunked_bwd`` on the same CUDA tensors, within ``SSD_BWD_TOL``:
    the JAX SSD tests' grid (G 1, 2, 3) in f32 and bf16, chunk invariance
    Q ∈ {16, 32, 64, 128} (each also within 1e-4 of chunk 128), C ≡ 0
    (dx, ddt, dA and dB exactly 0, dC not), and phase 9's three training
    shapes in bf16. Returns the largest absolute and relative errors."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd
    from repro_torch.models.mamba2 import ssd_chunked_bwd
    bf16 = torch.bfloat16
    worst = dict(max_abs_err=0.0, max_rel_err=0.0)

    def hold(label, inputs, Q, seed):
        dy = ssd_cotangent(inputs[0], seed)
        before = ssd_scan_bwd.launches
        got = ssd_scan_bwd(*inputs, dy, chunk=Q)
        torch.cuda.synchronize()
        if ssd_scan_bwd.launches != before + 1:
            fail(f"ssd_scan_bwd {label}: the kernel did not launch")
        want = ssd_chunked_bwd(*inputs, dy, Q)
        errs = []
        for name, w, g in zip(SSD_GRADS, want, got):
            if g.dtype != w.dtype or g.shape != w.shape \
                    or not bool(g.isfinite().all()):
                fail(f"ssd_scan_bwd {label}: {name} is not finite of "
                     f"{w.dtype} {tuple(w.shape)}")
            err = relerr(w, g)
            errs.append(err)
            worst["max_abs_err"] = max(worst["max_abs_err"], float(
                (w.float() - g.float()).abs().max()))
            worst["max_rel_err"] = max(worst["max_rel_err"], err)
            tol = SSD_BWD_TOL["bf16" if g.dtype == bf16 else "f32"]
            if not err < tol:
                fail(f"ssd_scan_bwd {label}: {name} {err:.2e} from "
                     f"ssd_chunked_bwd (bound {tol})")
        log(f"  ssd_scan_bwd {label}: vs ssd_chunked_bwd "
            + ", ".join(f"{n} {e:.2e}" for n, e in zip(SSD_GRADS, errs)))
        return got

    grid = [(2, 128, 4, 32, 1, 64, 32), (1, 256, 8, 64, 2, 128, 64),
            (1, 256, 6, 16, 3, 32, 128)]
    for dtype in (torch.float32, bf16):
        for i, (B, L, H, P, G, N, Q) in enumerate(grid):
            hold(f"JAX grid B={B} L={L} H={H} P={P} G={G} N={N} Q={Q} "
                 f"{str(dtype).split('.')[1]}",
                 ssd_inputs(B, L, H, P, G, N, dev, dtype, seed=20 + i), Q,
                 seed=30 + i)
    inputs = ssd_inputs(1, 128, 4, 16, 1, 32, dev, seed=24)
    at128 = hold("chunk invariance Q=128", inputs, 128, seed=34)
    for Q in (16, 32, 64):
        got = hold(f"chunk invariance Q={Q}", inputs, Q, seed=34)
        for name, a, b in zip(SSD_GRADS, at128, got):
            if not relerr(a, b) < SSD_BWD_TOL["f32"]:
                fail(f"ssd_scan_bwd: {name} at chunk {Q} differs from "
                     f"chunk 128 ({relerr(a, b):.2e})")
    x, dt, A, Bm, Cm = ssd_inputs(1, 64, 2, 8, 1, 16, dev, seed=25)
    got = hold("C ≡ 0", (x, dt, A, Bm, torch.zeros_like(Cm)), 16, seed=35)
    if any(float(g.abs().max()) != 0.0 for g in got[:4]) \
            or float(got[4].abs().max()) == 0.0:
        fail("ssd_scan_bwd: C ≡ 0 must give dx, ddt, dA, dB exactly 0 "
             "and dC not")
    for i, (arch, B, L, H, P, G, N, Q) in enumerate(ssd_train_shapes()):
        hold(f"{arch} train B={B} L={L} H={H} P={P} N={N} Q={Q} bfloat16",
             ssd_inputs(B, L, H, P, G, N, dev, bf16, seed=26 + i), Q,
             seed=36 + i)
    return worst


def time_ssd_bwd(dev, arch: str, B: int, L: int, H: int, P: int, G: int,
                 N: int, Q: int, plain: bool = True) -> dict:
    """ssd_scan_bwd at a training shape of phase 9, bf16 as the model runs
    it: ``ms`` between CUDA events, ``device_ms`` the sum of the device
    times of every kernel the call launches (names holding "_bwd_"; each
    kernel's own in ``kernels_ms``), the plain ``ssd_chunked_bwd`` on the
    same inputs, and the CTAs an SM holds of the chunk body (the
    occupancy calculator, and ``bwd_plan``'s count from shared memory and
    threads; None for a tree without them). The operations, the
    backward's own on the causal triangle, are held against the bf16
    tensor-core rate, the card's peak for the operands' type, as
    ``time_ssd`` holds the forward; ``bound_f32_ms`` keeps them at the f32
    FMA rate, the yardstick of the FMA kernel, which f32 inputs run on."""
    import importlib
    import torch
    from repro_torch.models.mamba2 import ssd_chunked_bwd
    mod = importlib.import_module("repro_torch.kernels.ssd_scan")
    inputs = ssd_inputs(B, L, H, P, G, N, dev, torch.bfloat16, seed=13)
    dy = ssd_cotangent(inputs[0], 14)

    def run():
        return mod.ssd_scan_bwd(*inputs, dy, chunk=Q)

    ms = cuda_ms(run, reps=10)
    device_ms, each = call_kernels_ms(run, 10, "_bwd_")
    plain_ms = cuda_ms(lambda: ssd_chunked_bwd(*inputs, dy, Q), reps=2,
                       warmup=1) if plain else None
    resident = getattr(mod, "bwd_resident_ctas", None)
    plan = getattr(mod, "bwd_plan", None)
    # x, dy, B, C in bf16 and dt, A in f32 read once; dx, dB, dC in bf16
    # and ddt, dA in f32 written once
    nbytes = (2 * 2 * B * L * H * P + 4 * B * L * H + 4 * H
              + 2 * 2 * B * L * G * N + 2 * B * L * H * P + 4 * B * L * H
              + 2 * 2 * B * L * G * N + 4 * H)
    # per chunk and head, in multiply-adds: G = C·Bᵀ over N and D = dy·xᵀ
    # over P, then dx over P and dB, dC over N, each on the Q(Q+1)/2
    # entries of the causal triangle; five [P, N] products over Q (the
    # entering state, the three inter-chunk terms, dh); two operations each
    nc = L // Q
    ops = B * H * nc * (Q * (Q + 1) * (3 * N + 2 * P) + 10 * Q * P * N)
    return dict(shape=f"{arch} train B={B} L={L} H={H} P={P} G={G} N={N} "
                f"Q={Q} bf16", ms=ms, device_ms=device_ms,
                kernels_ms={re.search(r"\w*_bwd_\w*(<\d+>)?", k)[0]: v
                            for k, v in each.items()},
                plain_ms=plain_ms, bytes=nbytes, ops=ops,
                ops_per_s=BF16_TC_OPS_PER_S,
                bound_f32_ms=max(nbytes / HBM_BYTES_PER_S,
                                 ops / OPS_PER_S) * 1e3,
                ctas_per_sm=resident(P, N, Q) if resident else None,
                ctas_per_sm_planned=(plan(B, L, H, P, G, N, Q)[
                    "ctas_per_sm"]["chunk"] if plan else None))


def bound(t: dict) -> tuple[float, str]:
    by_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
    by_ops = t["ops"] / t.get("ops_per_s", OPS_PER_S) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

def run_cg(name: str, cfg, keys, caps, frac, dev, kernel: str,
           check_launches: bool = True):
    """Drive ``cg.run`` once with the launch counts zeroed just before
    and read just after; check and summarize what came out. Returns
    (summary dict, CGResult)."""
    import torch
    from repro_torch.core import cg, partitioners, simulation
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    zero_counts()
    t0 = time.perf_counter()
    res = cg.run(cfg, keys, caps, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    launches = read_counts()
    check_counts(name, launches, kernel, dev, check_launches)
    m = keys.shape[0]
    V = cfg.n_workers * cfg.alpha
    owner = res.state.vw_owner
    owned = torch.bincount(owner.long(), minlength=cfg.n_workers)
    conserved = bool(owner.shape[0] == V and int(owner.min()) >= 0
                     and int(owner.max()) < cfg.n_workers
                     and int(owned.sum()) == V)
    if not conserved:
        fail(f"{name}: VW population not conserved")
    if res.assignment.shape != (m,) or int(res.assignment.min()) < 0 \
            or int(res.assignment.max()) >= cfg.n_workers:
        fail(f"{name}: assignment out of range")
    for f in ("imbalance", "mean_latency", "utilization"):
        if not bool(torch.isfinite(getattr(res, f)).all()):
            fail(f"{name}: non-finite {f}")
    if float(res.state.vw_load.double().sum()) != float(m):
        fail(f"{name}: routed load does not add up to the stream")
    # Fig 14/15 analogue on the last third (bench_deployment.py:35-37)
    tail = res.assignment[2 * m // 3:]
    kg = partitioners.key_grouping(keys[2 * m // 3:], cfg.n_workers)
    fr = torch.as_tensor(frac, dtype=torch.float32, device=dev)
    service_ms = 0.5
    offered = float(frac.sum()) / (service_ms * 1e-3) * 0.75
    d_cg = simulation.simulate_deployment(tail, cfg.n_workers, service_ms,
                                          fr, offered)
    d_kg = simulation.simulate_deployment(kg, cfg.n_workers, service_ms,
                                          fr, offered)
    imb = res.imbalance
    slots = m // cfg.slot_len
    out = dict(
        run=name, messages=m, seconds=secs, msgs_per_s=m / secs,
        host_ms_per_slot=secs / slots * 1e3,
        vw_spread=vw_spread(keys, res.vw_assignment, V, cfg.hot_fraction),
        imbalance_first3=float(imb[:3].mean()),
        imbalance_last3=float(imb[-3:].mean()),
        moves=int(res.moves), vw_conserved=conserved, launches=launches,
        kg_cg_mean_latency_ratio=float(d_kg.mean_latency_ms
                                       / d_cg.mean_latency_ms),
        kg_cg_throughput_ratio=float(d_kg.throughput / d_cg.throughput))
    log(f"  {name}: {m} msgs in {secs:.3f} s = {m / secs:,.0f} msgs/s, "
        f"host {out['host_ms_per_slot']:.3f} ms/slot; "
        f"imbalance first3 {out['imbalance_first3']:.4f} last3 "
        f"{out['imbalance_last3']:.4f}; moves {out['moves']}; VWs conserved "
        f"{conserved}; launches {launches}; KG/CG mean latency "
        f"{out['kg_cg_mean_latency_ratio']:.3f}; distinct VWs per key: "
        f"10 hottest {out['vw_spread']['top10']:.2f}, tail "
        f"{out['vw_spread']['tail']:.3f}")
    return out, res


def vw_spread(keys, vw, n_vw: int, hot_fraction: float) -> dict:
    """Mean number of distinct VWs the 10 hottest keys, and the tail keys
    (exact count below ``hot_fraction`` of the stream), land on."""
    import torch
    pairs = torch.unique(keys.long() * n_vw + vw.long())
    _, per_key = torch.unique(pairs // n_vw, return_counts=True)
    _, count = torch.unique(keys.long(), return_counts=True)
    top = torch.argsort(count, descending=True)[:10]
    tail = count < hot_fraction * keys.shape[0]
    return dict(top10=float(per_key[top].double().mean()),
                tail=float(per_key[tail].double().mean()),
                tail_keys=int(tail.sum()))


def paper_caps():
    """Capacities of the paper's simulation setup (§VII, ``PAPER_CG``'s 10
    workers): y=3 machines 5× faster, at ρ=0.8."""
    from repro_torch.configs.paper_stream import PAPER_CG, RHO
    from repro_torch.core import streams
    return streams.heterogeneous_capacities(PAPER_CG.n_workers, 3, 5.0) / RHO


def deployment_config():
    """The Fig 14/15 deployment: (CGConfig, capacities, cpulimit
    fractions) — 24 workers × α=20, slot 5,000, 16 moves, 8 sources,
    two executors at 30%."""
    import numpy as np
    from repro_torch.configs.paper_stream import (CPULIMIT_FRACTION, RHO,
                                                  STORM_SOURCES,
                                                  STORM_WORKERS)
    from repro_torch.core import cg
    W = STORM_WORKERS
    frac = np.concatenate([[CPULIMIT_FRACTION] * 2, np.ones(W - 2)])
    cfg = cg.CGConfig(n_workers=W, alpha=20, eps=0.01, slot_len=5_000,
                      max_moves_per_slot=16, n_sources=STORM_SOURCES,
                      engine="auto")
    return cfg, frac / frac.sum() / RHO, frac


def main_path(dev, seed: int, wp_keys, scale: float = 1.0,
              check_launches: bool = True, tw_keys=None):
    """The two policy-free main-path configurations; ``scale`` < 1 cuts
    the stream for a rehearsal on the CPU. ``tw_keys`` is (b)'s stream,
    sampled here when not given. Returns (the runs' summaries, (a)'s
    block-1 VW assignment)."""
    import torch
    from repro_torch.configs.paper_stream import PAPER_CG
    from repro_torch.core import cg
    runs = []
    # (a) the paper's simulation setup, heterogeneous y=3 z=5 at rho=0.8
    caps = paper_caps()
    frac = caps / caps.max()
    slot = PAPER_CG.slot_len
    m = int(WP_TABLE1["n_messages"] * scale) // slot * slot
    cfg128 = PAPER_CG._replace(block_size=128, engine="auto")
    out, _ = run_cg("paper_wp_block128", cfg128, wp_keys[:m], caps, frac, dev,
                    "porc_snapshot", check_launches)
    runs.append(out)
    m1 = max(m // 10 // slot, 2) * slot
    cfg1 = PAPER_CG._replace(block_size=1, engine="auto")
    out, res1 = run_cg("paper_wp_block1", cfg1, wp_keys[:m1], caps, frac,
                       dev, "porc_snapshot", check_launches)
    # block 1 is bit-identical to PAPER_CG's per-message oracle
    m_or = 2 * slot
    oracle = cg.run(PAPER_CG, wp_keys[:m_or].cpu(), caps, device="cpu")
    same = torch.equal(oracle.vw_assignment, res1.vw_assignment[:m_or].cpu())
    if not same:
        fail("block_size=1 differs from the block_size=0 oracle")
    out["oracle_prefix_identical"] = m_or
    log(f"  paper_wp_block1: first {m_or} messages identical to the "
        "per-message oracle (block_size=0, CPU)")
    runs.append(out)
    block1_vw = res1.vw_assignment
    del res1, oracle

    # (b) the Fig 14/15 deployment: 24 workers, two executors at 30%
    cfg_b, caps_b, frac_b = deployment_config()
    mb = int(TW_MAIN_MESSAGES * scale) // cfg_b.slot_len \
        * cfg_b.slot_len
    if tw_keys is None:
        tw_keys = sample(TW_TABLE1, seed + 1, mb, dev)
    out, _ = run_cg("deployment_tw_sources8", cfg_b, tw_keys[:mb], caps_b,
                    frac_b, dev, "porc_multisource_scan", check_launches)
    runs.append(out)
    return runs, block1_vw


def hh_path(dev, wp_keys, tw_keys, base_runs: list[dict], scale: float = 1.0,
            check_launches: bool = True) -> list[dict]:
    """The heavy-hitter main path through the HHPolicy kernel: (c) the
    deployment with W-Choices on (b)'s stream, (d) the paper's setup at
    block 128 with D-Choices on the prefix (a) block 1 routed. Each run's
    key spread is printed beside its policy-free twin's."""
    from repro_torch.configs.paper_stream import PAPER_CG
    twin = {r["run"]: r for r in base_runs}
    runs = []
    cfg_b, caps_b, frac_b = deployment_config()
    mb = int(TW_MAIN_MESSAGES * scale) // cfg_b.slot_len \
        * cfg_b.slot_len
    cfg_c = cfg_b._replace(hh_scheme="WCHOICES")
    out, _ = run_cg("deployment_tw_sources8_wchoices", cfg_c, tw_keys[:mb],
                    caps_b, frac_b, dev, "porc_multisource_scan_hh",
                    check_launches)
    out["policy_free_twin"] = "deployment_tw_sources8"
    runs.append(out)
    caps = paper_caps()
    m1 = twin["paper_wp_block1"]["messages"]
    cfg_d = PAPER_CG._replace(block_size=128, engine="auto",
                              hh_scheme="DCHOICES")
    out, _ = run_cg("paper_wp_block128_dchoices", cfg_d, wp_keys[:m1], caps,
                    caps / caps.max(), dev, "porc_multisource_scan_hh",
                    check_launches)
    out["policy_free_twin"] = "paper_wp_block1"
    runs.append(out)
    b = twin["deployment_tw_sources8"]["vw_spread"]
    for r in runs:
        t = twin[r["policy_free_twin"]]["vw_spread"]
        log(f"  {r['run']}: distinct VWs per key, 10 hottest "
            f"{r['vw_spread']['top10']:.2f} (policy-free twin "
            f"{t['top10']:.2f}, (b) {b['top10']:.2f}), tail "
            f"{r['vw_spread']['tail']:.3f} (policy-free twin {t['tail']:.3f},"
            f" (b) {b['tail']:.3f}); HH kernel launches "
            f"{r['launches']['porc_multisource_scan_hh']}")
    return runs


def strict_path(dev, wp_keys, block1_vw, scale: float = 1.0,
                check_launches: bool = True) -> list[dict]:
    """(f) the paper's setup of (a) with ``engine="strict"`` (the
    porc_assign kernel): at block 128 on the whole stream, and at block 1
    on the prefix (a) routed at block 1, which must give (a)'s block-1
    assignments (``block1_vw``)."""
    import torch
    from repro_torch.configs.paper_stream import PAPER_CG
    caps = paper_caps()
    frac = caps / caps.max()
    slot = PAPER_CG.slot_len
    m = int(WP_TABLE1["n_messages"] * scale) // slot * slot
    runs = []
    cfg = PAPER_CG._replace(block_size=128, engine="strict")
    out, _ = run_cg("paper_wp_block128_strict", cfg, wp_keys[:m], caps, frac,
                    dev, "porc_assign", check_launches)
    runs.append(out)
    m1 = block1_vw.shape[0]
    cfg1 = PAPER_CG._replace(block_size=1, engine="strict")
    out, res = run_cg("paper_wp_block1_strict", cfg1, wp_keys[:m1], caps,
                      frac, dev, "porc_assign", check_launches)
    if not torch.equal(res.vw_assignment, block1_vw):
        fail("(f) strict at block 1 differs from (a)'s block-1 run")
    out["equals_snapshot_block1"] = m1
    log(f"  paper_wp_block1_strict: all {m1} assignments identical to "
        "paper_wp_block1 (the snapshot kernel)")
    runs.append(out)
    return runs


def fig11_path(dev, wp_keys, scale: float = 1.0,
               check_launches: bool = True) -> list[dict]:
    """(g) the Fig 11 point: 100 sources route (a)'s WP stream onto 1,000
    VWs (100 workers × α=10), ε=0.01, block 128, sync every block —
    ``partitioners.route("PORC", ..., engine="strict")`` through the
    strict multisource kernel, then ``engine="auto"`` through the
    snapshot kernel. Each must keep the max VW load within the envelope
    of the JAX tests, (1+ε)·m/V + S·sync·block + 1."""
    import torch
    from repro_torch.core import metrics, partitioners
    n_workers, alpha, S, block, eps = 100, 10, 100, 128, 0.01
    V = n_workers * alpha
    m = int(WP_TABLE1["n_messages"] * scale)
    keys = wp_keys[:m]
    cap = (1 + eps) * m / V
    envelope = cap + S * 1 * block + 1
    caps = torch.full((n_workers,), 1.0 / n_workers, device=dev)
    runs = []
    for engine, kernel in (("strict", "porc_multisource_strict"),
                           ("auto", "porc_multisource_scan")):
        name = f"fig11_sources100_{engine}"
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        zero_counts()
        t0 = time.perf_counter()
        vw = partitioners.route("PORC", keys, V, eps=eps, block_size=block,
                                sources=S, sync_every=1, engine=engine,
                                device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        counts = read_counts()
        check_counts(name, counts, kernel, dev, check_launches)
        load = torch.bincount(vw.long(), minlength=V)
        if vw.shape != (m,) or int(load.sum()) != m or load.shape != (V,):
            fail(f"{name}: assignment does not cover the stream")
        workers = vw % n_workers
        out = dict(
            run=name, messages=m, seconds=secs, msgs_per_s=m / secs,
            imbalance_workers=float(metrics.normalized_imbalance(workers,
                                                                 caps)),
            memory_workers=distinct_pairs(keys, workers, n_workers),
            memory_vws=distinct_pairs(keys, vw, V),
            max_vw_load=int(load.max()), cap_vw=cap, envelope=envelope,
            launches=counts)
        if out["max_vw_load"] > envelope:
            fail(f"{name}: max VW load {out['max_vw_load']} beyond the "
                 f"envelope {envelope:.1f}")
        log(f"  {name}: {m} msgs in {secs:.3f} s = {m / secs:,.0f} msgs/s;"
            f" normalized imbalance over workers "
            f"{out['imbalance_workers']:.6f}; memory {out['memory_workers']}"
            f" (key, worker) / {out['memory_vws']} (key, VW) pairs; max VW "
            f"load {out['max_vw_load']} vs (1+eps)m/V {cap:.1f}, envelope "
            f"{envelope:.1f}; launches {counts}")
        runs.append(out)
    return runs


def distinct_pairs(keys, bins, n_bins: int) -> int:
    """Memory footprint (Table III): the distinct (key, bin) pairs."""
    import torch
    return int(torch.unique(keys.long() * n_bins + bins.long()).numel())


def schemes_path(dev, wp_keys, m: int = 200_000, ns=(5, 10, 50, 100),
                 check_launches: bool = True) -> list[dict]:
    """(h) the Fig 7/8 table at ``benchmarks/bench_schemes_workers.py``'s
    size: the first ``m`` WP messages over n × α=10 VWs for n in ``ns``,
    ε=0.01; every scheme of the registry through ``route`` (sequential
    oracles), plus PKG, PoTC and PoRC blocked at 128 (PoRC with
    ``engine="strict"``, the porc_assign kernel). VWs map to workers as
    vw mod n; normalized imbalance and memory over workers."""
    import torch
    from repro_torch.core import metrics, partitioners
    keys = wp_keys[:m]
    variants = [(s, {}) for s in partitioners.ALL_SCHEMES] + [
        ("PKG", dict(block_size=128)), ("POTC", dict(block_size=128)),
        ("PORC", dict(block_size=128, engine="strict"))]
    rows = []
    for n in ns:
        V = n * 10
        caps = torch.full((n,), 1.0 / n, device=dev)
        for scheme, kw in variants:
            label = scheme + ("-b128" if kw else "") + (
                "-strict" if kw.get("engine") == "strict" else "")
            zero_counts()
            t0 = time.perf_counter()
            vw = partitioners.route(scheme, keys, V, eps=0.01, device=dev,
                                    **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            secs = time.perf_counter() - t0
            counts = read_counts()
            check_counts(f"(h) {label} n={n}", counts,
                         "porc_assign" if "engine" in kw else None, dev,
                         check_launches)
            a = vw % n
            rows.append(dict(
                n_workers=n, scheme=label, seconds=secs,
                imbalance=float(metrics.normalized_imbalance(a, caps)),
                memory=distinct_pairs(keys, a, n),
                porc_assign_launches=counts["porc_assign"]))
    labels = list(dict.fromkeys(r["scheme"] for r in rows))
    log("  normalized imbalance / memory over workers (WP, first "
        f"{m} messages, α=10, ε=0.01):")
    log("  " + " ".join(f"{x:>16}" for x in ["workers", *labels]))
    for n in ns:
        cells = {r["scheme"]: r for r in rows if r["n_workers"] == n}
        log("  " + " ".join([f"{n:>16}"] + [
            f"{cells[x]['imbalance']:>7.4f}/{cells[x]['memory']:>8}"
            for x in labels]))
    return rows


# ---------------------------------------------------------------------------
# Phase 5: serving with its failure path
# ---------------------------------------------------------------------------

SERVING_W, SERVING_SLOW = 24, 0.3


def serving_router_kw() -> dict:
    """Phase 5's router at the deployment's width (24 replicas × α=20,
    8 sources), without its heavy-hitter policy."""
    return dict(n_replicas=SERVING_W, alpha=20, n_sources=8,
                capacity_weighted=True, adaptive_moves=True, hysteresis=True,
                state_bytes_per_request=256 * 1024.0, engine="auto")


def serving_keys(seed: int, n_ticks: int, per_tick: int):
    from repro_torch.core import streams
    return streams.sample_trace(
        seed + 2, streams.TraceSpec(**TW_TABLE1), n_ticks * per_tick,
        device="cpu").numpy()


def serve_under_chaos(name: str, router, keys, n_ticks: int, per_tick: int,
                      dev) -> tuple[dict, dict]:
    """A ``ServingEngine(async_submit=True)`` on ``dev`` over ``router``
    under phase 5's schedule (replicas 0 and 1 at 30% from tick 1,
    replica 3 crashed at 0.4·``n_ticks`` and back at 0.7·``n_ticks``),
    offered 0.75 of the fleet's drain rate (the utilisation of
    ``benchmarks/bench_failures.py``), then drained. Fails if a request is
    lost or dropped at any tick or the crash was never evacuated. Returns
    (the summary, the trace: replica ids of every admitted batch,
    (submitted, served, in flight) after every tick, served per replica,
    the owner map)."""
    import numpy as np
    import torch
    from repro_torch.runtime.chaos import ChaosEvent, ChaosSchedule
    from repro_torch.serve import ServingEngine
    W, slow = SERVING_W, SERVING_SLOW
    crash_at, recover_at = int(0.4 * n_ticks), int(0.7 * n_ticks)
    max_batch = round(per_tick / (0.75 * (W - 2 + 2 * slow)))
    chaos = ChaosSchedule([ChaosEvent(1, "slow", 0, factor=1 / slow),
                           ChaosEvent(1, "slow", 1, factor=1 / slow),
                           ChaosEvent(crash_at, "crash", 3),
                           ChaosEvent(recover_at, "recover", 3)])
    eng = ServingEngine([lambda b: b for _ in range(W)], router,
                        max_batch=max_batch, chaos=chaos,
                        heartbeat_timeout_steps=2, readmit_ramp_steps=20,
                        async_submit=True)
    admitted, ticks = [], []
    finalize = router.finalize_batch

    def record(assign_vw):
        admitted.append(finalize(assign_vw))
        return admitted[-1]

    router.finalize_batch = record

    def served() -> int:
        return sum(r.served for r in eng.replicas)

    def lost():
        return eng.submitted - served() - eng.in_flight

    marks = []
    t0 = time.perf_counter()
    for tick in range(n_ticks):
        k = keys[tick * per_tick: (tick + 1) * per_tick]
        eng.submit_batch(k, list(k))
        eng.step()
        marks.append(len(eng.latency_steps))
        ticks.append((eng.submitted, served(), eng.in_flight))
        if lost():
            fail(f"{name}: {lost()} requests lost at tick {tick + 1}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    drain_ticks = 0
    while eng.in_flight and drain_ticks < 20 * n_ticks:
        eng.step()
        drain_ticks += 1
    if eng.in_flight or lost() or eng.dropped or served() != eng.submitted:
        fail(f"{name}: submitted {eng.submitted}, served {served()}, in "
             f"flight {eng.in_flight}, dropped {eng.dropped}")
    if eng.evacuations < 1:
        fail(f"{name}: the crashed replica was never evacuated")
    lat = np.asarray(eng.latency_steps)

    def window(lo_tick, hi_tick):
        lo = marks[lo_tick - 2] if lo_tick > 1 else 0
        hi = marks[hi_tick - 2] if hi_tick - 2 < len(marks) else len(lat)
        seg = lat[lo:hi]
        return dict(mean=float(seg.mean()),
                    p99=float(np.percentile(seg, 99)), max=int(seg.max()),
                    served=int(len(seg)))

    out = dict(
        requests=n_ticks * per_tick, ticks=n_ticks, max_batch=max_batch,
        seconds=secs, requests_per_s=n_ticks * per_tick / secs,
        host_ms_per_tick=secs / n_ticks * 1e3, drain_ticks=drain_ticks,
        submitted=eng.submitted, served=served(), lost=lost(),
        dropped=eng.dropped, retried=eng.retried,
        evacuations=eng.evacuations, moves=router.moves,
        bytes_moved=router.bytes_moved,
        latency_before=window(1, crash_at),
        latency_during=window(crash_at, recover_at),
        latency_after=window(recover_at, n_ticks + 1 + drain_ticks))
    log(f"  {name}: {out['requests']} requests in {secs:.3f} s = "
        f"{out['requests_per_s']:,.0f} dispatched requests/s "
        f"({out['host_ms_per_tick']:.3f} ms/tick, max_batch {max_batch}); "
        f"lost {out['lost']}, dropped {eng.dropped}, retried {eng.retried}; "
        f"evacuations {eng.evacuations}, moves {router.moves}, bytes moved "
        f"{router.bytes_moved:.0f}")
    trace = dict(admitted=admitted, ticks=ticks,
                 per_replica=[r.served for r in eng.replicas],
                 owner=router.vw_owner, latency=lat)
    return out, trace


def serving_path(dev, seed: int, n_ticks: int = 500, per_tick: int = 2048,
                 check_launches: bool = True) -> dict:
    """(e) ``serve_under_chaos`` over a W-Choices router at the
    deployment's width. Fails if a request is lost or dropped, or the
    HHPolicy kernel never launched."""
    from repro_torch.serve import CGRequestRouter
    keys = serving_keys(seed, n_ticks, per_tick)
    router = CGRequestRouter(hh_scheme="w", device=dev, **serving_router_kw())
    zero_counts()
    out, _ = serve_under_chaos("serving", router, keys, n_ticks, per_tick,
                               dev)
    launches = read_counts()["porc_multisource_scan_hh"]
    if check_launches and launches <= 0:
        fail("serving: the router never launched the HHPolicy kernel")
    out["hh_launches"] = launches
    log(f"  serving: HH kernel launches {launches}")
    for phase in ("before", "during", "after"):
        w = out[f"latency_{phase}"]
        log(f"  serving tick latency {phase} the failure: mean "
            f"{w['mean']:.3f}, p99 {w['p99']:.1f}, max {w['max']} "
            f"({w['served']} served)")
    return out


# ---------------------------------------------------------------------------
# Phase 6: serving a CG-routed MoE model
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen3-moe-235b-a22b"


def moe_config(n_layers: int | None, smoke: bool = False, router="cg"):
    """qwen3-moe-235b-a22b at full width with its depth cut to
    ``n_layers`` (or its smoke config), with ``router`` "cg" or "topk"."""
    from repro_torch import configs
    cfg = (configs.get_smoke_config(MOE_ARCH) if smoke
           else configs.get_config(MOE_ARCH))
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, router=router))


def timed_run(name: str, model, cfg, tokens, decode_steps: int,
              dev, patches=None) -> dict:
    """``prefill_step`` on ``tokens`` [B, S] (after the VLM's ``patches``
    [B, P, vision_dim], if given; with room for the decode steps in a KV
    cache), then ``decode_steps`` greedy ``decode_step``s, with the
    launch counts zeroed just before and read just after; each step ends
    in a synchronize. Checks the logits' shape and finiteness, the
    generated ids and the cache position (P + S + steps). Prefill tokens
    count every position, the patches too."""
    import torch
    from repro_torch.models import model_zoo as zoo
    B, S = tokens.shape
    batch = {"tokens": tokens}
    if patches is not None:
        batch["patches"] = patches
        S += patches.shape[1]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    zero_counts()
    t0 = time.perf_counter()
    logits, cache = zoo.prefill_step(model, cfg, batch,
                                     pad_to=S + decode_steps)
    sync()
    prefill_s = time.perf_counter() - t0
    first = logits
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    step_ms, generated = [], [tok]
    for _ in range(decode_steps):
        t0 = time.perf_counter()
        logits, cache = zoo.decode_step(model, cfg, cache, tok)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        generated.append(tok)
    counts = read_counts()
    ids = torch.cat(generated, dim=1)
    if first.shape != (B, cfg.vocab) or logits.shape != (B, cfg.vocab) \
            or not bool(first.isfinite().all()) \
            or not bool(logits.isfinite().all()):
        fail(f"{name}: logits not finite of shape {(B, cfg.vocab)}")
    if int(ids.min()) < 0 or int(ids.max()) >= cfg.vocab \
            or int(cache["pos"]) != S + decode_steps \
            or ("k" in cache and cache["k"].shape[2] != S + decode_steps):
        fail(f"{name}: tokens or cache out of range")
    attn = attention_calls(cfg, S)
    if counts["chunked_attention"] != attn:
        fail(f"{name}: {counts['chunked_attention']} chunked_attention "
             f"calls, expected {attn} (threshold "
             f"{cfg.attn_chunk_threshold})")
    out = dict(run=name, n_layers=cfg.n_layers, batch=B, seq=S,
               prefill_s=prefill_s, prefill_tokens_per_s=B * S / prefill_s,
               decode_steps=decode_steps, launches=counts)
    msg = (f"  {name}: prefill {B}x{S} in {prefill_s:.3f} s = "
           f"{out['prefill_tokens_per_s']:,.0f} tokens/s"
           + (f", {attn} chunked_attention calls" if attn else ""))
    if step_ms:
        steady = sorted(step_ms[1:]) if len(step_ms) > 1 else step_ms
        out.update(decode_ms_first=step_ms[0],
                   decode_ms_mean=sum(step_ms[1:])
                   / max(len(step_ms) - 1, 1),
                   decode_ms_median=steady[len(steady) // 2])
        msg += (f"; decode {out['decode_ms_mean']:.2f} ms/step mean, "
                f"{out['decode_ms_median']:.2f} median (first "
                f"{out['decode_ms_first']:.2f})")
    log(msg)
    return out


def attention_calls(cfg, S: int) -> int:
    """The ``chunked_attention`` calls of a prefill of S tokens: one per
    attention layer (the dense, VLM and MoE models' every layer, the
    hybrid's shared block once per group) when S passes the config's
    threshold, else none."""
    if S <= cfg.attn_chunk_threshold:
        return 0
    if cfg.family in ("dense", "vlm", "moe"):
        return cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    return 0


def moe_run(model, cfg, tokens, decode_steps: int, dev,
            check_launches: bool = True) -> dict:
    """One main-path run (``timed_run``) with router ``cfg.moe.router``;
    then, outside the counted window, the prefill's routing telemetry
    from ``hidden_states``, held to its bounds."""
    import torch
    from repro_torch.models import moe_transformer as mt
    from repro_torch.models.lm_common import embed_tokens
    B, S = tokens.shape
    name = f"moe {cfg.moe.router} {cfg.n_layers}L B={B} S={S}"
    out = timed_run(name, model, cfg, tokens, decode_steps, dev)
    counts = out["launches"]
    check_counts(name, counts, "cg_dispatch", dev, check_launches)
    with torch.no_grad():
        x = embed_tokens(model.embed, tokens, cfg.d_model)
        positions = torch.arange(S, device=dev).expand(B, S)
        _, aux, z, rm = mt.hidden_states(model, cfg, x, positions)
        del x
    drop, maxl = float(rm["drop_frac"]), float(rm["max_load_frac"])
    placed = float(rm["load"].sum())
    k = cfg.moe.top_k
    if not (0.0 <= drop <= 1.0 and 0.0 < maxl <= 1.0) \
            or abs(placed - S * k * (1 - drop)) > 1e-3 * S * k:
        fail(f"{name}: routing telemetry out of bounds: drop {drop}, "
             f"max load frac {maxl}, placed {placed}")
    out.update(router=cfg.moe.router, drop_frac=drop, max_load_frac=maxl,
               aux_loss=float(aux), z_loss=float(z))
    log(f"  {name}: prefill drop_frac {drop:.4f}, max_load_frac "
        f"{maxl:.4f}; cg_dispatch launches {counts['cg_dispatch']}")
    return out


def serve_model(name: str, cfg, model, dev, seed: int, kernels,
                check_launches: bool = True) -> dict:
    """``launch/serve.py``'s ``serve`` over ``model``: 4 replicas (replica
    0 sleeps 0.05 s per batch, Fig 15), a ``CGRequestRouter`` on the
    card, 64 zipf(1.3)-keyed one-token prompts, 8 greedy decode steps
    each, with the launch counts zeroed just before and read just after;
    every request must be served once with 8 ids in the vocabulary, and
    each of ``kernels`` must have launched."""
    from repro_torch.launch import serve
    zero_counts()
    sv = serve.serve(cfg, model, requests=64, decode_steps=8, replicas=4,
                     hetero=True, device=dev, seed=seed)
    counts = read_counts()
    for kernel in kernels:
        check_counts(f"{name} serving", counts, kernel, dev, check_launches)
    eng = sv["engine"]
    served = sum(r.served for r in eng.replicas)
    if sv["served"] != 64 or served != eng.submitted or eng.in_flight \
            or sorted(sv["outputs"]) != list(range(64)):
        fail(f"{name} serving: submitted {eng.submitted}, served {served}, "
             f"in flight {eng.in_flight}")
    if any(o.shape != (8,) or int(o.min()) < 0 or int(o.max()) >= cfg.vocab
           for o in sv["outputs"].values()):
        fail(f"{name} serving: generated ids out of range")
    serving = dict(requests=64, replicas=4, seconds=sv["seconds"],
                   requests_per_s=sv["requests_per_s"],
                   latency_mean_s=sv["latency_mean_s"],
                   latency_p99_s=sv["latency_p99_s"],
                   per_replica=[r.served for r in eng.replicas],
                   moves=eng.router.moves, launches=counts)
    log(f"  serving: 64 requests on 4 replicas (replica 0 slow) in "
        f"{sv['seconds']:.2f} s = {sv['requests_per_s']:.1f} req/s; "
        f"latency mean {sv['latency_mean_s'] * 1e3:.1f} ms, p99 "
        f"{sv['latency_p99_s'] * 1e3:.1f} ms; per replica "
        f"{serving['per_replica']}; launches "
        + ", ".join(f"{k} {counts[k]}" for k in kernels))
    return serving


def moe_path(dev, seed: int, n_layers: int | None = 8, batch: int = 8,
             seq: int = 1024, decode_steps: int = 32, smoke: bool = False,
             check_launches: bool = True,
             long_prompt: tuple[int, int] | None = None) -> dict:
    """(i) qwen3-moe-235b-a22b at full width (d 4096, 64/4 heads, 128
    experts top-8, vocab 151,936) cut to ``n_layers``, random bf16
    weights from a seeded ``torch.Generator``: ``moe_run`` with
    router="cg" and router="topk" (the same weights and tokens); CG must
    drop no more slots than top-k. With ``long_prompt`` (batch, length),
    one more ``moe_run`` with router "cg": a prefill of that many tokens
    and no decode step, past ``attn_chunk_threshold`` at (2, 4,096), so
    every layer's attention takes ``chunked_attention``. (ii)
    ``launch/serve.py``'s ``ServingEngine`` over the same model with 4
    replicas, one slow, serving 64 requests. ``smoke`` takes the smoke
    config instead, for a rehearsal on the CPU. Returns the report."""
    import torch
    from repro_torch.models import model_zoo as zoo
    cfg = moe_config(n_layers, smoke)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = zoo.init_params(cfg, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device=dev, dtype=torch.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    n_params = zoo.count_params(model)
    log(f"  {cfg.arch_id}{' (smoke)' if smoke else ''}: {cfg.n_layers} "
        f"layers, {n_params:,} params ({n_params * 2 / 1e9:.2f} GB bf16) "
        f"drawn in {time.perf_counter() - t0:.1f} s")
    # warm-up (library handles, the allocator's pools), not timed: a
    # prefill of the same shape and two decode steps
    _, cache = zoo.prefill_step(model, cfg, {"tokens": tokens}, pad_to=seq + 2)
    for _ in range(2):
        _, cache = zoo.decode_step(model, cfg, cache, tokens[:, :1])
    del cache
    runs = [moe_run(model, moe_config(n_layers, smoke, router=r), tokens,
                    decode_steps, dev, check_launches)
            for r in ("cg", "topk")]
    if runs[0]["drop_frac"] > runs[1]["drop_frac"]:
        fail(f"moe: CG dropped more than top-k ({runs[0]['drop_frac']} > "
             f"{runs[1]['drop_frac']})")
    log(f"  drop_frac CG {runs[0]['drop_frac']:.4f} vs top-k "
        f"{runs[1]['drop_frac']:.4f}")
    long = None
    if long_prompt:
        long_tokens = torch.randint(0, cfg.vocab, long_prompt, generator=gen,
                                    device=dev, dtype=torch.int32)
        zoo.prefill_step(model, cfg, {"tokens": long_tokens})   # warm-up
        long = moe_run(model, cfg, long_tokens, 0, dev, check_launches)
        del long_tokens

    # (ii) serving: 4 replicas of the model, one slow, 64 requests
    serving = serve_model("moe", cfg, model, dev, seed,
                          ("cg_dispatch", "porc_multisource_scan"),
                          check_launches)
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else 0.0)
    return dict(arch=cfg.arch_id, n_layers=cfg.n_layers, params=n_params,
                peak_gb=peak, runs=runs, long=long, serving=serving)


def greedy_logits(model, cfg, tokens, steps: int = 4, patches=None,
                  frames=None) -> list:
    """The last logits of ``prefill_step`` on ``tokens`` (after the VLM's
    ``patches``, or against whisper's ``frames``, if given) and of
    ``steps`` greedy ``decode_step``s after it, copied to the host."""
    import torch
    from repro_torch.models import model_zoo as zoo
    batch = {"tokens": tokens}
    if patches is not None:
        batch["patches"] = patches
    if frames is not None:
        batch["frames"] = frames
    S = tokens.shape[1] + (0 if patches is None else patches.shape[1])
    logits, cache = zoo.prefill_step(model, cfg, batch, pad_to=S + steps)
    seq = [logits]
    for _ in range(steps):
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        logits, cache = zoo.decode_step(model, cfg, cache, tok)
        seq.append(logits)
    return [x.cpu() for x in seq]


def moe_reference_check(dev, seed: int) -> dict:
    """The port's path on the card against the same path on the CPU, on
    a small input: the smoke config in f32 with the same weights, a
    prefill of [2, 64] tokens and 4 greedy decode steps. The logits
    agree within 1e-4 relative to their largest magnitude (f32 matmuls
    round differently on the two devices; TF32 is off), the greedy
    tokens and the prefill's routing telemetry are equal."""
    import copy
    import torch
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import moe_transformer as mt
    from repro_torch.models.lm_common import embed_tokens
    cfg = moe_config(None, smoke=True).replace(dtype="float32")
    cpu = torch.device("cpu")
    host = zoo.init_params(cfg, seed, device=cpu)
    card = copy.deepcopy(host).to(dev)
    tokens = torch.randint(0, cfg.vocab, (2, 64),
                           generator=torch.Generator().manual_seed(seed),
                           dtype=torch.int32)
    out = {}
    for where, model in ((cpu, host), (dev, card)):
        t = tokens.to(where)
        with torch.no_grad():
            x = embed_tokens(model.embed, t, cfg.d_model)
            _, _, _, rm = mt.hidden_states(model, cfg, x, torch.arange(
                64, device=where).expand(2, 64))
        out[where.type] = (greedy_logits(model, cfg, t),
                           {k: v.cpu() for k, v in rm.items()})
    err = 0.0
    for a, b in zip(out["cpu"][0], out[dev.type][0]):
        rel = float((a - b).abs().max() / a.abs().max())
        err = max(err, rel)
        if rel > 1e-4 or not torch.equal(a.argmax(-1), b.argmax(-1)):
            fail(f"moe reference: the card's logits differ from the CPU's "
                 f"(max rel {rel})")
    for name, v in out["cpu"][1].items():
        if not torch.equal(v, out[dev.type][1][name]):
            fail(f"moe reference: routing telemetry {name} differs")
    log(f"  smoke config in f32, card vs CPU: logits max rel err {err:.2e} "
        "over prefill + 4 decode steps; greedy tokens and routing "
        "telemetry equal")
    return dict(max_rel_err=err)


# ---------------------------------------------------------------------------
# Phase 7: serving Mamba-2 and the zamba2 hybrid
# ---------------------------------------------------------------------------

# the prompt length of each model's prefill: a chat-length prompt for the
# hybrid, long prompts for the SSM, whose decode state does not grow
SSM_PROMPTS = {"zamba2-2.7b": 1024, "mamba2-130m": 4096}
# prefill(prompt) against prefill(prompt[:-1]) + decode(prompt[-1]), on
# the last logits, max|a − b| / max|a|: in bf16 the bound of
# tests/test_models_smoke.py::test_prefill_then_decode_consistency; in
# f32, where the two paths differ only in the order of their sums. The
# f32 check is the one meant to fail on a fault of the cache: at full
# width the bf16 gap is mostly the rounding of the residual adds in bf16
# and comes close to its bound, so the bf16 check catches only a gross
# fault
CONSISTENCY_TOL = 5e-2
CONSISTENCY_TOL_F32 = 1e-4


def prefill_decode_gap(model, cfg, tokens, frames=None) -> float:
    """max|a − b| / max|a| between the last logits of ``prefill(prompt)``
    and of ``prefill(prompt[:-1])`` + ``decode(prompt[-1])`` (both against
    whisper's ``frames``, if given)."""
    from repro_torch.models import model_zoo as zoo
    S = tokens.shape[1]
    extra = {} if frames is None else {"frames": frames}
    full, _ = zoo.prefill_step(model, cfg, {"tokens": tokens, **extra})
    _, cache = zoo.prefill_step(model, cfg, {"tokens": tokens[:, :-1],
                                             **extra}, pad_to=S)
    inc, _ = zoo.decode_step(model, cfg, cache, tokens[:, -1:])
    return relerr(full, inc)


def ssm_run(model, cfg, tokens, decode_steps: int, dev,
            check_launches: bool = True) -> dict:
    """One main-path run (``timed_run``): one ``ssd_scan`` launch per SSM
    layer, and no plain ``ssd_chunked`` on the card; then, outside the
    counted window, ``prefill(prompt[:-1])`` + ``decode(prompt[-1])``
    against ``prefill(prompt)``."""
    B, S = tokens.shape
    name = f"{cfg.arch_id} {cfg.n_layers}L B={B} S={S}"
    out = timed_run(name, model, cfg, tokens, decode_steps, dev)
    counts = out["launches"]
    check_counts(name, counts, "ssd_scan", dev, check_launches)
    if check_launches and counts["ssd_scan"] != cfg.n_layers:
        fail(f"{name}: {counts['ssd_scan']} ssd_scan launches, expected one "
             f"per SSM layer ({cfg.n_layers})")
    consistency = prefill_decode_gap(model, cfg, tokens)
    if not consistency < CONSISTENCY_TOL:
        fail(f"{name}: prefill(prompt[:-1]) + decode(last) differs from "
             f"prefill(prompt) by {consistency:.3e} relative")
    out.update(arch=cfg.arch_id, consistency_rel_err=consistency)
    log(f"  {name}: ssd_scan launches {counts['ssd_scan']}; "
        f"prefill(prompt[:-1]) + decode(last) vs prefill(prompt): "
        f"{consistency:.3e} relative")
    return out


def ssm_path(dev, seed: int, arch: str, batch: int = 8,
             seq: int | None = None, decode_steps: int = 32,
             smoke: bool = False, serving: bool = False,
             check_launches: bool = True,
             long_seq: int | None = None) -> dict:
    """``arch`` (zamba2-2.7b or mamba2-130m) at its full config, random
    bf16 weights from a seeded ``torch.Generator`` and
    ``use_pallas="auto"``: ``ssm_run`` on ``batch`` random prompts of
    ``seq`` tokens (``SSM_PROMPTS``) after a warm-up of the same shape;
    with ``serving``, ``launch/serve.py``'s ``serve`` over the same
    model; with ``long_seq``, ``long_run`` on ``batch`` prompts of that
    length; then the prefill/decode consistency of the same config in f32
    (new weights from the same generator) on two of the prompts, where
    no bf16 rounding hides a fault of the cache. ``smoke`` takes the
    smoke config instead, for a rehearsal on the CPU. Returns the
    report."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model_zoo as zoo
    cfg = (configs.get_smoke_config(arch) if smoke
           else configs.get_config(arch))
    seq = seq or SSM_PROMPTS[arch]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = zoo.init_params(cfg, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device=dev, dtype=torch.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    n_params = zoo.count_params(model)
    log(f"  {arch}{' (smoke)' if smoke else ''}: {cfg.n_layers} layers, "
        f"{n_params:,} params ({n_params * 2 / 1e9:.2f} GB bf16) drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    # warm-up (library handles, the allocator's pools), not timed
    _, cache = zoo.prefill_step(model, cfg, {"tokens": tokens},
                                pad_to=seq + 2)
    for _ in range(2):
        _, cache = zoo.decode_step(model, cfg, cache, tokens[:, :1])
    del cache
    out = dict(arch=arch, n_layers=cfg.n_layers, params=n_params,
               run=ssm_run(model, cfg, tokens, decode_steps, dev,
                           check_launches))
    if serving:
        out["serving"] = serve_model(arch, cfg, model, dev, seed,
                                     ("porc_multisource_scan",),
                                     check_launches)
    out["peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                      if dev.type == "cuda" else 0.0)
    log(f"  peak device memory {out['peak_gb']:.2f} GB")
    if long_seq:
        out["long"] = long_run(model, cfg, torch.randint(
            0, cfg.vocab, (batch, long_seq), generator=gen, device=dev,
            dtype=torch.int32), dev, check_launches)
    del model
    cfg32 = cfg.replace(dtype="float32")
    gap = prefill_decode_gap(zoo.init_params(cfg32, gen, device=dev), cfg32,
                             tokens[:2])
    if not gap < CONSISTENCY_TOL_F32:
        fail(f"{arch} f32: prefill(prompt[:-1]) + decode(last) differs "
             f"from prefill(prompt) by {gap:.3e} relative")
    out["consistency_f32_rel_err"] = gap
    log(f"  {arch} in f32, 2 x {seq} tokens: prefill(prompt[:-1]) + "
        f"decode(last) vs prefill(prompt): {gap:.3e} relative")
    return out


def long_run(model, cfg, tokens, dev, check_launches: bool = True,
             decode_steps: int = 4) -> dict:
    """A long prompt through a Mamba-2 or hybrid model: after a warm-up
    prefill of the same shape, ``timed_run`` (prefill + ``decode_steps``
    greedy steps from its cache) with the peak device memory of the
    timed run; one ``ssd_scan`` launch per SSM layer, and past the
    hybrid's ``attn_chunk_threshold`` one ``chunked_attention`` call per
    shared block (``timed_run`` checks those)."""
    import torch
    from repro_torch.models import model_zoo as zoo
    B, S = tokens.shape
    zoo.prefill_step(model, cfg, {"tokens": tokens})             # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    name = f"{cfg.arch_id} {cfg.n_layers}L B={B} S={S}"
    out = timed_run(name, model, cfg, tokens, decode_steps, dev)
    counts = out["launches"]
    check_counts(name, counts, "ssd_scan", dev, check_launches)
    if check_launches and counts["ssd_scan"] != cfg.n_layers:
        fail(f"{name}: {counts['ssd_scan']} ssd_scan launches, expected one "
             f"per SSM layer ({cfg.n_layers})")
    out["peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                      if dev.type == "cuda" else 0.0)
    log(f"  {name}: peak device memory {out['peak_gb']:.2f} GB")
    return out


def check_chunked_attention(dev, S: int = 4096) -> dict:
    """``chunked_attention`` (q and kv chunks of 1,024, the configs') against
    ``dense_attention`` on the card in f32, causal, batch 1, S tokens, at
    zamba2's attention shape (32 heads of 80, no GQA) and qwen3-moe's (64
    query and 4 KV heads of 128): max|a − b| ≤ 1e-5 · max|dense| (the two
    differ only in the order of their sums); each timed once."""
    import torch
    from repro_torch.models.layers import chunked_attention, dense_attention
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for arch, H, KV, Dh in (("zamba2-2.7b", 32, 32, 80),
                            ("qwen3-moe-235b-a22b", 64, 4, 128)):
        q = torch.randn((1, S, H, Dh), generator=gen, device=dev)
        k, v = (torch.randn((1, S, KV, Dh), generator=gen, device=dev)
                for _ in range(2))
        ms = {}
        res = {}
        for name, fn in (("chunked", lambda: chunked_attention(
                              q, k, v, causal=True, q_chunk=1024,
                              kv_chunk=1024)),
                         ("dense", lambda: dense_attention(q, k, v,
                                                           causal=True))):
            res[name] = fn()
            ms[name] = cuda_ms(fn, reps=1, warmup=0)
        err = relerr(res["dense"], res["chunked"])
        if not err <= 1e-5:
            fail(f"chunked_attention at {arch}'s shape differs from "
                 f"dense_attention by {err:.3e} relative")
        out[arch] = dict(rel_err=err, chunked_ms=ms["chunked"],
                         dense_ms=ms["dense"])
        log(f"  chunked vs dense attention, {arch} shape 1 x {S} x {H}/{KV}"
            f" heads x {Dh}, f32: max rel err {err:.3e}; chunked "
            f"{ms['chunked']:.2f} ms, dense {ms['dense']:.2f} ms")
        del q, k, v, res
    return out


def ssm_reference_check(dev, seed: int) -> dict:
    """The port's path on the card against the same path on the CPU: both
    smoke configs in f32 with the same weights (the kernel on the card,
    the plain ``ssd_chunked`` on the CPU), a prefill of [2, 64] tokens
    and 4 greedy decode steps. The logits agree within 1e-4 relative to
    their largest magnitude (f32 matmuls round differently on the two
    devices; TF32 is off) and the greedy tokens are equal."""
    import copy
    import torch
    from repro_torch import configs
    from repro_torch.models import model_zoo as zoo
    cpu = torch.device("cpu")
    errs = {}
    for arch in SSM_PROMPTS:
        cfg = configs.get_smoke_config(arch).replace(dtype="float32")
        host = zoo.init_params(cfg, seed, device=cpu)
        card = copy.deepcopy(host).to(dev)
        tokens = torch.randint(0, cfg.vocab, (2, 64),
                               generator=torch.Generator().manual_seed(seed),
                               dtype=torch.int32)
        err = 0.0
        for a, b in zip(greedy_logits(host, cfg, tokens),
                        greedy_logits(card, cfg, tokens.to(dev))):
            err = max(err, relerr(a, b))
            if not relerr(a, b) <= 1e-4 \
                    or not torch.equal(a.argmax(-1), b.argmax(-1)):
                fail(f"{arch} reference: the card's logits differ from the "
                     f"CPU's (max rel {relerr(a, b)})")
        errs[arch] = err
        log(f"  {arch} smoke config in f32, card vs CPU: logits max rel err "
            f"{err:.2e} over prefill + 4 decode steps; greedy tokens equal")
    return dict(max_rel_err=errs)


# ---------------------------------------------------------------------------
# Phase 8: training the CG-routed MoE
# ---------------------------------------------------------------------------

# the card-against-CPU train step: gradients within 1e-4 of each tensor's
# largest (f32 matmuls round differently on the two devices, TF32 off;
# the logits agree within ~2e-6, phase 6); the weights after one step
# within 1e-5 of the largest plus 0.1 lr (AdamW's first step moves an
# element by lr·g/(|g| + eps): with eps 1e-5 a gradient as small as the
# devices' difference, ~1e-6, moves it up to 0.1 lr apart); AdamW on the
# same gradients on both devices within 1e-6 of the largest
TRAIN_GRAD_TOL, TRAIN_UPDATE_LR_TOL, TRAIN_OPT_TOL = 1e-4, 0.1, 1e-6


def train_reckoning(cfg) -> dict:
    """Parameters and bytes of the reference's training state per
    parameter: bf16 weights and gradients (4), f32 master, m and v (12),
    and the f32 gradient sum when ``grad_accum`` > 1 (4)."""
    from repro_torch.models import model_zoo as zoo
    n = zoo.count_params_specs(zoo.param_specs(cfg))
    per = 16 + (4 if cfg.grad_accum > 1 else 0)
    return dict(params=n, bytes_per_param=per, state_gb=n * per / 1e9)


def train_run(cfg, batches, dev, seed: int, steps: int = 5,
              check_launches: bool = True) -> dict:
    """``make_train_step`` on ``cfg`` from random weights drawn from
    ``seed`` (bf16 at full width), AdamW (peak 3e-4, warm-up 2 of
    ``steps``), ``steps`` steps, step i on the batch ``batches(i)``
    (drawn inside the step's time), with the launch counts zeroed just
    before and read just after: the loss finite at every step,
    ``moe_max_load_frac`` ≤ 1, and on the card ``cg_dispatch`` launched
    on every micro-step (once a layer, twice under remat "full": the
    forward and its recompute) and the plain dispatch never on CUDA
    tensors. The run has a row a step under ``steps``; whether its loss
    must fall is left to the caller (``loss_fell``)."""
    import gc
    import torch
    from repro_torch import optim
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model_zoo as zoo
    from repro_torch.kernels.cg_dispatch import cg_dispatch
    name = (f"train {cfg.moe.router} skew={cfg.moe.capacity_skew} "
            f"{cfg.n_layers}L")
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    model = zoo.init_params(cfg, seed, device=dev)
    state = optim.init(model)
    step = make_train_step(cfg, optim.AdamWConfig(warmup_steps=2,
                                                  total_steps=steps))
    per_step = cfg.grad_accum * cfg.n_layers * (2 if cfg.remat == "full"
                                                else 1)
    B, S = batches(0).shape
    rows = []
    sync()
    zero_counts()
    for i in range(steps):
        before = cg_dispatch.launches
        t0 = time.perf_counter()
        model, state, m = step(model, state, {"tokens": batches(i)})
        sync()
        dt = time.perf_counter() - t0
        row = dict(step=i + 1, loss=float(m["loss"]), lr=float(m["lr"]),
                   grad_norm=float(m["grad_norm"]), ms=dt * 1e3,
                   tokens_per_s=B * S / dt,
                   drop_frac=float(m["moe_drop_frac"]),
                   max_load_frac=float(m["moe_max_load_frac"]),
                   cg_dispatch_launches=cg_dispatch.launches - before)
        rows.append(row)
        log(f"  {name} step {i + 1}: loss {row['loss']:.5f}, grad_norm "
            f"{row['grad_norm']:.4f}, lr {row['lr']:.2e}, {row['ms']:.1f} ms "
            f"= {row['tokens_per_s']:,.0f} tokens/s, drop_frac "
            f"{row['drop_frac']:.4f}, max_load_frac "
            f"{row['max_load_frac']:.4f}, cg_dispatch launches "
            f"{row['cg_dispatch_launches']}")
        if not (math.isfinite(row["loss"])
                and math.isfinite(row["grad_norm"])):
            fail(f"{name}: loss or grad_norm not finite at step {i + 1}")
        if not 0.0 < row["max_load_frac"] <= 1.0:
            fail(f"{name}: max_load_frac {row['max_load_frac']} at step "
                 f"{i + 1}")
        if cuda and check_launches \
                and row["cg_dispatch_launches"] != per_step:
            fail(f"{name}: {row['cg_dispatch_launches']} cg_dispatch "
                 f"launches at step {i + 1}, expected {per_step} (every "
                 "micro-step's layers, forward and recompute)")
    counts = read_counts()
    check_counts(name, counts, "cg_dispatch", dev, check_launches)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else 0.0
    steady = rows[1:] or rows
    out = dict(run=name, router=cfg.moe.router,
               capacity_skew=cfg.moe.capacity_skew, steps=rows,
               step_ms_mean=sum(r["ms"] for r in steady) / len(steady),
               tokens_per_s=B * S * len(steady)
               / (sum(r["ms"] for r in steady) / 1e3),
               peak_gb=peak, launches=counts)
    log(f"  {name}: loss {rows[0]['loss']:.5f} -> {rows[-1]['loss']:.5f}; "
        f"steps 2-{steps} {out['step_ms_mean']:.1f} ms = "
        f"{out['tokens_per_s']:,.0f} tokens/s; peak device memory "
        f"{peak:.1f} GB; cg_dispatch launches {counts['cg_dispatch']}")
    del model, state, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def loss_fell(run: dict) -> None:
    """Fail unless ``run``'s (``train_run``) last loss is below its
    first."""
    first, last = run["steps"][0]["loss"], run["steps"][-1]["loss"]
    if not last < first:
        fail(f"{run['run']}: the loss did not fall ({first} -> {last})")


def train_path(dev, seed: int, n_layers: int | None = 1, steps: int = 5,
               smoke: bool = False, check_launches: bool = True) -> dict:
    """(p) qwen3-moe-235b-a22b at full width, depth cut to ``n_layers``,
    with its config's remat "full" and grad_accum 8, on one fixed batch
    of 8 × 1,024 zipf(1.3) tokens from ``seed`` (micro-steps of 1 ×
    1,024): ``train_run`` with routers "cg" and "topk" × uniform and
    ``capacity_skew=3.0`` capacities, everything freed between runs; CG
    must drop no more than top-k at the same capacities (the first step:
    the same weights and batch). ``smoke`` takes the smoke config on
    8 × 64 tokens, for a rehearsal on the CPU."""
    from repro_torch.core import streams
    base = moe_config(n_layers, smoke)
    B, S = (8, 64) if smoke else (8, 1024)
    reck = train_reckoning(base)
    log(f"  {base.arch_id}{' (smoke)' if smoke else ''}: depth "
        f"{94 if not smoke else base.n_layers} -> {base.n_layers} "
        f"layer(s): {reck['params']:,} parameters x "
        f"{reck['bytes_per_param']} bytes of training state (bf16 weights "
        f"and grads, f32 master, m, v, f32 grad sum) = "
        f"{reck['state_gb']:.1f} GB; remat {base.remat!r}, grad_accum "
        f"{base.grad_accum}, batch {B} x {S}")
    tokens = streams.sample_zipf_stream(seed, B * S, base.vocab, 1.3,
                                        device=dev).reshape(B, S)
    runs = []
    for skew in (0.0, 3.0):
        pair = []
        for router in ("cg", "topk"):
            cfg = moe_config(n_layers, smoke, router)
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                      capacity_skew=skew))
            pair.append(train_run(cfg, lambda i: tokens, dev, seed, steps,
                                  check_launches))
            loss_fell(pair[-1])
        cg, topk = (r["steps"][0]["drop_frac"] for r in pair)
        if cg > topk:
            fail(f"train skew={skew}: CG dropped more than top-k ({cg} > "
                 f"{topk})")
        log(f"  train skew={skew}: first-step drop_frac CG {cg:.4f} vs "
            f"top-k {topk:.4f}")
        runs += pair
    return dict(arch=base.arch_id, n_layers=base.n_layers, batch=[B, S],
                reckoning=reck, runs=runs)


def smoke_batch(cfg, seed: int, B: int = 4, S: int = 64) -> dict:
    """A host batch of ``B`` × ``S`` random tokens from ``seed`` and, for
    the VLM, its patches [B, n_patches, vision_dim], for whisper frames
    [B, S, d_model] (f32 normals)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                     dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn((B, cfg.n_patches, cfg.vision_dim),
                                       generator=g)
    if cfg.family == "audio":
        batch["frames"] = torch.randn((B, S, cfg.d_model), generator=g)
    return batch


def grad_errors(a: dict, b: dict) -> dict:
    """max|a − b| over max|a| of each gradient of ``a`` (by name) against
    ``b``'s; whisper's cross-attention key bias ``bk``, whose gradient is
    zero in exact arithmetic (a shift common to every key leaves the
    softmax as it is) and rounding noise on either device, over the
    largest gradient of the model instead."""
    top = max(float(g.abs().max()) for g in a.values())
    return {n: float((g - b[n]).abs().max())
            / (top if n.endswith("cross_attn.bk")
               else max(float(g.abs().max()), 1e-30))
            for n, g in a.items()}


def train_reference_check(dev, seed: int, arch: str = MOE_ARCH) -> dict:
    """The train step on the card against the CPU, from the same weights:
    ``arch``'s smoke config in f32 (the MoE with grad_accum 2; the other
    families with remat "full": Mamba-2 and zamba2 with the SSD scan's
    CUDA forward and backward on the card, its plain versions on the CPU;
    the dense, VLM and audio families with their LayerNorm or RMSNorm
    VJPs), AdamW with eps 1e-5, one step on 4 × 64 tokens (``smoke_batch``:
    the VLM's patches, whisper's frames). The loss, every gradient (the
    router's by name, which must not be zero; ``grad_errors``), the step's
    loss and telemetry and the weights after it agree within the
    ``TRAIN_*`` tolerances; AdamW on the CPU's gradients agrees on both
    devices."""
    import copy
    import torch
    from repro_torch import configs, optim
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model_zoo as zoo
    if arch == MOE_ARCH:
        cfg = moe_config(None, smoke=True).replace(dtype="float32",
                                                   grad_accum=2)
    else:
        cfg = configs.get_smoke_config(arch).replace(dtype="float32",
                                                     remat="full")
    moe = cfg.family == "moe"
    cpu = torch.device("cpu")
    host = zoo.init_params(cfg, seed, device=cpu).requires_grad_(True)
    card = copy.deepcopy(host).to(dev)
    inputs = smoke_batch(cfg, seed)
    opt_cfg = optim.AdamWConfig(lr_peak=1e-3, warmup_steps=1,
                                total_steps=4, eps=1e-5)
    out = {}
    for where, model in ((cpu, host), (dev, card)):
        batch = {k: v.to(where) for k, v in inputs.items()}
        loss, _ = zoo.loss_and_metrics(model, cfg, batch)
        names, leaves = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, leaves)
        grads = {n: g.detach().cpu() for n, g in zip(names, grads)}
        fixed = {n: g.to(where) for n, g in out.get("cpu", {}).get(
            "grads", grads).items()}
        same = copy.deepcopy(model)
        optim.update(same, fixed, optim.init(same), opt_cfg)
        step = make_train_step(cfg, opt_cfg)
        model, _, m = step(model, optim.init(model), batch)
        out[where.type] = dict(
            loss=float(loss.detach()), grads=grads,
            metrics={k: v.detach().cpu() for k, v in m.items()},
            weights={n: p.detach().cpu() for n, p in model.named_parameters()},
            same_grads={n: p.detach().cpu()
                        for n, p in same.named_parameters()})
    a, b = out["cpu"], out[dev.type]
    lr = float(a["metrics"]["lr"])

    def worst(x, y):
        return float((x - y).abs().max() / max(float(x.abs().max()), 1e-30))

    loss_err = abs(a["loss"] - b["loss"]) / abs(a["loss"])
    grad_err = grad_errors(a["grads"], b["grads"])
    router = [n for n in grad_err if n.endswith("moe.router")]
    if loss_err > 1e-5 or max(grad_err.values()) > TRAIN_GRAD_TOL:
        fail(f"train reference {arch}: loss rel {loss_err}, worst gradient "
             f"{max(grad_err.items(), key=lambda kv: kv[1])}")
    if moe and (not router or any(float(b["grads"][n].abs().max()) == 0.0
                                  for n in router)):
        fail("train reference: the router's gradient is zero on the card")
    for k in ("loss", "grad_norm", "lr"):
        if worst(a["metrics"][k], b["metrics"][k]) > 1e-5:
            fail(f"train reference {arch}: step {k} differs")
    if set(a["metrics"]) != set(b["metrics"]):
        fail(f"train reference {arch}: the step's metrics differ")
    for k in ("moe_drop_frac", "moe_max_load_frac", "moe_load"):
        if moe and not torch.equal(a["metrics"][k], b["metrics"][k]):
            fail(f"train reference: routing telemetry {k} differs")
    w_err, opt_err = 0.0, 0.0
    for n, w in a["weights"].items():
        d = float((w - b["weights"][n]).abs().max())
        w_err = max(w_err, d / lr)
        if d > 1e-5 * float(w.abs().max()) + TRAIN_UPDATE_LR_TOL * lr:
            fail(f"train reference {arch}: weight {n} after the step "
                 f"differs by {d}")
        opt_err = max(opt_err, worst(a["same_grads"][n],
                                     b["same_grads"][n]))
    if opt_err > TRAIN_OPT_TOL:
        fail(f"train reference {arch}: AdamW on the same gradients "
             f"differs ({opt_err})")
    worst_name = max(grad_err, key=grad_err.get)
    log(f"  {arch} smoke config in f32, one train step (grad_accum "
        f"{cfg.grad_accum}, remat {cfg.remat!r}), card vs CPU: loss rel "
        f"{loss_err:.2e}; gradients max rel "
        f"{grad_err[worst_name]:.2e} ({worst_name}"
        + (", router " + ", ".join(f"{n} {grad_err[n]:.2e}" for n in router)
           if moe else "")
        + f"); weights after the step max |diff| {w_err:.3f} lr; AdamW on "
        f"the same gradients max rel {opt_err:.2e}"
        + ("; routing telemetry equal" if moe else ""))
    return dict(loss_rel_err=loss_err, grad_rel_err=grad_err,
                weight_err_over_lr=w_err, adamw_rel_err=opt_err)


# ---------------------------------------------------------------------------
# Phase 9: training Mamba-2 and the zamba2 hybrid
# ---------------------------------------------------------------------------

def ssm_train_steps(name: str, model, state, step, cfg, tokens, dev,
                    n_steps: int, first: int = 1,
                    check_launches: bool = True) -> dict:
    """``n_steps`` train steps of ``step`` on the fixed batch ``tokens``
    with the launch counts zeroed just before and read just after: the
    loss and grad_norm finite at every step; on the card per step
    ``ssd_scan`` launched once a layer a micro-step, twice under remat
    "full" (the forward and its recompute), ``ssd_scan_bwd`` once, as
    many ``chunked_attention`` calls as a forward and its recompute make
    (``attention_calls``), and the plain ``ssd_chunked`` never on CUDA
    tensors. Step ms, train tokens/s and peak device memory."""
    import torch
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    B, S = tokens.shape
    passes = cfg.grad_accum * (2 if cfg.remat == "full" else 1)
    expect = {"ssd_scan": cfg.n_layers * passes,
              "ssd_scan_bwd": cfg.n_layers * cfg.grad_accum,
              "chunked_attention": attention_calls(cfg, S) * passes}
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    rows = []
    sync()
    zero_counts()
    for i in range(n_steps):
        before = read_counts()
        t0 = time.perf_counter()
        model, state, m = step(model, state, {"tokens": tokens})
        sync()
        dt = time.perf_counter() - t0
        after = read_counts()
        got = {k: after[k] - before[k] for k in expect}
        row = dict(step=first + i, loss=float(m["loss"]), lr=float(m["lr"]),
                   grad_norm=float(m["grad_norm"]), ms=dt * 1e3,
                   tokens_per_s=B * S / dt, launches=got)
        rows.append(row)
        log(f"  {name} step {row['step']}: loss {row['loss']:.5f}, "
            f"grad_norm {row['grad_norm']:.4f}, lr {row['lr']:.2e}, "
            f"{row['ms']:.1f} ms = {row['tokens_per_s']:,.0f} tokens/s; "
            f"launches ssd_scan {got['ssd_scan']}, ssd_scan_bwd "
            f"{got['ssd_scan_bwd']}, chunked_attention calls "
            f"{got['chunked_attention']}")
        if not (math.isfinite(row["loss"])
                and math.isfinite(row["grad_norm"])):
            fail(f"{name}: loss or grad_norm not finite at step "
                 f"{row['step']}")
        if cuda and check_launches and got != expect:
            fail(f"{name}: launches {got} at step {row['step']}, expected "
                 f"{expect} (every SSM layer's forward and recompute, its "
                 "backward once; the shared attention's calls)")
    counts = read_counts()
    check_counts(name, counts, "ssd_scan_bwd", dev, check_launches)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else 0.0
    steady = rows[1:] or rows
    out = dict(run=name, batch=[B, S], steps=rows,
               step_ms_mean=sum(r["ms"] for r in steady) / len(steady),
               tokens_per_s=B * S * len(steady)
               / (sum(r["ms"] for r in steady) / 1e3),
               peak_gb=peak, launches=counts)
    log(f"  {name}: loss {rows[0]['loss']:.5f} -> {rows[-1]['loss']:.5f}; "
        f"steps {rows[0]['step'] + (len(rows) > 1)}-{rows[-1]['step']} "
        f"{out['step_ms_mean']:.1f} ms = {out['tokens_per_s']:,.0f} "
        f"tokens/s; peak device memory {peak:.1f} GB")
    return out


def ssm_train_path(dev, seed: int, arch: str, batch: int, seq: int,
                   steps: int = 5, long: tuple | None = None,
                   smoke: bool = False, check_launches: bool = True) -> dict:
    """(q) mamba2-130m or (r) zamba2-2.7b at full size, random bf16
    weights from ``seed``, the config's remat "full" and grad_accum 1:
    ``steps`` AdamW steps (warm-up 2) of ``make_train_step`` on one fixed
    batch of ``batch`` × ``seq`` zipf(1.3) tokens (``ssm_train_steps``;
    the loss must fall from the first step to the last); with ``long``
    (B, S), one more step of the same model on a batch of that shape.
    Logs the training state's reckoning beside the measured peak.
    ``smoke`` takes the smoke config, for a rehearsal on the CPU."""
    import gc
    import torch
    from repro_torch import configs, optim
    from repro_torch.core import streams
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model_zoo as zoo
    cfg = (configs.get_smoke_config(arch) if smoke
           else configs.get_config(arch))
    reck = train_reckoning(cfg)
    log(f"  {arch}{' (smoke)' if smoke else ''}: {cfg.n_layers} layers, "
        f"{reck['params']:,} parameters x {reck['bytes_per_param']} bytes "
        f"of training state (bf16 weights and grads, f32 master, m, v) = "
        f"{reck['state_gb']:.1f} GB; remat {cfg.remat!r}, grad_accum "
        f"{cfg.grad_accum}, batch {batch} x {seq}")
    cuda = dev.type == "cuda"
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    model = zoo.init_params(cfg, seed, device=dev)
    state = optim.init(model)
    step = make_train_step(cfg, optim.AdamWConfig(
        warmup_steps=2, total_steps=steps + (1 if long else 0)))

    def zipf(B, S, salt):
        return streams.sample_zipf_stream(seed + salt, B * S, cfg.vocab, 1.3,
                                          device=dev).reshape(B, S)

    name = f"train {arch} {cfg.n_layers}L B={batch} S={seq}"
    out = dict(arch=arch, n_layers=cfg.n_layers, reckoning=reck,
               run=ssm_train_steps(name, model, state, step, cfg,
                                   zipf(batch, seq, 0), dev, steps,
                                   check_launches=check_launches))
    rows = out["run"]["steps"]
    if not rows[-1]["loss"] < rows[0]["loss"]:
        fail(f"{name}: the loss did not fall ({rows[0]['loss']} -> "
             f"{rows[-1]['loss']})")
    log(f"  {arch}: training state reckoned {reck['state_gb']:.1f} GB, "
        f"peak device memory {out['run']['peak_gb']:.1f} GB")
    if long:
        B, S = long
        out["long"] = ssm_train_steps(
            f"train {arch} {cfg.n_layers}L B={B} S={S}", model, state, step,
            cfg, zipf(B, S, 1), dev, 1, first=steps + 1,
            check_launches=check_launches)
    del model, state, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 10: the training feed and its failure path
# ---------------------------------------------------------------------------

def evacuation_by_rule(owner, dead: int, n_hosts: int) -> list:
    """The moves the reference's capacity rule makes for ``dead``'s shards
    at uniform capacities, written out plainly: highest shard id first,
    each to the live host that owns the fewest (the lowest index on
    ties)."""
    import numpy as np
    owner = np.array(owner)
    live = [h for h in range(n_hosts) if h != dead]
    moves = []
    for sid in np.flatnonzero(owner == dead)[::-1]:
        counts = np.bincount(owner, minlength=n_hosts)
        dst = min(live, key=lambda h: (counts[h], h))
        owner[sid] = dst
        moves.append((int(sid), dst))
    return moves


def driver_run(name: str, trainer, dev, check_launches: bool,
               on_step=None) -> dict:
    """``trainer.run`` with the launch counts zeroed just before and read
    after every step: the loss finite; on the card, for an SSM or hybrid
    model, ``ssd_scan`` launched once a layer a micro-step (twice under
    remat "full"), ``ssd_scan_bwd`` once, and for every model the plain
    ``ssd_chunked`` never on CUDA tensors. Step ms and
    train tokens/s of every step, the saves' seconds, peak memory."""
    import torch
    cuda = dev.type == "cuda"
    cfg = trainer.cfg
    passes = cfg.grad_accum * (2 if cfg.remat == "full" else 1)
    ssm = cfg.family in ("ssm", "hybrid")
    expect = ({"ssd_scan": cfg.n_layers * passes,
               "ssd_scan_bwd": cfg.n_layers * cfg.grad_accum} if ssm
              else {})
    tokens = trainer.batch * trainer.pipe.cfg.seq_len
    rows, last = [], {}

    def step_done(row):
        now = read_counts()
        got = {k: now[k] - last[k] for k in expect}
        last.update(now)
        row = dict(row, launches=got, tokens_per_s=tokens / row["ms"] * 1e3)
        rows.append(row)
        log(f"  {name} step {row['step']}: loss {row['loss']:.5f}, lr "
            f"{row['lr']:.3e}, {row['ms']:.1f} ms = "
            f"{row['tokens_per_s']:,.0f} tokens/s (the feed "
            f"{row['feed_ms']:.2f} ms)"
            + (f", save {row['save_s']:.3f} s" if row["saved"] else "")
            + (f"; launches ssd_scan {got['ssd_scan']}, ssd_scan_bwd "
               f"{got['ssd_scan_bwd']}" if ssm else ""))
        if not math.isfinite(row["loss"]):
            fail(f"{name}: loss not finite at step {row['step']}")
        if cuda and check_launches and got != expect:
            fail(f"{name}: launches {got} at step {row['step']}, expected "
                 f"{expect} (every SSM layer's forward and recompute, its "
                 "backward once)")
        if on_step is not None:
            on_step(row)

    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    last.update(read_counts())
    t0 = time.perf_counter()
    trainer.run(on_step=step_done)
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_counts(name, counts, "ssd_scan_bwd" if ssm else None, dev,
                 check_launches)
    plain = [r for r in rows if not r["saved"]]
    saves = [r for r in rows if r["saved"]]
    out = dict(run=name, steps=rows, wall_s=wall,
               step_ms_mean=(sum(r["ms"] for r in plain) / len(plain)
                             if plain else None),
               feed_ms_mean=sum(r["feed_ms"] for r in rows) / len(rows),
               save_s=[r["save_s"] for r in saves],
               peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9 if cuda
                        else 0.0), launches=counts)
    log(f"  {name}: {len(rows)} steps in {wall:.2f} s; steps that do not "
        f"save " + (f"{out['step_ms_mean']:.1f} ms = "
                    f"{tokens / out['step_ms_mean'] * 1e3:,.0f} tokens/s"
                    if plain else "none")
        + "; save steps " + ", ".join(
            f"{r['step']}: {r['ms']:.1f} ms + save {r['save_s']:.3f} s"
            for r in saves)
        + f"; the feed {out['feed_ms_mean']:.2f} ms a step; peak device "
        f"memory {out['peak_gb']:.4f} GB")
    return out


def driver_path(dev, batch: int = 8, seq: int = 4096, smoke: bool = False,
                check_launches: bool = True, n_hosts: int = 4,
                ckpt_every: int = 4, fail_at: int = 6, steps_a: int = 9,
                steps_b: int = 12) -> dict:
    """(s) ``launch/train.py``'s driver on mamba2-130m (full size, or its
    smoke config), ``n_hosts`` hosts, a checkpoint every ``ckpt_every``
    steps in a temporary directory (removed at the end). Run A trains
    ``steps_a`` steps and loses host ``n_hosts - 1`` at ``fail_at``: its
    shards must move where the reference's capacity rule puts them at
    uniform capacities (``evacuation_by_rule``), and from then on no
    shard is on a dead host and none is lost. Run B resumes to
    ``steps_b``: it restores A's last checkpoint, which must equal A's
    final weights and optimizer state bit for bit (the step count too,
    so B's first lr is the schedule's at A's count), and trains from that
    step again. Every loss finite, B's last below A's first; the launches
    of every step (``driver_run``). The weights and the stream come from
    the driver's own seeds (0); the peak lr is the driver's default,
    3e-4, at full size and 1e-2 at the smoke config, whose model would
    not show a falling loss in 12 steps at 3e-4."""
    import gc
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch import optim
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.launch import train as driver
    arch = "mamba2-130m"
    cuda = dev.type == "cuda"
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    kw = dict(batch=batch, seq=seq, smoke=smoke, ckpt_dir=root,
              ckpt_every=ckpt_every, n_hosts=n_hosts,
              lr=1e-2 if smoke else 3e-4, device=dev)
    dead = n_hosts - 1
    try:
        a = driver.Trainer(arch, steps_a, fail_host_at=fail_at, **kw)
        log(f"  {arch}{' (smoke)' if smoke else ''}: {a.cfg.n_layers} "
            f"layers, batch {batch} x {seq}, {n_hosts} hosts x "
            f"{a.pipe.cfg.n_shards_per_host} shards, checkpoint every "
            f"{ckpt_every} steps; A: {steps_a} steps, host {dead} lost at "
            f"step {fail_at}; B: resume to {steps_b}")
        before = {}

        def owners(row):
            if row["step"] == fail_at - 1:
                before["owner"] = a.pipe.shard_owner.copy()
            if row["step"] >= fail_at:
                owner = a.pipe.shard_owner
                if (owner == dead).any() or not all(
                        a.runner.hosts[h].alive for h in set(owner.tolist())):
                    fail(f"driver A: a shard is on a dead host after step "
                         f"{row['step']}: {owner.tolist()}")
                if len(owner) != a.pipe.n_shards:
                    fail("driver A: shards lost")
            if row["step"] == fail_at:
                want = evacuation_by_rule(before["owner"], dead, n_hosts)
                if a.evacuated != want:
                    fail(f"driver A: evacuation {a.evacuated}, the rule "
                         f"gives {want}")

        run_a = driver_run("driver A", a, dev, check_launches, owners)
        committed = sorted(ckpt.all_steps(root))
        want = list(range(0, steps_a, ckpt_every))[-3:]
        if committed != want:
            fail(f"driver A: committed {committed}, expected {want}")
        final = [x.detach().clone()
                 for x in ckpt._flatten(a.tree())[0]]
        count = int(a.opt_state["step"])
        evacuated, owner_a = a.evacuated, a.pipe.shard_owner.tolist()
        del a
        gc.collect()
        b = driver.Trainer(arch, steps_b, resume=True, **kw)
        got = ckpt._flatten(b.tree())[0]
        if b.start_step != committed[-1] or len(got) != len(final) or any(
                x.dtype != y.dtype or not torch.equal(x, y)
                for x, y in zip(final, got)):
            fail(f"driver B: resumed at {b.start_step} with a state unlike "
                 "A's final one")
        del final, got
        gc.collect()
        first_lr = float(optim.schedule(b.opt_cfg, torch.tensor(
            count + 1, dtype=torch.int32, device=dev)))
        restore_s = b.restore_s
        log(f"  driver B: restored step {b.start_step} in {restore_s:.3f} "
            f"s, bit for bit A's final state (AdamW count {count})")
        run_b = driver_run("driver B", b, dev, check_launches)
        if run_b["steps"][0]["lr"] != first_lr:
            fail(f"driver B: first lr {run_b['steps'][0]['lr']}, the "
                 f"schedule at count {count + 1} gives {first_lr}")
        if not run_b["steps"][-1]["loss"] < run_a["steps"][0]["loss"]:
            fail("driver: B's last loss is not below A's first")
        del b
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    peak = max(run_a["peak_gb"], run_b["peak_gb"])
    log(f"  driver: loss {run_a['steps'][0]['loss']:.5f} -> "
        f"{run_b['steps'][-1]['loss']:.5f}; host {dead}'s shards (shard, "
        f"new host) {evacuated}; owners after A {owner_a}; committed "
        f"{committed}; restore {restore_s:.3f} s; peak device memory "
        f"{peak:.4f} GB")
    return dict(arch=arch, batch=[batch, seq], n_hosts=n_hosts,
                committed=committed, evacuated=evacuated, owner_a=owner_a,
                restore_s=restore_s, a=run_a, b=run_b, peak_gb=peak)


def stream_path(dev, seed: int, fixed: list, n_layers: int | None = 1,
                steps: int = 5, smoke: bool = False,
                check_launches: bool = True) -> dict:
    """(t) phase 8's model (p) on a token stream: step i trains on
    ``ShardedTokenPipeline(PipelineConfig(vocab, seq_len=1,024,
    global_batch=8, n_hosts=4)).global_batch(i)``, zipf(1.1), a fresh
    batch each step (``train_run``, routers "cg" and "topk", uniform
    capacities); CG must drop no more than top-k on the first step, as
    in phase 8. The loss need not fall: a step's loss is on a batch no
    step trained on, and at this lr it rose on the card (PERF.md §6,
    ``tools/moe_stream_torch.py``). What must hold on fresh batches is
    ``stream_reference_check``: the card's train step is the CPU's over
    the stream. Logs ``moe_drop_frac`` and ``moe_max_load_frac`` at each
    step beside phase 8's fixed-batch runs (``fixed``: its cg and topk
    runs at uniform capacities)."""
    from repro_torch.data import PipelineConfig, ShardedTokenPipeline
    base = moe_config(n_layers, smoke)
    B, S = (8, 64) if smoke else (8, 1024)
    pipe = ShardedTokenPipeline(PipelineConfig(
        vocab=base.vocab, seq_len=S, global_batch=B, n_hosts=4))
    log(f"  {base.arch_id}{' (smoke)' if smoke else ''}: {base.n_layers} "
        f"layer(s), batch {B} x {S} a step from the pipeline "
        f"({pipe.n_shards} shards, zipf({pipe.cfg.zipf_z}))")

    def batches(i):
        return pipe.global_batch(i).to(dev)

    runs = [train_run(moe_config(n_layers, smoke, router), batches, dev,
                      seed, steps, check_launches)
            for router in ("cg", "topk")]
    cg, topk = (r["steps"][0]["drop_frac"] for r in runs)
    if cg > topk:
        fail(f"train stream: CG dropped more than top-k ({cg} > {topk})")
    for i in range(steps):
        log(f"  step {i + 1} drop_frac / max_load_frac: stream "
            + " | ".join(f"{r['router']} {r['steps'][i]['drop_frac']:.4f} / "
                         f"{r['steps'][i]['max_load_frac']:.4f}"
                         for r in runs)
            + "; fixed batch (phase 8) " + " | ".join(
                f"{r['router']} {r['steps'][i]['drop_frac']:.4f} / "
                f"{r['steps'][i]['max_load_frac']:.4f}"
                for r in fixed if i < len(r["steps"])))
    return dict(arch=base.arch_id, n_layers=base.n_layers, batch=[B, S],
                runs=runs, reference=stream_reference_check(dev, seed,
                                                             steps))


def stream_reference_check(dev, seed: int, steps: int = 5) -> dict:
    """(t)'s train step on fresh batches, the card against the CPU from
    the same weights: the MoE smoke config in f32 with grad_accum 2,
    ``steps`` AdamW steps as ``train_run`` takes them but with eps 1e-5
    (as ``train_reference_check``, which explains why), step i on the
    pipeline's ``global_batch(i)`` (8 × 64 zipf(1.1) tokens). Every
    step's loss, lr and grad_norm within 1e-5 relative and its routing
    telemetry equal. The CPU's losses on such a stream are the
    reference's (``tests/test_torch_train.py::
    test_train_steps_on_the_token_stream_match_jax``), so a fault of the
    train step on fresh batches fails here, whatever the loss does at
    full width."""
    import copy
    import torch
    from repro_torch import optim
    from repro_torch.data import PipelineConfig, ShardedTokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model_zoo as zoo
    cfg = moe_config(None, smoke=True).replace(dtype="float32",
                                               grad_accum=2)
    pipe = ShardedTokenPipeline(PipelineConfig(
        vocab=cfg.vocab, seq_len=64, global_batch=8, n_hosts=4))
    opt_cfg = optim.AdamWConfig(warmup_steps=2, total_steps=steps,
                                eps=1e-5)
    cpu = torch.device("cpu")
    host = zoo.init_params(cfg, seed, device=cpu)
    runs = []
    for where, model in ((cpu, host), (dev, copy.deepcopy(host).to(dev))):
        state, step = optim.init(model), make_train_step(cfg, opt_cfg)
        runs.append([])
        for i in range(steps):
            model, state, m = step(model, state,
                                   {"tokens": pipe.global_batch(i).to(where)})
            runs[-1].append({k: v.detach().cpu() for k, v in m.items()})
    worst = 0.0
    for i, (a, b) in enumerate(zip(*runs)):
        for k in ("loss", "lr", "grad_norm"):
            err = abs(float(a[k]) - float(b[k])) / abs(float(a[k]))
            worst = max(worst, err)
            if err > 1e-5:
                fail(f"stream reference: step {i + 1} {k} differs (rel "
                     f"{err})")
        for k in ("moe_drop_frac", "moe_max_load_frac", "moe_load"):
            if not torch.equal(a[k], b[k]):
                fail(f"stream reference: step {i + 1} routing telemetry {k} "
                     "differs")
    losses = [float(r["loss"]) for r in runs[1]]
    log(f"  {MOE_ARCH} smoke config in f32 on the pipeline's stream, "
        f"{steps} train steps (grad_accum {cfg.grad_accum}), card vs CPU: "
        f"loss, lr, grad_norm max rel {worst:.2e}, routing telemetry "
        "equal; losses " + ", ".join(f"{x:.5f}" for x in losses))
    return dict(losses=losses, max_rel_err=worst)


# ---------------------------------------------------------------------------
# Phase 11: the mesh tier
# ---------------------------------------------------------------------------

MESH_RANKS = 8
# benchmarks/bench_multihost.py --demo's deployment: 2^21 zipf(1.2) keys
# over 100,000, 8,192 bins, blocks of 2,048, probe chunk 16, 8 sources
# (one a rank on MESH_RANKS ranks); 7 more keys make a sub-S ragged tail
MESH_DEMO = dict(M=2**21 + 7, n_bins=8192, block=2048, chunk=16, eps=0.05,
                 n_sources=8)
MESH_SYNC = (1, 3)


def mesh_demo_keys(seed: int, M: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    return (rng.zipf(1.2, M) % 100_000).astype(np.int32)


def same_arrays(name: str, got, want) -> float:
    """Fails unless the host arrays have equal shapes and values; returns
    their largest difference."""
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    err = (float(np.abs(got.astype(float) - want.astype(float)).max())
           if got.shape == want.shape and got.size else
           0.0 if got.shape == want.shape else float("nan"))
    if got.shape != want.shape or not np.array_equal(got, want):
        fail(f"{name}: {got.shape} differs from {want.shape} (max abs err "
             f"{err})")
    return err


def same_serving(name: str, got: dict, want: dict) -> None:
    """Two ``serve_under_chaos`` traces: every admitted batch's replica
    ids, every tick's counts, the served counts, the owner map and every
    request's latency."""
    if len(got["admitted"]) != len(want["admitted"]):
        fail(f"{name}: {len(got['admitted'])} admitted batches against "
             f"{len(want['admitted'])}")
    for i, (x, y) in enumerate(zip(got["admitted"], want["admitted"])):
        same_arrays(f"{name}: admitted batch {i}", x, y)
    if got["ticks"] != want["ticks"]:
        fail(f"{name}: the per-tick counts differ")
    if got["per_replica"] != want["per_replica"]:
        fail(f"{name}: served {got['per_replica']} against "
             f"{want['per_replica']}")
    same_arrays(f"{name}: owner map", got["owner"], want["owner"])
    same_arrays(f"{name}: latencies", got["latency"], want["latency"])


def mesh_path(dev, seed: int, n_ticks: int = 500, per_tick: int = 2048,
              M: int = MESH_DEMO["M"], ranks: int = MESH_RANKS,
              reps: int = 3, check_launches: bool = True) -> dict:
    """(u) the mesh tier. (u1) one rank, over NCCL on the card (gloo on
    the CPU): ``serve_under_chaos`` at phase 5's deployment without its
    policy (the mesh refuses W-Choices) over ``MeshCGRequestRouter`` and
    over the single-host ``CGRequestRouter`` of the same configuration,
    which must agree batch for batch; then that rank routes the demo
    stream (``MESH_DEMO``, ``M`` keys). (u2) ``ranks`` ranks started
    with ``spawn_ranks`` on the one card over gloo (NCCL refuses two
    ranks on a device): each routes its lanes of the demo stream with
    the kernel at sync 1 and 3, and serves a kill-one (4 replicas, 30
    ticks, async). The single-host twin of (u1) routes with the plain
    engine, and every route of the demo stream (one rank, each of
    ``ranks``, and on the card the single-process kernel route) must
    equal the plain ``ref_porc_multisource(engine="snapshot")`` in this
    process bit for bit (assignment, base, every lane, ticks, routed);
    each rank must launch the kernel. ``max_abs_err`` is the largest
    difference of all those comparisons. Times the mesh route at one rank
    and at ``ranks`` beside the single-process kernel route on the same
    stream (``reps`` calls each, median); the ranks of (u2) share one
    card, so theirs is no scale-out figure."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import (engine_chaos, make_source_mesh,
                                         route, run_all, spawn_ranks)
    from repro_torch.serve import CGRequestRouter, MeshCGRequestRouter
    on_card = dev.type == "cuda"
    demo = dict(MESH_DEMO, M=M)
    keys = mesh_demo_keys(seed, M)
    route_kw = dict(n_bins=demo["n_bins"], n_sources=demo["n_sources"],
                    block=demo["block"], chunk=demo["chunk"], eps=demo["eps"])
    out = {}
    errs = []

    # (u1) one rank: the serving trace against the plain single-host
    # router's
    backend = "nccl" if on_card else "gloo"
    mesh = make_source_mesh(backend=backend, device=dev)
    try:
        skeys = serving_keys(seed, n_ticks, per_tick)
        router = MeshCGRequestRouter(mesh=mesh, device=dev,
                                     **serving_router_kw())
        zero_counts()
        mesh.collectives.clear()
        u1, trace = serve_under_chaos(
            f"(u1) MeshCGRequestRouter, 1 rank over {mesh.backend}", router,
            skeys, n_ticks, per_tick, dev)
        counts = read_counts()
        check_counts("(u1)", counts, "porc_multisource_scan", dev,
                     check_launches)
        u1.update(backend=mesh.backend, launches=counts[
            "porc_multisource_scan"], collectives=dict(mesh.collectives))
        twin = CGRequestRouter(device=dev,
                               **dict(serving_router_kw(), engine="ref"))
        u1_twin, twin_trace = serve_under_chaos(
            "(u1) single-host CGRequestRouter, plain engine", twin, skeys,
            n_ticks, per_tick, dev)
        same_serving("(u1) mesh vs single-host", trace, twin_trace)
        log(f"  (u1) {len(trace['admitted'])} admitted batches, every tick's "
            "counts, served per replica, the owner map and every latency "
            f"equal the plain single-host router's; kernel launches "
            f"{u1['launches']}, collectives {u1['collectives']}")
        out["u1"] = dict(mesh=u1, single_host=u1_twin)
        del trace, twin_trace, skeys
        # the demo stream on this one rank
        one = {s: route(mesh, keys, sync_every=s, timed_reps=reps,
                        **route_kw)
               for s in MESH_SYNC}
    finally:
        mesh.close()

    # (u2) `ranks` ranks on this device over gloo
    t0 = time.perf_counter()
    cases = [(route, dict(keys=keys, sync_every=s, timed_reps=reps,
                          **route_kw))
             for s in MESH_SYNC]
    cases.append((engine_chaos, {}))
    runs = spawn_ranks(run_all, ranks, cases, backend="gloo",
                       device=str(dev))
    spawn_s = time.perf_counter() - t0
    res = [r["results"] for r in runs]
    program_s = [float(max(r["seconds"][i] for r in runs))
                 for i in range(len(cases))]
    kt = torch.from_numpy(keys).to(dev)
    engine = "cuda" if on_card else "auto"
    rows = []
    def single_process(s: int, eng: str) -> dict:
        a, st = ref.ref_porc_multisource(
            kt, demo["n_bins"], demo["n_sources"], sync_every=s,
            block=demo["block"], eps=demo["eps"], chunk=demo["chunk"],
            engine=eng, device=dev)
        return dict(assign=a.cpu().numpy(), base=st.base.cpu().numpy(),
                    delta=st.delta.cpu().numpy(), ticks=int(st.ticks),
                    routed=float(st.routed))

    for i, s in enumerate(MESH_SYNC):
        want = single_process(s, "snapshot")
        routes = [("1 rank", one[s])] + [
            (f"rank {r} of {ranks}", rr[i]) for r, rr in enumerate(res)]
        if on_card:
            routes.append(("single-process kernel route",
                           single_process(s, engine)))
        for label, got in routes:
            for f in ("assign", "base", "delta", "ticks", "routed"):
                errs.append(same_arrays(f"(u) sync {s}, {label}: {f}",
                                        got[f], want[f]))
            if check_launches and on_card and "launches" in got and \
                    got["launches"] <= 0:
                fail(f"(u) sync {s}, {label}: the kernel never launched")
        ref_s = []
        for _ in range(reps):
            if on_card:
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            ref.ref_porc_multisource(
                kt, demo["n_bins"], demo["n_sources"], sync_every=s,
                block=demo["block"], eps=demo["eps"], chunk=demo["chunk"],
                engine=engine, device=dev)
            if on_card:
                torch.cuda.synchronize(dev)
            ref_s.append(time.perf_counter() - t1)
        per_rep = np.max([rr[i]["seconds"] for rr in res], axis=0)
        row = dict(
            sync_every=s, messages=M,
            single_process_msgs_per_s=M / float(np.median(ref_s)),
            one_rank_msgs_per_s=M / float(np.median(one[s]["seconds"])),
            ranks_msgs_per_s=M / float(np.median(per_rep)), ranks=ranks,
            one_rank_launches=one[s]["launches"],
            one_rank_collectives=one[s]["collectives"],
            rank_launches=[rr[i]["launches"] for rr in res],
            rank_collectives=res[0][i]["collectives"],
            rank_host_copies=res[0][i]["host_copies"])
        rows.append(row)
        log(f"  (u) sync {s}: {M} messages on 1 rank ({backend}), on each "
            f"of {ranks} ranks (gloo)"
            + (" and through the single-process kernel route" if on_card
               else "") + " identical to the plain "
            "ref_porc_multisource(engine='snapshot') in one process")
        log(f"  (u) sync {s}: msgs/s single-process route (engine={engine!r}) "
            f"{row['single_process_msgs_per_s']:,.0f}; mesh route 1 rank "
            f"({backend}) {row['one_rank_msgs_per_s']:,.0f}; {ranks} ranks "
            f"(gloo, {ranks} processes sharing one card: not a scale-out "
            f"figure) {row['ranks_msgs_per_s']:,.0f}")
        log(f"  (u) sync {s}: a call: 1 rank {row['one_rank_launches']} "
            f"launches, collectives {row['one_rank_collectives']}; each of "
            f"{ranks} ranks {row['rank_launches'][0]} launches, collectives "
            f"{row['rank_collectives']}, {row['rank_host_copies']} host "
            "copies (gloo staging)")
    chaos = [rr[-1] for rr in res]
    for r, c in enumerate(chaos):
        if not all(sub == srv + fl for sub, srv, fl in c["trace"]) or \
                c["in_flight"] or c["dropped"] or c["evacuations"] != 1 \
                or c["submitted"] != c["served"]:
            fail(f"(u2) rank {r}: the kill-one run lost requests or never "
                 f"evacuated: {c['submitted']} submitted, {c['served']} "
                 f"served, {c['in_flight']} in flight, {c['dropped']} "
                 f"dropped, {c['evacuations']} evacuations")
        if c["per_replica"] != chaos[0]["per_replica"]:
            fail(f"(u2) rank {r} served {c['per_replica']}, rank 0 "
                 f"{chaos[0]['per_replica']}")
        same_arrays(f"(u2) rank {r}: owner map", c["owner"],
                    chaos[0]["owner"])
    log(f"  (u2) kill-one on {ranks} ranks: {chaos[0]['submitted']} "
        f"submitted, served {chaos[0]['per_replica']} on every rank, "
        f"drained in {chaos[0]['drain']} ticks, 0 lost, 0 dropped")
    log(f"  (u2) the {ranks} ranks took {spawn_s:.1f} s: the slowest rank's "
        f"programs {', '.join(f'{x:.1f}' for x in program_s)} s (route at "
        f"sync {', '.join(map(str, MESH_SYNC))} with {reps} timed calls "
        "each, "
        f"the kill-one), the rest start-up and teardown")
    launches = out["u1"]["mesh"]["launches"] + sum(
        one[s]["launches"] for s in MESH_SYNC) + sum(
        sum(rr[i]["launches"] for i in range(len(MESH_SYNC))) for rr in res)
    out.update(routes=rows, chaos_per_replica=chaos[0]["per_replica"],
               spawn_s=spawn_s, program_s=program_s, launches=launches,
               max_abs_err=max(errs))
    return out


# ---------------------------------------------------------------------------
# Phase 12: serving the dense decoder family and its VLM variant
# ---------------------------------------------------------------------------

# each arch at full width: the prefill's batch and prompt (internvl2's
# 768 tokens follow its 256 patches), the greedy decode steps after it;
# command-r-plus-104b's depth cut from 64 to 8 layers (31.5 GB of bf16
# weights; the whole model is 208 GB)
DENSE_RUNS = {
    "gemma3-1b": dict(batch=8, seq=1024, decode_steps=32),
    "internlm2-20b": dict(batch=8, seq=1024, decode_steps=32),
    "starcoder2-3b": dict(batch=2, seq=8192, decode_steps=16),
    "internvl2-2b": dict(batch=8, seq=768, decode_steps=32),
    "command-r-plus-104b": dict(batch=2, seq=1024, decode_steps=8,
                                n_layers=8),
}
# gemma3's ring-buffer decode (v2): batch, max_len (past the 65,536 of
# ``model_zoo._use_longctx``), steps, of which the uniform cache of the
# same length takes the first 8 (~0.74 s a step: every layer expands
# its 131,072 × 8 K and V to 4 f32 heads); ring against uniform within
# the bf16 bound of the prefill/decode check at full size, and within
# 1e-5 in f32 on the smoke config past its window's wrap (the two sum
# the same entries in another order)
RING = (8, 131_072, 64, 8)
RING_TOL_F32 = 1e-5
# (v2) past the ring's wrap at full width: steps before and after it
# from a B=1 prefill of W - 8 tokens (~0.1 s a uniform step at B 1)
RING_WRAP = (8, 24)


def dense_inputs(cfg, batch: int, seq: int, gen, dev):
    """``batch`` random prompts of ``seq`` tokens and, for the VLM, its
    ``n_patches`` random patch embeddings a prompt, in the model's
    dtype."""
    import torch
    from repro_torch.models.layers import torch_dtype
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device=dev, dtype=torch.int32)
    if cfg.family != "vlm":
        return tokens, None
    patches = torch.randn((batch, cfg.n_patches, cfg.vision_dim),
                          generator=gen, device=dev)
    return tokens, patches.to(torch_dtype(cfg.dtype))


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def ring_decode(model, cfg, dev, gen, batch: int, max_len: int,
                steps: int, uniform_steps: int) -> dict:
    """(v2) ``steps`` greedy decode steps from an empty cache of
    ``max_len`` positions, the zoo's cache, which past 65,536 positions
    is gemma3's ring (local layers W entries, global layers
    ``max_len``); then ``uniform_steps`` from the uniform cache of the
    same ``max_len`` fed the same tokens. Per cache: its bytes, ms/step
    (each step ends in a synchronize), the peak device memory of the
    steps; each step's logits of the two within ``CONSISTENCY_TOL``."""
    import torch
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import transformer
    toks = [torch.randint(0, cfg.vocab, (batch, 1), generator=gen,
                          device=dev, dtype=torch.int32)]
    out, logits = {}, {}
    for kind, n in (("ring", steps), ("uniform", uniform_steps)):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        cache = (zoo.init_cache(cfg, batch, max_len, device=dev)
                 if kind == "ring"
                 else transformer.init_cache(cfg, batch, max_len, device=dev))
        if (kind == "ring") != ("local_k" in cache):
            fail(f"ring decode: the zoo's cache at {max_len} positions is "
                 f"not the {kind} cache")
        cache_gb = nbytes(cache.values()) / 1e9
        ms, logits[kind] = [], []
        for i in range(n):
            t0 = time.perf_counter()
            lg, cache = zoo.decode_step(model, cfg, cache, toks[i])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            if kind == "ring":
                toks.append(torch.argmax(lg, -1)[:, None].to(torch.int32))
            logits[kind].append(lg.cpu())
        if int(cache["pos"]) != n:
            fail(f"ring decode ({kind}): cache position {int(cache['pos'])}")
        del cache
        steady = sorted(ms[1:])
        out[kind] = dict(
            steps=n, cache_gb=cache_gb, ms_first=ms[0],
            ms_mean=sum(ms[1:]) / (n - 1), ms_median=steady[len(steady) // 2],
            peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                     if dev.type == "cuda" else 0.0))
    err = max(relerr(u, r) for r, u in zip(logits["ring"],
                                           logits["uniform"]))
    if not all(torch.isfinite(x).all() for x in logits["ring"]) \
            or not err < CONSISTENCY_TOL:
        fail(f"ring decode: ring and uniform logits differ by {err:.3e}")
    out["max_rel_err"] = err
    for kind in ("ring", "uniform"):
        r = out[kind]
        log(f"  (v2) {kind} cache B={batch} max_len={max_len:,}: "
            f"{r['cache_gb']:.2f} GB; {r['steps']} decode steps "
            f"{r['ms_mean']:.2f} ms/step mean, {r['ms_median']:.2f} median "
            f"(first {r['ms_first']:.2f}); peak device memory "
            f"{r['peak_gb']:.2f} GB")
    log(f"  (v2) ring vs uniform logits: max rel err {err:.3e} over "
        f"{uniform_steps} steps")
    return out


def ring_from_prefill(cfg, cache, max_len: int) -> dict:
    """gemma3's ring-buffer cache holding what a prefill of at most W
    positions wrote into the uniform ``cache`` (padded to ``max_len``):
    a local layer's ring takes the first W positions (position p < W
    sits in slot p % W = p), a global layer its whole cache; copies, so
    the two caches decode apart."""
    import torch
    from repro_torch.models import transformer
    W, ge = cfg.sliding_window, cfg.global_every
    if int(cache["pos"]) > W or cache["k"].shape[2] != max_len:
        fail(f"ring from prefill: {int(cache['pos'])} positions in a cache "
             f"of {cache['k'].shape[2]}")
    is_global = [l % ge == ge - 1 for l in range(cfg.n_layers)]
    ring = {"pos": cache["pos"].clone()}
    for kv in ("k", "v"):
        ring[f"local_{kv}"] = torch.stack(
            [cache[kv][l, :, :W] for l, g in enumerate(is_global) if not g])
        ring[f"global_{kv}"] = torch.stack(
            [cache[kv][l] for l, g in enumerate(is_global) if g])
    spec = transformer.longctx_cache_spec(cfg, cache["k"].shape[1], max_len)
    if any(ring[n].shape != spec[n].shape for n in spec):
        fail("ring from prefill: not the shapes of longctx_cache_spec")
    return ring


def ring_wrap(model, cfg, dev, gen, max_len: int, before: int,
              after: int) -> dict:
    """(v2) past the ring's wrap: one prompt of W - ``before`` tokens
    prefilled into the uniform cache of ``max_len`` positions, the same
    entries copied into the ring (``ring_from_prefill``), then
    ``before + after`` greedy steps from each, fed the same tokens. The
    last ``after`` steps overwrite slots 0 .. after - 1 of every local
    ring (slot pos % W) and attend over its W entries, where the uniform
    cache masks the entries below pos + 1 - W; each step's logits within
    ``CONSISTENCY_TOL``."""
    import torch
    from repro_torch.models import model_zoo as zoo
    W = cfg.sliding_window
    tokens, _ = dense_inputs(cfg, 1, W - before, gen, dev)
    _, uni = zoo.prefill_step(model, cfg, {"tokens": tokens}, pad_to=max_len)
    ring = ring_from_prefill(cfg, uni, max_len)
    tok, errs = tokens[:, -1:], []
    for _ in range(before + after):
        rl, ring = zoo.decode_step(model, cfg, ring, tok)
        ul, uni = zoo.decode_step(model, cfg, uni, tok)
        if not torch.isfinite(rl).all():
            fail("ring wrap: the ring's logits are not finite")
        errs.append(relerr(ul, rl))
        tok = torch.argmax(rl, -1)[:, None].to(torch.int32)
    if {int(ring["pos"]), int(uni["pos"])} != {W + after}:
        fail(f"ring wrap: positions {int(ring['pos'])}, {int(uni['pos'])}")
    del ring, uni
    err = max(errs)
    if not err < CONSISTENCY_TOL:
        fail(f"ring wrap: ring and uniform logits differ by {err:.3e}")
    out = dict(start=W - before, steps=before + after, window=W,
               max_rel_err=err, max_rel_err_past_wrap=max(errs[before:]))
    log(f"  (v2) past the wrap, B=1 max_len={max_len:,}: {before} steps "
        f"from position {W - before} to the window's {W}, then {after} "
        f"past it, each overwriting slot pos % {W} of the local rings: "
        f"ring vs uniform logits max rel err {err:.3e} "
        f"({out['max_rel_err_past_wrap']:.3e} past the wrap)")
    return out


def dense_path(dev, seed: int, arch: str, *, batch: int, seq: int,
               decode_steps: int, n_layers: int | None = None,
               smoke: bool = False, long: tuple | None = None,
               gap: bool = False, serving: bool = False,
               ring: tuple | None = None,
               check_launches: bool = True) -> dict:
    """``arch`` (a dense or VLM arch) at its full config (depth cut to
    ``n_layers`` if given), random bf16 weights from a seeded
    ``torch.Generator``: after a warm-up of the same shape, ``timed_run``
    on ``batch`` prompts of ``seq`` tokens (the VLM's patches first) and
    ``decode_steps`` greedy steps, with the weights' bytes, the decode
    step's bound (the weights read once) and the peak device memory.
    ``gap``: ``prefill(prompt[:-1])`` + ``decode(last)`` against
    ``prefill(prompt)`` on the same prompts, then in f32 (new weights
    from the same generator) on two prompts of 1.5 windows, which the
    window masks. ``long`` (B, S, steps): ``timed_run`` on B prompts of
    S tokens with its own peak; past ``attn_chunk_threshold`` every layer
    takes ``chunked_attention`` (``timed_run`` checks). ``ring``:
    ``ring_decode``, then ``ring_wrap`` at its ``max_len``.
    ``serving``: ``launch/serve.py``'s ``serve`` over the model (the
    router's ``porc_multisource_scan`` must launch).
    ``smoke`` takes the smoke config, for a rehearsal on the CPU. The
    model is freed before it returns."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model_zoo as zoo
    cfg = (configs.get_smoke_config(arch) if smoke
           else configs.get_config(arch))
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = zoo.init_params(cfg, gen, device=dev)
    tokens, patches = dense_inputs(cfg, batch, seq, gen, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    n_params = zoo.count_params(model)
    weight_gb = nbytes(model.parameters()) / 1e9
    bound_ms = weight_gb * 1e9 / HBM_BYTES_PER_S * 1e3
    log(f"  {arch}{' (smoke)' if smoke else ''}: {cfg.n_layers} layers, "
        f"{n_params:,} params ({weight_gb:.2f} GB of weights; a decode "
        f"step reads them once: {bound_ms:.2f} ms at 3.35 TB/s) drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    n_pre = 0 if patches is None else patches.shape[1]
    inputs = {"tokens": tokens}
    if patches is not None:
        inputs["patches"] = patches
    # warm-up (library handles, the allocator's pools), not timed
    _, cache = zoo.prefill_step(model, cfg, inputs, pad_to=n_pre + seq + 2)
    for _ in range(2):
        _, cache = zoo.decode_step(model, cfg, cache, tokens[:, :1])
    del cache
    name = f"{arch} {cfg.n_layers}L B={batch} S={n_pre + seq}"
    run = timed_run(name, model, cfg, tokens, decode_steps, dev,
                    patches=patches)
    check_counts(name, run["launches"], None, dev, check_launches)
    out = dict(arch=arch, n_layers=cfg.n_layers, params=n_params,
               weight_gb=weight_gb, decode_bound_ms=bound_ms, run=run,
               peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else 0.0))
    log(f"  {name}: peak device memory {out['peak_gb']:.2f} GB against "
        f"{weight_gb:.2f} GB of weights; decode "
        f"{run.get('decode_ms_mean', 0.0):.2f} ms/step against its bound "
        f"{bound_ms:.2f} ms")
    if gap:
        out["consistency_rel_err"] = prefill_decode_gap(model, cfg, tokens)
        if not out["consistency_rel_err"] < CONSISTENCY_TOL:
            fail(f"{name}: prefill(prompt[:-1]) + decode(last) differs "
                 f"from prefill(prompt) by {out['consistency_rel_err']:.3e}")
        log(f"  {name}: prefill(prompt[:-1]) + decode(last) vs "
            f"prefill(prompt): {out['consistency_rel_err']:.3e} relative")
    if long:
        B, S, steps = long
        long_tokens, long_patches = dense_inputs(cfg, B, S, gen, dev)
        long_inputs = {"tokens": long_tokens}
        if long_patches is not None:
            long_inputs["patches"] = long_patches
        zoo.prefill_step(model, cfg, long_inputs)                # warm-up
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        lname = f"{arch} {cfg.n_layers}L B={B} S={S}"
        out["long"] = timed_run(lname, model, cfg, long_tokens, steps, dev,
                                patches=long_patches)
        check_counts(lname, out["long"]["launches"], None, dev,
                     check_launches)
        out["long"]["peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                                  if dev.type == "cuda" else 0.0)
        log(f"  {lname}: peak device memory {out['long']['peak_gb']:.2f} GB")
        del long_tokens, long_patches, long_inputs
    if ring:
        out["ring"] = ring_decode(model, cfg, dev, gen, *ring)
        out["ring_wrap"] = ring_wrap(model, cfg, dev, gen, ring[1],
                                     *RING_WRAP)
    if serving:
        out["serving"] = serve_model(arch, cfg, model, dev, seed,
                                     ("porc_multisource_scan",),
                                     check_launches)
    del model
    if gap:
        cfg32 = cfg.replace(dtype="float32")
        S32 = (cfg.sliding_window or seq) * 3 // 2
        t32, _ = dense_inputs(cfg, 2, S32, gen, dev)
        out["consistency_f32_rel_err"] = prefill_decode_gap(
            zoo.init_params(cfg32, gen, device=dev), cfg32, t32)
        if not out["consistency_f32_rel_err"] < CONSISTENCY_TOL_F32:
            fail(f"{arch} f32: prefill(prompt[:-1]) + decode(last) differs "
                 f"from prefill(prompt) by "
                 f"{out['consistency_f32_rel_err']:.3e}")
        log(f"  {arch} in f32, 2 x {S32} tokens: prefill(prompt[:-1]) + "
            f"decode(last) vs prefill(prompt): "
            f"{out['consistency_f32_rel_err']:.3e} relative")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def dense_phase(dev, seed: int) -> dict:
    """Phase 12: (v), (v2), (v3) over gemma3-1b, then (w), (x), (y), (z),
    then the smoke configs card vs CPU; the reports by arch."""
    dense = {"gemma3-1b": dense_path(
        dev, seed, "gemma3-1b", **DENSE_RUNS["gemma3-1b"],
        long=(2, 4096, 4), gap=True, ring=RING, serving=True)}
    for arch in list(DENSE_RUNS)[1:]:
        dense[arch] = dense_path(dev, seed, arch, **DENSE_RUNS[arch])
    dense["reference"] = dense_reference_check(dev, seed)
    return dense


def dense_reference_check(dev, seed: int, ring_steps: int = 40) -> dict:
    """The port's path on the card against the same path on the CPU: the
    five archs' smoke configs in f32 with the same weights, a prefill of
    [2, 64] tokens (internvl2's patches first) and 4 greedy decode steps;
    the logits within 1e-4 relative to their largest magnitude (f32
    matmuls round differently on the two devices; TF32 is off), the
    greedy tokens equal. Then gemma3's ring-buffer decode against the
    uniform one on the card over ``ring_steps`` steps, past the smoke
    window's wrap (16): each step's logits within ``RING_TOL_F32``."""
    import copy
    import torch
    from repro_torch import configs
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import transformer
    cpu = torch.device("cpu")
    errs = {}
    for arch in DENSE_RUNS:
        cfg = configs.get_smoke_config(arch).replace(dtype="float32")
        host = zoo.init_params(cfg, seed, device=cpu)
        card = copy.deepcopy(host).to(dev)
        g = torch.Generator().manual_seed(seed)
        tokens = torch.randint(0, cfg.vocab, (2, 64), generator=g,
                               dtype=torch.int32)
        patches = (torch.randn((2, cfg.n_patches, cfg.vision_dim),
                               generator=g) if cfg.family == "vlm" else None)
        err = 0.0
        for a, b in zip(greedy_logits(host, cfg, tokens, patches=patches),
                        greedy_logits(card, cfg, tokens.to(dev),
                                      patches=None if patches is None
                                      else patches.to(dev))):
            err = max(err, relerr(a, b))
            if not relerr(a, b) <= 1e-4 \
                    or not torch.equal(a.argmax(-1), b.argmax(-1)):
                fail(f"{arch} reference: the card's logits differ from the "
                     f"CPU's (max rel {relerr(a, b)})")
        errs[arch] = err
        log(f"  {arch} smoke config in f32, card vs CPU: logits max rel err "
            f"{err:.2e} over prefill + 4 decode steps; greedy tokens equal")
        if arch == "gemma3-1b":
            ring = transformer.init_longctx_cache(cfg, 2, 64, device=dev)
            uni = transformer.init_cache(cfg, 2, 64, device=dev)
            toks = torch.randint(0, cfg.vocab, (ring_steps, 2, 1),
                                 generator=g, dtype=torch.int32).to(dev)
            ring_err = 0.0
            for x in toks:
                rl, ring = zoo.decode_step(card, cfg, ring, x)
                ul, uni = zoo.decode_step(card, cfg, uni, x)
                ring_err = max(ring_err, relerr(ul, rl))
            if not ring_err <= RING_TOL_F32:
                fail(f"gemma3 ring decode on the card differs from the "
                     f"uniform one by {ring_err:.3e}")
            errs["gemma3-1b ring vs uniform"] = ring_err
            log(f"  gemma3-1b smoke config in f32 on the card: ring vs "
                f"uniform decode over {ring_steps} steps (window "
                f"{cfg.sliding_window}) max rel err {ring_err:.2e}")
    return dict(max_rel_err=errs)


# ---------------------------------------------------------------------------
# Phase 13: whisper served and trained; the dense, VLM and audio families
# trained
# ---------------------------------------------------------------------------

WHISPER = "whisper-small"
# (aa): 30 s of audio, 1,500 frames after Whisper's conv frontend (whose
# output the reference's stub takes as embeddings), a decoder cache of
# Whisper's 448 positions, 64 greedy steps after the prompt
WHISPER_RUN = dict(batch=8, frames=1500, max_len=448, decode_steps=64)
# Whisper's start-of-transcript prompt in its multilingual vocabulary of
# 51,865: <|startoftranscript|> <|en|> <|transcribe|> <|notimestamps|>
SOT_PROMPT = (50258, 50259, 50359, 50363)
# the training cells (ab)-(ae) at full size: batch, tokens and beside
# them the VLM's 256 patches or whisper's 1,500 frames
TRAIN_CELLS = {"gemma3-1b": dict(batch=8, seq=1024),
               "starcoder2-3b": dict(batch=8, seq=1024),
               "internvl2-2b": dict(batch=8, seq=768),
               "whisper-small": dict(batch=8, seq=448, frames=1500)}
# their AdamW: peak 3e-5, warm-up 2, a tenth of it at the end. Adam's
# first steps move every weight by about lr whatever its gradient; at
# 3e-4 starcoder2-3b's loss rose on its fixed batch (11.47 -> 17.46 at
# step 2, 12.51 at step 5)
TRAIN_CELL_OPT = dict(lr_peak=3e-5, lr_min=3e-6, warmup_steps=2)
REMAT_ARCH = "gemma3-1b"
# the remat policies run the same forward, so their first loss agrees up
# to the order of the card's sums; after it the weights' bf16 gradients
# may sum in another order (the tied table's two uses), which AdamW's
# first steps carry into the weights at a rounding's weight
REMAT_LOSS_TOL = (1e-6, 1e-3)
# the policies against "none" on the card in f32, loss and every
# gradient: the same operations, recomputed
REMAT_GRAD_TOL = 1e-6


def whisper_inputs(cfg, batch: int, frames: int, gen, dev):
    """``batch`` prompts (``SOT_PROMPT`` where the vocabulary holds it,
    else random tokens of its length) and random frame embeddings
    [batch, frames, d_model] in the model's dtype."""
    import torch
    from repro_torch.models.layers import torch_dtype
    x = torch.randn((batch, frames, cfg.d_model), generator=gen, device=dev)
    if max(SOT_PROMPT) < cfg.vocab:
        tokens = torch.tensor(SOT_PROMPT, dtype=torch.int32,
                              device=dev).expand(batch, -1).contiguous()
    else:
        tokens = torch.randint(0, cfg.vocab, (batch, len(SOT_PROMPT)),
                               generator=gen, device=dev, dtype=torch.int32)
    return tokens, x.to(torch_dtype(cfg.dtype))


def whisper_path(dev, seed: int, *, batch: int, frames: int, max_len: int,
                 decode_steps: int, smoke: bool = False,
                 check_launches: bool = True) -> dict:
    """(aa) whisper-small at full size (or its smoke config), random bf16
    weights from a seeded ``torch.Generator``: after a warm-up of the same
    shapes, ``encode`` of ``batch`` × ``frames`` frame embeddings, then
    ``prefill_step`` (the encoder again, the cross cache, the prompt
    through the decoder into a self cache of ``max_len`` positions),
    then ``decode_steps`` greedy ``decode_step``s, each ending in a
    synchronize, with the launch counts zeroed just before and read just
    after; the decode step against the read time of the decoder's
    weights (with the tied table), and of those and both caches. Checks
    shapes, finiteness, ids and cache positions;
    ``prefill(prompt[:-1])`` + ``decode(last)`` against
    ``prefill(prompt)`` within ``CONSISTENCY_TOL``. (aa2)
    ``launch/serve.py``'s ``serve`` over the model. Then, the model
    freed, the same gap in f32 on the smoke config (2 × 16 tokens
    against 16 frames, ``smoke_batch``) within ``CONSISTENCY_TOL_F32``."""
    import gc
    import torch
    from repro_torch import configs
    from repro_torch.models import encdec
    from repro_torch.models import model_zoo as zoo
    cfg = (configs.get_smoke_config(WHISPER) if smoke
           else configs.get_config(WHISPER))
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    if cuda:
        torch.cuda.init()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = zoo.init_params(cfg, gen, device=dev)
    tokens, x = whisper_inputs(cfg, batch, frames, gen, dev)
    P = tokens.shape[1]
    n_params = zoo.count_params(model)
    weight_gb = nbytes(model.parameters()) / 1e9
    dec_bytes = nbytes([model.embed, *model.dec_layers.parameters(),
                        *model.final_norm.parameters()])
    per_pos = (2 * cfg.n_layers * batch * cfg.n_kv_heads * cfg.d_head
               * x.element_size())
    cache_bytes = per_pos * (frames + max_len)
    bound_ms = dec_bytes / HBM_BYTES_PER_S * 1e3
    bound_all_ms = (dec_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"  {WHISPER}{' (smoke)' if smoke else ''}: {cfg.n_enc_layers} + "
        f"{cfg.n_layers} layers, {n_params:,} params ({weight_gb:.3f} GB); "
        f"a decode step reads the decoder's weights and the tied table "
        f"({dec_bytes / 1e9:.3f} GB: {bound_ms:.4f} ms at 3.35 TB/s), with "
        f"the cross cache over {frames} frames and the self cache of "
        f"{max_len} ({cache_bytes / 1e9:.3f} GB) {bound_all_ms:.4f} ms")
    inputs = {"tokens": tokens, "frames": x}
    # warm-up (library handles, the allocator's pools), not timed
    _, cache = zoo.prefill_step(model, cfg, inputs, pad_to=max_len)
    for _ in range(2):
        _, cache = zoo.decode_step(model, cfg, cache, tokens[:, :1])
    del cache
    name = f"{WHISPER} B={batch} frames={frames} prompt={P}"
    sync()
    zero_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        memory = encdec.encode(model, cfg, x)
    sync()
    encode_ms = (time.perf_counter() - t0) * 1e3
    del memory
    t0 = time.perf_counter()
    logits, cache = zoo.prefill_step(model, cfg, inputs, pad_to=max_len)
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    first = logits
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    step_ms, generated = [], [tok]
    for _ in range(decode_steps):
        t0 = time.perf_counter()
        logits, cache = zoo.decode_step(model, cfg, cache, tok)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        generated.append(tok)
    counts = read_counts()
    check_counts(name, counts, None, dev, check_launches)
    ids = torch.cat(generated, dim=1)
    if any(t.shape != (batch, cfg.vocab) or not bool(t.isfinite().all())
           for t in (first, logits)):
        fail(f"{name}: logits not finite of shape {(batch, cfg.vocab)}")
    if int(ids.min()) < 0 or int(ids.max()) >= cfg.vocab \
            or int(cache["pos"]) != P + decode_steps \
            or cache["k"].shape[2] != max_len \
            or cache["cross_k"].shape[2] != frames:
        fail(f"{name}: tokens or cache out of range")
    del cache, logits, first
    steady = sorted(step_ms[1:]) or step_ms
    run = dict(batch=batch, frames=frames, prompt=P, max_len=max_len,
               decode_steps=decode_steps, encode_ms=encode_ms,
               prefill_ms=prefill_ms, decode_ms_first=step_ms[0],
               decode_ms_mean=sum(step_ms[1:]) / max(len(step_ms) - 1, 1),
               decode_ms_median=steady[len(steady) // 2], launches=counts)
    log(f"  {name}: encode {encode_ms:.2f} ms; prefill (encode, cross "
        f"cache, prompt) {prefill_ms:.2f} ms; decode "
        f"{run['decode_ms_mean']:.2f} ms/step mean, "
        f"{run['decode_ms_median']:.2f} median (first {step_ms[0]:.2f}) "
        f"against {bound_ms:.4f} ms for the weights, {bound_all_ms:.4f} ms "
        f"with the caches")
    gap = prefill_decode_gap(model, cfg, tokens, frames=x)
    if not gap < CONSISTENCY_TOL:
        fail(f"{name}: prefill(prompt[:-1]) + decode(last) differs from "
             f"prefill(prompt) by {gap:.3e}")
    log(f"  {name}: prefill(prompt[:-1]) + decode(last) vs prefill(prompt): "
        f"{gap:.3e} relative")
    serving = serve_model(WHISPER, cfg, model, dev, seed,
                          ("porc_multisource_scan",), check_launches)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else 0.0
    log(f"  {WHISPER}: peak device memory {peak:.2f} GB against "
        f"{weight_gb:.3f} GB of weights")
    del model, x, tokens
    gc.collect()
    cfg32 = configs.get_smoke_config(WHISPER).replace(dtype="float32")
    small = smoke_batch(cfg32, seed, B=2, S=16)
    gap32 = prefill_decode_gap(zoo.init_params(cfg32, seed, device=dev),
                               cfg32, small["tokens"].to(dev),
                               frames=small["frames"].to(dev))
    if not gap32 < CONSISTENCY_TOL_F32:
        fail(f"{WHISPER} f32: prefill(prompt[:-1]) + decode(last) differs "
             f"from prefill(prompt) by {gap32:.3e}")
    log(f"  {WHISPER} smoke config in f32, 2 x 16 tokens against 16 "
        f"frames: prefill(prompt[:-1]) + decode(last) vs prefill(prompt): "
        f"{gap32:.3e} relative")
    if cuda:
        torch.cuda.empty_cache()
    return dict(arch=WHISPER, params=n_params, weight_gb=weight_gb,
                decoder_gb=dec_bytes / 1e9, cache_gb=cache_bytes / 1e9,
                decode_bound_ms=bound_ms, decode_bound_caches_ms=bound_all_ms,
                run=run, gap=gap, gap_f32=gap32, serving=serving,
                peak_gb=peak)


def family_train(dev, seed: int, arch: str, *, batch: int, seq: int,
                 frames: int | None = None, steps: int = 5,
                 remat: str | None = None, smoke: bool = False,
                 check_launches: bool = True) -> dict:
    """(ab)-(ae) ``arch`` at full size (or its smoke config), with its
    config's remat unless ``remat`` says: random bf16 weights from
    ``seed``, AdamW (``TRAIN_CELL_OPT`` over ``steps``), ``steps`` steps
    of ``make_train_step`` on one fixed batch: ``batch`` × ``seq``
    zipf(1.3) tokens and the VLM's patches or whisper's ``frames`` frames
    (normals), with the launch counts zeroed just before and read just
    after. The loss finite at every step and lower at the last than at
    the first; step ms, train tokens/s (every position the model runs:
    patches and frames too), the peak device memory against the
    training state (``train_reckoning``). The model is freed."""
    import gc
    import torch
    from repro_torch import configs, optim
    from repro_torch.core import streams
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.layers import torch_dtype
    cfg = configs.get_smoke_config(arch) if smoke else configs.get_config(arch)
    if remat is not None:
        cfg = cfg.replace(remat=remat)
    reck = train_reckoning(cfg)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    if cuda:
        torch.cuda.init()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    model = zoo.init_params(cfg, seed, device=dev)
    state = optim.init(model)
    step = make_train_step(cfg, optim.AdamWConfig(**TRAIN_CELL_OPT,
                                                  total_steps=steps))
    gen = torch.Generator(device=dev).manual_seed(seed)
    inputs = {"tokens": streams.sample_zipf_stream(
        seed, batch * seq, cfg.vocab, 1.3, device=dev).reshape(batch, seq)}
    prefix = 0
    if cfg.family == "vlm":
        prefix = cfg.n_patches
        inputs["patches"] = torch.randn(
            (batch, prefix, cfg.vision_dim), generator=gen,
            device=dev).to(torch_dtype(cfg.dtype))
    if cfg.family == "audio":
        prefix = frames
        inputs["frames"] = torch.randn(
            (batch, prefix, cfg.d_model), generator=gen,
            device=dev).to(torch_dtype(cfg.dtype))
    positions = batch * (prefix + seq)
    name = (f"train {arch} {cfg.n_layers}L B={batch} S="
            + (f"{prefix}+" if prefix else "") + f"{seq} remat {cfg.remat}")
    rows = []
    sync()
    zero_counts()
    for i in range(steps):
        t0 = time.perf_counter()
        model, state, m = step(model, state, inputs)
        sync()
        dt = time.perf_counter() - t0
        row = dict(step=i + 1, loss=float(m["loss"]), lr=float(m["lr"]),
                   grad_norm=float(m["grad_norm"]), ms=dt * 1e3,
                   tokens_per_s=positions / dt)
        rows.append(row)
        log(f"  {name} step {i + 1}: loss {row['loss']:.5f}, grad_norm "
            f"{row['grad_norm']:.4f}, lr {row['lr']:.2e}, {row['ms']:.1f} ms "
            f"= {row['tokens_per_s']:,.0f} tokens/s")
        if not (math.isfinite(row["loss"])
                and math.isfinite(row["grad_norm"])):
            fail(f"{name}: loss or grad_norm not finite at step {i + 1}")
    counts = read_counts()
    check_counts(name, counts, None, dev, check_launches)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else 0.0
    steady = rows[1:] or rows
    step_ms = sum(r["ms"] for r in steady) / len(steady)
    out = dict(run=name, arch=arch, remat=cfg.remat, batch=[batch, seq],
               prefix=prefix, steps=rows, step_ms_mean=step_ms,
               tokens_per_s=positions / step_ms * 1e3, peak_gb=peak,
               reckoning=reck, launches=counts)
    log(f"  {name}: loss {rows[0]['loss']:.5f} -> {rows[-1]['loss']:.5f}; "
        f"steps 2-{steps} {step_ms:.1f} ms = {out['tokens_per_s']:,.0f} "
        f"tokens/s; peak device memory {peak:.2f} GB against "
        f"{reck['state_gb']:.2f} GB of training state ({reck['params']:,} "
        f"parameters x {reck['bytes_per_param']} bytes)")
    del model, state, step, inputs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if not rows[-1]["loss"] < rows[0]["loss"]:
        fail(f"{name}: the loss did not fall ({rows[0]['loss']} -> "
             f"{rows[-1]['loss']})")
    return out


def check_remat_losses(runs: dict) -> dict:
    """The remat policies' losses step by step against the first run's:
    the first step within ``REMAT_LOSS_TOL[0]``, every step within
    ``REMAT_LOSS_TOL[1]`` (relative)."""
    base = next(iter(runs.values()))["steps"]
    errs = {}
    for remat, run in runs.items():
        d = [abs(r["loss"] - b["loss"]) / abs(b["loss"])
             for r, b in zip(run["steps"], base)]
        errs[remat] = max(d)
        if d[0] > REMAT_LOSS_TOL[0] or max(d) > REMAT_LOSS_TOL[1]:
            fail(f"remat {remat}: losses differ from the first run's by "
                 f"{d}")
    log("  remat policies on " + REMAT_ARCH + ": " + "; ".join(
        f"{r} {run['step_ms_mean']:.1f} ms a step, peak "
        f"{run['peak_gb']:.2f} GB, losses max rel diff {errs[r]:.2e}"
        for r, run in runs.items()))
    return errs


def whisper_driver(dev, *, batch: int = 8, seq: int = 448, steps: int = 6,
                   smoke: bool = False, check_launches: bool = True) -> dict:
    """``launch/train.py``'s ``Trainer`` on whisper-small at full size (or
    its smoke config): ``steps`` steps of ``batch`` × ``seq`` tokens from
    the pipeline with frames of the same length (as the reference's
    ``make_batch`` fills them), 4 hosts, one checkpoint (step 0) in a
    temporary directory (removed at the end); every step through
    ``driver_run``, the loss at the last step below the first. The peak
    lr is the driver's default, 3e-4, at full size, 1e-2 at the smoke
    config (as phase 10's)."""
    import gc
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.launch import train as driver
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        tr = driver.Trainer(WHISPER, steps, batch=batch, seq=seq, smoke=smoke,
                            ckpt_dir=root, ckpt_every=steps, n_hosts=4,
                            lr=1e-2 if smoke else 3e-4, device=dev)
        log(f"  {WHISPER}{' (smoke)' if smoke else ''}: the driver, batch "
            f"{batch} x {seq} tokens and {seq} frames, 4 hosts, {steps} "
            "steps")
        run = driver_run(f"driver {WHISPER}", tr, dev, check_launches)
        committed = sorted(ckpt.all_steps(root))
        del tr
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if committed != [0]:
        fail(f"driver {WHISPER}: committed {committed}, expected [0]")
    first, last = run["steps"][0]["loss"], run["steps"][-1]["loss"]
    if not last < first:
        fail(f"driver {WHISPER}: the loss did not fall ({first} -> {last})")
    return dict(run, committed=committed)


def remat_reference_check(dev, seed: int) -> dict:
    """On the card in f32, gemma3-1b's and whisper-small's smoke configs:
    the loss and every gradient under remat "dots" and "attn_out" against
    "none" within ``REMAT_GRAD_TOL`` (``grad_errors``)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model_zoo as zoo
    errs = {}
    for arch in (REMAT_ARCH, WHISPER):
        cfg = configs.get_smoke_config(arch).replace(dtype="float32")
        model = zoo.init_params(cfg, seed, device=dev).requires_grad_(True)
        batch = {k: v.to(dev) for k, v in smoke_batch(cfg, seed).items()}
        names, leaves = zip(*model.named_parameters())
        out = {}
        for remat in ("none", "dots", "attn_out"):
            loss = zoo.loss_fn(model, cfg.replace(remat=remat), batch)
            grads = torch.autograd.grad(loss, leaves)
            out[remat] = (float(loss.detach()), {n: g.detach().cpu()
                                        for n, g in zip(names, grads)})
        for remat in ("dots", "attn_out"):
            loss_err = abs(out[remat][0] - out["none"][0]) / abs(
                out["none"][0])
            grad_err = max(grad_errors(out["none"][1],
                                       out[remat][1]).values())
            errs[f"{arch} {remat}"] = max(loss_err, grad_err)
            if max(loss_err, grad_err) > REMAT_GRAD_TOL:
                fail(f"{arch} remat {remat} on the card: loss rel "
                     f"{loss_err}, worst gradient {grad_err} against none")
        del model
    log("  remat dots and attn_out against none on the card, smoke configs "
        "in f32, loss and every gradient: " + ", ".join(
            f"{k} {v:.2e}" for k, v in errs.items()))
    return errs


def whisper_reference_check(dev, seed: int) -> dict:
    """whisper-small's smoke config in f32 on the card against the CPU,
    the same weights: the logits of a prefill of 2 × 16 tokens against
    16 frames and of 4 greedy decode steps within 1e-4 relative, the
    greedy tokens equal."""
    import copy
    import torch
    from repro_torch import configs
    from repro_torch.models import model_zoo as zoo
    cfg = configs.get_smoke_config(WHISPER).replace(dtype="float32")
    host = zoo.init_params(cfg, seed, device=torch.device("cpu"))
    card = copy.deepcopy(host).to(dev)
    b = smoke_batch(cfg, seed, B=2, S=16)
    err = 0.0
    for a, c in zip(greedy_logits(host, cfg, b["tokens"], frames=b["frames"]),
                    greedy_logits(card, cfg, b["tokens"].to(dev),
                                  frames=b["frames"].to(dev))):
        err = max(err, relerr(a, c))
        if not relerr(a, c) <= 1e-4 or not torch.equal(a.argmax(-1),
                                                         c.argmax(-1)):
            fail(f"{WHISPER} reference: the card's logits differ from the "
                 f"CPU's (max rel {relerr(a, c)})")
    log(f"  {WHISPER} smoke config in f32, card vs CPU: logits max rel err "
        f"{err:.2e} over prefill + 4 decode steps; greedy tokens equal")
    return dict(logits_rel_err=err)


def encdec_train_phase(dev, seed: int, smoke: bool = False,
                       check_launches: bool = True) -> dict:
    """Phase 13: (aa) whisper served, (aa2) ``serve`` over it, the
    training cells (ab)-(ae), gemma3-1b under the four remat policies
    (its (ab) run among them), the driver's ``Trainer`` on whisper, then
    the smoke configs in f32 card against CPU (every family's train step,
    whisper's logits) and the policies against "none" on the card.
    ``smoke`` runs the smoke configs at tiny shapes, for a rehearsal on
    the CPU."""
    if smoke:
        wr = dict(batch=2, frames=24, max_len=24, decode_steps=3)
        cells = {a: dict(batch=2, seq=32, **({"frames": 24}
                                             if a == WHISPER else {}))
                 for a in TRAIN_CELLS}
        steps, drv = 3, dict(batch=2, seq=32, steps=3)
    else:
        wr, cells, steps, drv = WHISPER_RUN, TRAIN_CELLS, 5, {}
    out = {"whisper": whisper_path(dev, seed, **wr, smoke=smoke,
                                   check_launches=check_launches)}
    out["train"] = {arch: family_train(dev, seed, arch, **cells[arch],
                                       steps=steps, smoke=smoke,
                                       check_launches=check_launches)
                    for arch in TRAIN_CELLS}
    base = out["train"][REMAT_ARCH]
    remat = {base["remat"]: base}
    for policy in ("full", "none", "dots", "attn_out"):
        if policy not in remat:
            remat[policy] = family_train(
                dev, seed, REMAT_ARCH, **cells[REMAT_ARCH], steps=steps,
                remat=policy, smoke=smoke, check_launches=check_launches)
    out["remat"] = remat
    out["remat_loss_rel_err"] = check_remat_losses(remat)
    out["driver"] = whisper_driver(dev, **drv, smoke=smoke,
                                   check_launches=check_launches)
    out["reference"] = {arch: train_reference_check(dev, seed, arch)
                        for arch in TRAIN_CELLS}
    out["reference"][WHISPER].update(whisper_reference_check(dev, seed))
    out["remat_reference"] = remat_reference_check(dev, seed)
    return out


def sample(spec: dict, seed: int, n_messages: int, dev):
    from repro_torch.core import streams
    t0 = time.perf_counter()
    keys = streams.sample_trace(seed, streams.TraceSpec(**spec), n_messages,
                                device=dev)
    log(f"  sampled {n_messages} {spec['name']} messages over "
        f"{spec['n_keys']} keys in {time.perf_counter() - t0:.1f} s")
    return keys


def build_all(names) -> dict:
    """Build the kernels' sources at once, one ``nvcc`` each; print what
    ptxas says of registers, shared memory and spills."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build.build, names)))
    build_s = time.perf_counter() - t0
    for name, lib in libs.items():
        log(f"  built {lib.relative_to(ROOT)}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "Used" in line or "spill" in line:
                log("  ptxas:", line.strip())
    log(f"  {len(libs)} sources built in {build_s:.1f} s")
    return dict(build_s=build_s)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the full report as JSON here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    # 1. device
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False      # f32 stays f32
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log("== device")
    log(card)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    # 2. build
    log("== build")
    built = build_all(["porc_snapshot", "porc_assign", "cg_dispatch",
                       "ssd_scan"])

    # 3. kernels vs plain, on the card
    log("== kernels vs plain (bit for bit, WP and TW streams)")
    wp_keys = sample(WP_TABLE1, args.seed, WP_TABLE1["n_messages"], dev)
    tw_keys = sample(TW_TABLE1, args.seed + 1, TW_TABLE1["n_messages"], dev)
    streams2 = {"WP": wp_keys, "TW": tw_keys}
    err = {"porc_snapshot": check_snapshot(wp_keys, dev),
           "porc_multisource_scan": check_multisource(streams2, dev),
           "porc_multisource_scan[HHPolicy]": check_multisource_hh(streams2,
                                                                   dev),
           "porc_assign": max(check_assign(streams2, dev),
                              check_assign_fallback(wp_keys, dev)),
           "porc_multisource_strict": check_multisource_strict(streams2,
                                                               dev),

           "cg_dispatch": check_dispatch(dev)}
    edges = check_strict_edges(wp_keys, dev)
    for name in ("porc_assign", "porc_multisource_strict"):
        err[name] = max(err[name], edges)
    ssd_err = check_ssd(dev)
    err["ssd_scan"] = ssd_err["max_abs_err"]
    bwd_err = check_ssd_bwd(dev)
    err["ssd_scan_bwd"] = bwd_err["max_abs_err"]
    log_plans("phase 3 checks")
    from repro_torch.kernels.blocks import HHPolicy
    timing = {
        # (a)'s slot of 10,000 messages: 78 blocks of 128, then its
        # 16-key tail; and (a)'s block-1 slot, each after ten slots
        "porc_snapshot": time_snapshot(wp_keys, dev, 100, 9_984, 128,
                                       warm=100_000),
        "porc_snapshot[tail]": time_snapshot(wp_keys, dev, 100, 16, 16,
                                             warm=109_984),
        "porc_snapshot[block 1]": time_snapshot(
            wp_keys, dev, 100, 10_000, 1, warm=100_000, warm_block=1),
        "porc_multisource_scan": time_multisource(wp_keys, dev, n=480, S=8,
                                                  slot=5_000, block=128),
        "porc_multisource_scan[HHPolicy]": time_multisource_hh(
            tw_keys, dev, n=480, S=8, slot=5_000, block=128),
        "porc_multisource_scan[slot]": time_slot_spans(
            tw_keys, dev, n=480, S=8, slot=5_000, block=128),
        "porc_multisource_scan[HHPolicy, slot]": time_slot_spans(
            tw_keys, dev, n=480, S=8, slot=5_000, block=128,
            pol=HHPolicy(scheme="w")),
        "porc_multisource_scan[Fig 11]": time_ms(
            wp_keys, dev, n=1000, S=100, block=128, steps=10),
        "porc_assign": time_assign(wp_keys, dev, n=100, slot=10_000,
                                   block=128),
        "porc_multisource_strict": time_multisource_strict(
            wp_keys, dev, n=1000, S=100, steps=10, block=128),
        "cg_dispatch": time_dispatch(dev, G=8, T=1024),
        "cg_dispatch[decode]": time_dispatch(dev, G=1, T=8)}
    zamba2, mamba2 = ssd_model_shapes()
    timing["ssd_scan"] = time_ssd(dev, *zamba2)
    timing["ssd_scan[mamba2]"] = time_ssd(dev, *mamba2)
    # zamba2's long prefill, phase 7 (o): 8 × 4,096 tokens
    timing["ssd_scan[zamba2 8x4096]"] = time_ssd(
        dev, *zamba2[:2], 4096, *zamba2[3:])
    # the backward at phase 9's training shapes
    for name, shape in zip(BWD_ROWS, ssd_train_shapes()):
        timing[name] = time_ssd_bwd(dev, *shape)
    for name, t in timing.items():
        b, by = bound(t)
        extra = (f", {t['ranks_per_block']:.2f} ranks per block, "
                 f"{t['ns_per_rank']:.1f} ns per rank"
                 if "ranks_per_block" in t else
                 f", {t['bids']} bids, drop frac {t['drop_frac']:.4f}"
                 if "bids" in t else "")
        if "bound_f32_ms" in t:
            extra += f", bound at the f32 FMA rate {t['bound_f32_ms']:.6f} ms"
        if "probes" in t:
            extra += f", {t['probes']} probes"
        if "ctas_per_sm" in t:
            extra += (f", {t['ctas_per_sm']} CTAs an SM (planned "
                      f"{t['ctas_per_sm_planned']})")
        if "kernels_ms" in t:
            extra += ", of it " + ", ".join(
                f"{k} {v:.4f}" for k, v in t["kernels_ms"].items())
        log(f"  {name} at {t['shape']}: kernel {t['ms']:.4f} ms/launch "
            f"(CUDA events), {t['device_ms']:.4f} ms device time, plain "
            f"{t['plain_ms']:.3f} ms, bound {b:.6f} ms ({by}){extra}")
    for name in ("porc_multisource_scan[slot]",
                 "porc_multisource_scan[HHPolicy, slot]"):
        log(f"  {name} spans: " + ", ".join(
            f"{t['shape'].split(' block=')[1]} {t['ms']:.4f} ms "
            f"({t['device_ms']:.4f} device)"
            for t in timing[name]["spans"]))
    log_plans("phase 3 timing")
    log(f"  phases 2-3 took {time.perf_counter() - t_start:.1f} s")

    # 4. the main path
    log("== main path: cg.run(engine='auto')")
    runs, block1_vw = main_path(dev, args.seed, wp_keys, tw_keys=tw_keys)
    log("== heavy-hitter main path: cg.run(hh_scheme=..., engine='auto')")
    runs += hh_path(dev, wp_keys, tw_keys, runs)
    del tw_keys
    log("== strict engine: (f) cg.run(engine='strict')")
    runs += strict_path(dev, wp_keys, block1_vw)
    del block1_vw
    log("== strict engine: (g) the Fig 11 point, 100 sources × 1,000 VWs")
    fig11 = fig11_path(dev, wp_keys)
    log_plans("phase 4 main paths")
    log("== partitioner registry: (h) the Fig 7/8 table")
    schemes = schemes_path(dev, wp_keys)
    del wp_keys
    log(f"  phases 2-4 took {time.perf_counter() - t_start:.1f} s")

    # 5. serving with its failure path
    log("== serving: ServingEngine + CGRequestRouter(hh_scheme='w') under "
        "chaos")
    serving = serving_path(dev, args.seed)

    # 6. serving a CG-routed MoE model
    log(f"== MoE: {MOE_ARCH} at full width, 8 of 94 layers: prefill_step "
        "+ decode_step (router cg and topk), a 2 x 4,096 prefill past the "
        "attention threshold, then launch/serve.py's ServingEngine")
    moe = moe_path(dev, args.seed, long_prompt=(2, 4096))
    moe["reference"] = moe_reference_check(dev, args.seed)
    log(f"  peak device memory {moe['peak_gb']:.1f} GB")

    # 7. serving Mamba-2 and the zamba2 hybrid
    log("== Mamba-2: chunked vs dense attention at 4,096 tokens; (k) "
        "zamba2-2.7b and (l) mamba2-130m at full size: prefill_step + "
        "decode_step; (m) launch/serve.py's ServingEngine over (k); (o) "
        "(k)'s model on 8 x 4,096 prompts; (n) the smoke configs, card vs "
        "CPU")
    t7 = time.perf_counter()
    attn = check_chunked_attention(dev)
    ssm = [ssm_path(dev, args.seed, "zamba2-2.7b", serving=True,
                    long_seq=4096),
           ssm_path(dev, args.seed, "mamba2-130m")]
    ssm_ref = ssm_reference_check(dev, args.seed)
    log(f"  phase 7 took {time.perf_counter() - t7:.1f} s")

    # 8. training the CG-routed MoE
    log(f"== MoE training: (p) {MOE_ARCH} at full width, 1 of 94 layers, "
        "5 AdamW steps of 8 x 1,024 tokens (grad_accum 8, remat full), "
        "router cg and topk x uniform and capacity_skew=3.0 capacities; "
        "the smoke config's train step in f32, card vs CPU")
    t8 = time.perf_counter()
    train = train_path(dev, args.seed)
    train["reference"] = train_reference_check(dev, args.seed)
    log(f"  phase 8 took {time.perf_counter() - t8:.1f} s")

    # 9. training Mamba-2 and the zamba2 hybrid
    log("== SSM training: (q) mamba2-130m at full size, 5 AdamW steps of "
        "8 x 4,096 tokens; (r) zamba2-2.7b at full size, 5 steps of "
        "8 x 1,024, then one of 2 x 4,096 past the attention threshold "
        "(remat full, grad_accum 1); both smoke configs' train step in "
        "f32, card vs CPU")
    t9 = time.perf_counter()
    ssm_train = {
        "mamba2-130m": ssm_train_path(dev, args.seed, "mamba2-130m", 8,
                                      4096),
        "zamba2-2.7b": ssm_train_path(dev, args.seed, "zamba2-2.7b", 8,
                                      1024, long=(2, 4096))}
    for arch in ssm_train:
        ssm_train[arch]["reference"] = train_reference_check(dev, args.seed,
                                                             arch)
    log(f"  phase 9 took {time.perf_counter() - t9:.1f} s")

    # 10. the training feed and its failure path
    log("== training feed: (s) launch/train.py's driver on mamba2-130m at "
        "full size, 8 x 4,096 tokens, 4 hosts, host 3 lost at step 6, a "
        "checkpoint every 4 steps, then a resume; (t) (p)'s MoE on a "
        "zipf(1.1) token stream from the pipeline, router cg and topk; "
        "the smoke config's train steps on the stream in f32, card vs CPU")
    t10 = time.perf_counter()
    feed = {"driver": driver_path(dev)}
    q_ms = ssm_train["mamba2-130m"]["run"]["step_ms_mean"]
    log("  (s) steps that do not save: " + ", ".join(
        f"{k} {feed['driver'][k]['step_ms_mean']:.1f} ms"
        for k in ("a", "b")) + f" against phase 9's (q) {q_ms:.1f} ms; "
        f"peak device memory {feed['driver']['peak_gb']:.4f} GB against "
        f"(q)'s {ssm_train['mamba2-130m']['run']['peak_gb']:.4f} GB")
    feed["stream"] = stream_path(dev, args.seed, train["runs"][:2])
    log(f"  phase 10 took {time.perf_counter() - t10:.1f} s")

    # 11. the mesh tier
    log("== mesh tier: (u1) MeshCGRequestRouter on 1 rank over NCCL at phase "
        "5's deployment (policy-free) against the single-host router, then "
        "the demo stream; (u2) 8 ranks on this card over gloo: the demo "
        "stream (2^21 + 7 zipf(1.2) keys, 8,192 bins, block 2,048, 8 "
        "sources) at sync 1 and 3 against ref_porc_multisource, and a "
        "kill-one serving run")
    t11 = time.perf_counter()
    mesh = mesh_path(dev, args.seed)
    # a rank's launch at sync 1 on the mesh: one block of its lanes with
    # the in-launch merge off (sync steps + 1) and the global S
    timing["porc_multisource_scan[mesh]"] = time_ms(
        torch.from_numpy(mesh_demo_keys(args.seed, MESH_DEMO["M"])).to(dev),
        dev, n=MESH_DEMO["n_bins"], S=MESH_DEMO["n_sources"] // MESH_RANKS,
        block=MESH_DEMO["block"], steps=1, sync=2, eps=MESH_DEMO["eps"],
        chunk=MESH_DEMO["chunk"], global_sources=MESH_DEMO["n_sources"],
        compare=True)
    t = timing["porc_multisource_scan[mesh]"]
    b, by = bound(t)
    log(f"  porc_multisource_scan[mesh] at {t['shape']} (a rank's launch at "
        f"sync 1: merge off, global S {MESH_DEMO['n_sources']}): kernel "
        f"{t['ms']:.4f} ms/launch (CUDA events), {t['device_ms']:.4f} ms "
        f"device time, plain {t['plain_ms']:.3f} ms, bound {b:.6f} ms "
        f"({by}); equal to the plain engine's (max abs err "
        f"{t['max_abs_err']})")
    log(f"  phase 11 took {time.perf_counter() - t11:.1f} s")

    # 12. serving the dense decoder family and its VLM variant
    log("== dense family: (v) gemma3-1b at full size: prefill 8 x 1,024 + "
        "32 decode steps, a 2 x 4,096 prefill through chunked_attention, "
        "(v2) the ring-buffer decode at 131,072 positions against the "
        "uniform cache, (v3) launch/serve.py's serve(); (w) internlm2-20b, "
        "(x) starcoder2-3b on 2 x 8,192, (y) internvl2-2b, (z) "
        "command-r-plus-104b at full width, 8 of 64 layers; the five smoke "
        "configs in f32, card vs CPU")
    t12 = time.perf_counter()
    dense = dense_phase(dev, args.seed)
    log(f"  phase 12 took {time.perf_counter() - t12:.1f} s")

    # 13. whisper served and trained; the families trained
    log("== whisper and the families' training: (aa) whisper-small at full "
        "size: encode 8 x 1,500 frames, prefill the 4-token prompt, 64 "
        "decode steps in a cache of 448; (aa2) launch/serve.py's serve(); "
        "(ab) gemma3-1b, (ac) starcoder2-3b, (ad) internvl2-2b, (ae) "
        "whisper-small trained at full size, 5 AdamW steps each; gemma3-1b "
        "under remat none, dots and attn_out; the driver's Trainer on "
        "whisper-small; the smoke configs in f32, card vs CPU")
    t13 = time.perf_counter()
    encdec = encdec_train_phase(dev, args.seed)
    log(f"  phase 13 took {time.perf_counter() - t13:.1f} s")

    # 14. report
    launches = {k: sum(r["launches"][k] for r in runs + fig11)
                for k in ("porc_snapshot", "porc_multisource_scan",
                          "porc_multisource_scan_hh", "porc_assign",
                          "porc_multisource_strict")}
    launches["porc_multisource_scan_hh"] += serving["hh_launches"]
    # the router's launches serving gemma3-1b, phase 12 (v3)
    launches["porc_multisource_scan"] += \
        dense["gemma3-1b"]["serving"]["launches"]["porc_multisource_scan"]
    # and serving whisper-small, phase 13 (aa2)
    launches["porc_multisource_scan"] += \
        encdec["whisper"]["serving"]["launches"]["porc_multisource_scan"]
    launches["porc_assign"] += sum(r["porc_assign_launches"]
                                   for r in schemes)
    launches["cg_dispatch"] = sum(
        r["launches"]["cg_dispatch"]
        for r in moe["runs"] + [moe["long"], moe["serving"]] + train["runs"]
        + feed["stream"]["runs"])
    # per launch shape: (a)'s block-128 slots and their tails, its block-1
    # slots; zamba2 8 × 1,024 and 8 × 4,096, mamba2 8 × 4,096
    snap = {k: sum(r["launches"][k] for r in runs + fig11)
            for k in ("porc_snapshot_block1", "porc_snapshot_block128")}
    launches["porc_snapshot[block 1]"] = snap["porc_snapshot_block1"]
    launches["porc_snapshot[tail]"] = (launches["porc_snapshot"]
                                       - sum(snap.values()))
    launches["porc_snapshot"] = snap["porc_snapshot_block128"]
    zamba2_run, mamba2_run = ssm
    launches["ssd_scan"] = zamba2_run["run"]["launches"]["ssd_scan"]
    launches["ssd_scan[zamba2 8x4096]"] = \
        zamba2_run["long"]["launches"]["ssd_scan"]
    launches["ssd_scan[mamba2]"] = mamba2_run["run"]["launches"]["ssd_scan"]
    # phase 9's forwards and recomputes at the same shapes (its 2 × 4,096
    # step's have no row of their shape)
    q_run = ssm_train["mamba2-130m"]["run"]["launches"]
    r_run = ssm_train["zamba2-2.7b"]["run"]["launches"]
    r_long = ssm_train["zamba2-2.7b"]["long"]["launches"]
    launches["ssd_scan"] += r_run["ssd_scan"]
    launches["ssd_scan[mamba2]"] += q_run["ssd_scan"]
    for name, run in zip(BWD_ROWS, (r_run, r_long, q_run)):
        launches[name] = run["ssd_scan_bwd"]
    # phase 10's driver runs (s): mamba2 at 8 × 4,096
    for run in (feed["driver"]["a"], feed["driver"]["b"]):
        launches["ssd_scan[mamba2]"] += run["launches"]["ssd_scan"]
        launches["ssd_scan_bwd[mamba2]"] += run["launches"]["ssd_scan_bwd"]
    csrc = "src/repro_torch/kernels/csrc/"
    kernels = []
    for name, count, src, replaces in (
            ("porc_snapshot", launches["porc_snapshot"], "porc_snapshot.cu",
             "src/repro/kernels/porc_snapshot.py:78"),
            ("porc_snapshot[tail]", launches["porc_snapshot[tail]"],
             "porc_snapshot.cu", "src/repro/kernels/porc_snapshot.py:78"),
            ("porc_snapshot[block 1]", launches["porc_snapshot[block 1]"],
             "porc_snapshot.cu", "src/repro/kernels/porc_snapshot.py:78"),
            ("porc_multisource_scan", launches["porc_multisource_scan"],
             "porc_snapshot.cu", "src/repro/kernels/porc_snapshot.py:207"),
            ("porc_multisource_scan[HHPolicy]",
             launches["porc_multisource_scan_hh"], "porc_snapshot.cu",
             "src/repro/kernels/porc_snapshot.py:207"),
            ("porc_multisource_scan[mesh]", mesh["launches"],
             "porc_snapshot.cu", "src/repro/kernels/porc_snapshot.py:207"),
            ("porc_assign", launches["porc_assign"], "porc_assign.cu",
             "src/repro/kernels/porc_assign.py:99"),
            ("porc_multisource_strict", launches["porc_multisource_strict"],
             "porc_assign.cu", "src/repro/kernels/ref.py:420"),
            ("cg_dispatch", launches["cg_dispatch"], "cg_dispatch.cu",
             "src/repro/kernels/cg_dispatch.py:81"),
            ("ssd_scan", launches["ssd_scan"], "ssd_scan.cu",
             "src/repro/kernels/ssd_scan.py:66"),
            ("ssd_scan[zamba2 8x4096]", launches["ssd_scan[zamba2 8x4096]"],
             "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:66"),
            ("ssd_scan[mamba2]", launches["ssd_scan[mamba2]"], "ssd_scan.cu",
             "src/repro/kernels/ssd_scan.py:66"),
            *((name, launches[name], "ssd_scan.cu",
               "src/repro/models/mamba2.py:65") for name in BWD_ROWS)):
        t = timing[name]
        b, by = bound(t)
        kernels.append(dict(
            name=name, route="cuda", source=csrc + src, replaces=replaces,
            launches=count,
            max_abs_err=(max(mesh["max_abs_err"], t["max_abs_err"])
                         if name.endswith("[mesh]")
                         else err.get(name, err[name.split("[")[0]])),
            ms=t["ms"],
            device_ms=t["device_ms"], plain_ms=t["plain_ms"], bound_ms=b,
            bound_by=by, library_ms=None,
            **({"ctas_per_sm": t["ctas_per_sm"]} if "ctas_per_sm" in t
               else {})))
    log(f"  the whole run took {time.perf_counter() - t_start:.1f} s")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(
            card=card, **built, timing=timing, runs=runs, fig11=fig11,
            schemes=schemes, serving=serving, moe=moe, ssd=ssd_err,
            chunked_attention=attn, ssm=ssm, ssm_reference=ssm_ref,
            train=train, ssd_bwd=bwd_err, ssm_train=ssm_train, feed=feed,
            mesh=mesh, dense=dense, encdec=encdec, kernels=kernels),
            indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
