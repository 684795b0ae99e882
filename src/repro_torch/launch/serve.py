"""Serving driver: decode with the CG request router (port of
``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      [--arch gemma3-1b] --requests 64 --decode-steps 8 \\
      [--replicas 4] [--hetero] [--device cuda]

Runs the arch's smoke config, as the reference does, any arch of the
registry. Replicas share one model and one decode function; each batch
decodes from ``zoo.init_cache``, so whisper-small's cross cache is
zeros there, as in the reference (no frames reach a replica). ``serve``
runs inside the reference's smoke mesh (``steps.smoke_mesh``): one
rank, where every activation rule is the identity and the tensors stay
plain.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import model_zoo as zoo
from repro_torch.serve import CGRequestRouter, ServingEngine

from .steps import smoke_mesh


def build_replica(cfg, params, decode_steps: int, slow: float = 0.0,
                  max_batch: int = 8, decode=None):
    """A replica fn: batch of token prompts → generated ids [B, steps].

    Batches are padded to ``max_batch`` so every decode step has one
    shape (continuous-batching style); greedy decoding, first index on
    ties. All replicas share one ``decode`` (pass it in) — they serve
    the same model. The generated ids stay on the device until the last
    step."""
    if decode is None:
        def decode(p, c, t):
            return zoo.decode_step(p, cfg, c, t)
    dev = params.embed.device

    def run(payloads):
        B = len(payloads)
        prompts = np.zeros((max_batch, 1), np.int32)
        prompts[:B] = np.asarray(payloads, np.int32).reshape(B, 1)
        cache = zoo.init_cache(cfg, max_batch, 64, device=dev)
        tok = torch.from_numpy(prompts).to(dev)
        out = []
        for _ in range(decode_steps):
            logits, cache = decode(params, cache, tok)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            out.append(tok)
        ids = torch.cat(out, dim=1).cpu().numpy()
        if slow:
            time.sleep(slow)                                # heterogeneity
        return ids[:B]

    return run


def serve(cfg, params, *, requests: int = 64, decode_steps: int = 8,
          replicas: int = 4, hetero: bool = False, device="cuda",
          seed: int = 0) -> dict:
    """Serve ``requests`` skewed-session requests (zipf 1.3 keys, one
    random prompt token each) on ``replicas`` replicas of one model
    behind a ``CGRequestRouter`` until every one is served; with
    ``hetero`` replica 0 sleeps 0.05 s per batch (Fig 15 setup).
    Returns the engine, the outputs by request and the timings."""
    def shared_decode(p, c, t):
        return zoo.decode_step(p, cfg, c, t)

    fns = []
    outputs: dict[int, np.ndarray] = {}
    for r in range(replicas):
        slow = 0.05 if (hetero and r == 0) else 0.0
        run = build_replica(cfg, params, decode_steps, slow,
                            decode=shared_decode)

        def fn(payloads, run=run):
            ids = run([p for _, p in payloads])
            for (i, _), row in zip(payloads, ids):
                outputs[i] = row
            return ids

        fns.append(fn)
    engine = ServingEngine(fns, CGRequestRouter(replicas, device=device))

    rng = np.random.default_rng(seed)
    zipf_keys = rng.zipf(1.3, size=requests) % 1000         # skewed sessions
    prompts = rng.integers(0, cfg.vocab, size=(requests, 1))
    with smoke_mesh(params.embed.device):
        t0 = time.time()
        engine.submit_batch(zipf_keys.astype(np.int32),
                            [(i, int(p[0])) for i, p in enumerate(prompts)])
        served = 0
        while served < requests:
            served += engine.step()
        dt = time.time() - t0
    lat = np.asarray(engine.latencies)
    return dict(engine=engine, served=served, seconds=dt,
                requests_per_s=served / dt, latency_mean_s=float(lat.mean()),
                latency_p99_s=float(np.percentile(lat, 99)),
                prompts=prompts[:, 0], outputs=outputs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b",
                    choices=configs.ARCH_IDS)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--hetero", action="store_true",
                    help="make one replica 5x slower (Fig 15 setup)")
    ap.add_argument("--device", default="cuda",
                    help="where the model and the router live")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke_config(args.arch)
    params = zoo.init_params(cfg, 0, device=args.device)
    out = serve(cfg, params, requests=args.requests,
                decode_steps=args.decode_steps, replicas=args.replicas,
                hetero=args.hetero, device=args.device)
    engine = out["engine"]
    print(f"served {out['served']} requests in {out['seconds']:.2f}s "
          f"({out['requests_per_s']:.1f} req/s); latency mean "
          f"{out['latency_mean_s']*1e3:.1f}ms p99 "
          f"{out['latency_p99_s']*1e3:.1f}ms; "
          f"router moves {engine.router.moves}; "
          f"per-replica served {[r.served for r in engine.replicas]}")
    return out


if __name__ == "__main__":
    main()
