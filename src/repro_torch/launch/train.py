"""End-to-end training driver (port of ``repro.launch.train``).

Wires together: CG-sharded data pipeline → train step → AdamW → async
checkpointing → straggler delegation → elastic failure response.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --steps 20 --batch 8 --seq 128 [--full] [--resume] [--device cuda]

Without ``--full`` it runs the arch's smoke config, as the reference
does. Every family trains. ``run`` trains inside the reference's smoke
mesh (``steps.smoke_mesh``: ``make_smoke_mesh``, the activation rules,
``enter_mesh``): one rank, where every rule is the identity, so the
step runs eagerly on the device with plain tensors.

A step's batch is the pipeline's tokens and, as the reference's
``make_batch`` fills it, whisper's ``frames`` [B, seq, d_model] or the
VLM's ``patches`` [B, n_patches, vision_dim], standard normals in bf16.
The reference draws those with ``jax.random.fold_in(key, step)``, which
torch cannot reproduce; here they come from a generator seeded by
(0, step) (``_normals``): still a pure function of the step, other
numbers.

As in the reference, a resumed run restores step s, whose checkpoint
was written after step s's update, and then trains from step s: batch
s is trained a second time.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, optim
from repro_torch.data import PipelineConfig, ShardedTokenPipeline
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import model_zoo as zoo
from repro_torch.runtime import DelegationBalancer, FTConfig, FaultTolerantRunner

from . import steps


def _normals(step: int, shape, device) -> torch.Tensor:
    """Standard normals of ``shape`` in bf16 on ``device``, from a
    ``torch.Generator`` there seeded by (0, step): the reference's
    ``fold_in(PRNGKey(0), step)`` in torch's terms."""
    seed = int(np.random.SeedSequence((0, step)).generate_state(1)[0])
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device).to(
        torch.bfloat16)


class Trainer:
    """The state of one ``train`` run: the model (its weights module),
    the optimizer state, the pipeline, the failure runner and the
    straggler balancer, all built (and, with ``resume``, restored) by the
    constructor. ``run`` trains ``start_step``…``n_steps - 1``;
    ``history`` holds a row per step (loss, lr, grad_norm, the step's ms
    and, inside it, the ms ``make_batch`` took to draw the batch onto the
    device, whether it saved and the seconds the save held the loop)."""

    def __init__(self, arch: str, n_steps: int = 20, batch: int = 8,
                 seq: int = 128, smoke: bool = True,
                 ckpt_dir: str = FTConfig.ckpt_dir,
                 resume: bool = False, ckpt_every: int = 10,
                 n_hosts: int = 4, lr: float = 3e-4, log_every: int = 1,
                 fail_host_at: int | None = None, device="cuda"):
        self.device = resolve_device(device)
        cfg = (configs.get_smoke_config(arch) if smoke
               else configs.get_config(arch))
        self.cfg, self.n_steps, self.batch = cfg, n_steps, batch
        self.n_hosts, self.log_every = n_hosts, log_every
        self.fail_host_at = fail_host_at
        self.opt_cfg = optim.AdamWConfig(
            lr_peak=lr, warmup_steps=max(2, n_steps // 10),
            total_steps=n_steps)

        self.pipe = ShardedTokenPipeline(PipelineConfig(
            vocab=cfg.vocab, seq_len=seq, global_batch=batch,
            n_hosts=n_hosts))
        self.runner = FaultTolerantRunner(
            FTConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every),
            n_hosts=n_hosts, pipeline=self.pipe, device=self.device)
        self.balancer = DelegationBalancer(n_hosts, device=self.device)

        self.model = zoo.init_params(cfg, 0, self.device)
        self.opt_state = optim.init(self.model)
        self.start_step, self.restore_s = 0, None
        if resume:
            t0 = time.perf_counter()
            self.start_step, restored = self.runner.restore_latest(
                self.tree())
            if restored is not None:
                self._load(restored)
                self.restore_s = time.perf_counter() - t0
                print(f"resumed from step {self.start_step}")
        self.train_step = steps.make_train_step(cfg, self.opt_cfg)
        self.history: list[dict] = []
        self.evacuated: list[tuple[int, int]] = []

    def tree(self) -> dict:
        """What a checkpoint holds: the weights by name and the optimizer
        state (the checkpointer flattens dicts, not modules)."""
        return {"params": dict(self.model.named_parameters()),
                "opt": self.opt_state}

    @torch.no_grad()
    def _load(self, restored: dict) -> None:
        """Copy a restored tree into the weights and the optimizer state,
        in place."""
        for name, p in self.model.named_parameters():
            p.copy_(restored["params"][name])
        opt = restored["opt"]
        for part in ("m", "v", "master"):
            for name, x in self.opt_state[part].items():
                x.copy_(opt[part][name])
        self.opt_state["step"].copy_(opt["step"])

    def make_batch(self, step: int) -> dict:
        """Step ``step``'s batch on the device: the pipeline's tokens
        [batch, seq] and, for whisper, ``frames`` [batch, seq, d_model],
        for the VLM ``patches`` [batch, n_patches, vision_dim]
        (``_normals``)."""
        cfg = self.cfg
        tokens = self.pipe.global_batch(step)[: self.batch]
        batch = {"tokens": tokens.to(self.device)}
        if cfg.family == "audio":
            batch["frames"] = _normals(
                step, (self.batch, tokens.shape[1], cfg.d_model), self.device)
        if cfg.family == "vlm":
            batch["patches"] = _normals(
                step, (self.batch, cfg.n_patches, cfg.vision_dim),
                self.device)
        return batch

    def step(self, step: int) -> dict:
        """One train step: the simulated host loss at ``fail_host_at``,
        the step on this step's batch, every live host's step time to
        the balancer (host h reports ``dt·(1 + 0.05·h)``, as in the
        reference) and its heartbeat, a rebalance, the checkpoint."""
        if self.fail_host_at is not None and step == self.fail_host_at:
            self.evacuated = self.runner.on_failure(self.n_hosts - 1)
            print(f"[ft] host {self.n_hosts - 1} failed; re-paired shards: "
                  f"{self.evacuated}")
        t0 = time.perf_counter()
        batch = self.make_batch(step)
        feed = time.perf_counter() - t0
        self.model, self.opt_state, metrics = self.train_step(
            self.model, self.opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        for h in range(self.n_hosts):
            if self.runner.hosts[h].alive:
                self.balancer.observe(h, dt * (1.0 + 0.05 * h))
                self.runner.heartbeat(h)
        self.balancer.rebalance(self.pipe)
        t1 = time.perf_counter()
        saved = self.runner.maybe_save(step, self.tree())
        row = dict(step=step, loss=loss, lr=float(metrics["lr"]),
                   grad_norm=float(metrics["grad_norm"]), ms=dt * 1e3,
                   feed_ms=feed * 1e3, saved=saved,
                   save_s=time.perf_counter() - t1 if saved else 0.0)
        self.history.append(row)
        if step % self.log_every == 0:
            print(f"step {step:4d} loss {loss:.4f} "
                  f"gnorm {row['grad_norm']:.3f} "
                  f"lr {row['lr']:.2e} {row['ms']:.0f}ms", flush=True)
        return row

    def run(self, on_step=None) -> np.ndarray:
        """Train the remaining steps (``on_step(row)`` after each), wait
        for the last checkpoint to commit; the losses."""
        with steps.smoke_mesh(self.device):
            for step in range(self.start_step, self.n_steps):
                row = self.step(step)
                if on_step is not None:
                    on_step(row)
        self.runner.saver.wait()
        return np.asarray([r["loss"] for r in self.history])


def train(arch: str, n_steps: int = 20, batch: int = 8, seq: int = 128,
          smoke: bool = True, ckpt_dir: str = FTConfig.ckpt_dir,
          resume: bool = False, ckpt_every: int = 10,
          n_hosts: int = 4, lr: float = 3e-4, log_every: int = 1,
          fail_host_at: int | None = None, device="cuda") -> np.ndarray:
    """Train ``arch`` for ``n_steps`` (from the last checkpoint with
    ``resume``); the loss of every step run."""
    return Trainer(arch, n_steps, batch, seq, smoke, ckpt_dir, resume,
                   ckpt_every, n_hosts, lr, log_every, fail_host_at,
                   device).run()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="full config instead of smoke")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-dir", default=FTConfig.ckpt_dir)
    ap.add_argument("--fail-host-at", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the model and the optimizer state live")
    args = ap.parse_args(argv)
    losses = train(args.arch, n_steps=args.steps, batch=args.batch,
                   seq=args.seq, smoke=not args.full, resume=args.resume,
                   ckpt_dir=args.ckpt_dir, fail_host_at=args.fail_host_at,
                   device=args.device)
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
