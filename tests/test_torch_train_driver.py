"""The port's training driver (``repro_torch.launch.train``) against a
loop built from the reference's parts: ``jax.jit`` of
``repro.launch.steps.make_train_step`` without a mesh, the reference's
``ShardedTokenPipeline``, ``FaultTolerantRunner`` and
``DelegationBalancer``, wired as ``repro.launch.train.train`` wires them
(that function itself installs a smoke mesh, under which the reference's
step fails on this JAX). Both start from the same weights (the port's
``zoo.init_params`` returns the JAX weights through ``convert``) and
read one token table (``_shard_batch`` patched in both pipelines), in
f32 as every train-step parity test here (bf16 differs at 1e-2).

Equal exactly: the committed checkpoint steps, the resumed start step
and ``shard_owner`` at the end (after a host failure too); the restored
state equals the saved one bit for bit. The lr of every step is equal
within 1e-7·lr_peak: past the warm-up, XLA's CPU cosine differs from
torch's by an ulp (≤ 6e-8) for ~5% of arguments, which
``lr_min + 0.5·(lr_peak − lr_min)·(1 + cos)`` scales to ≤ 3e-8·lr_peak,
and XLA fuses that sum into one multiply-add (an ulp of the lr more);
the warm-up steps are equal exactly.
The losses agree within ``LOSS_TOL`` relative: the driver keeps AdamW's
default eps 1e-8, so an element whose gradient is as small as the two
frameworks' rounding difference moves by up to lr apart
(``tests/test_torch_train.py::test_train_step_matches_jax`` explains the
amplification), and the weights, hence the losses, drift apart over the
steps by more than one step's rounding. Measured: ≤ 1.8e-7 relative (two
f32 ulps of the loss) over mamba2-130m's 10 steps and phi3.5-moe's 6;
1e-5 leaves room for that drift and is still ~100× below what a batch,
a step or an lr out of place would move (consecutive losses here differ
by ~1e-3 relative).
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.checkpoint import checkpointer as jckpt
from repro.data import pipeline as jpipeline
from repro.launch import steps as jsteps
from repro.models import model_zoo as jzoo
from repro.runtime import DelegationBalancer as JBalancer
from repro.runtime import FaultTolerantRunner as JRunner
from repro.runtime import FTConfig as JFTConfig
from repro_torch import configs, convert
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.data import pipeline
from repro_torch.launch import train as driver

LOSS_TOL = 1e-5
CONVERT = {"ssm": convert.mamba2_params_from_jax,
           "moe": convert.moe_params_from_jax,
           "dense": convert.dense_params_from_jax,
           "audio": convert.encdec_params_from_jax}


def f32_smoke(pkg, arch):
    return pkg.get_smoke_config(arch).replace(dtype="float32")


def setup_both(monkeypatch, arch, n_shards, steps, seq, vocab=256):
    """Patch the driver to the f32 smoke config and the JAX weights, both
    pipelines to one token table; the JAX weights."""
    jcfg = f32_smoke(jconfigs, arch)
    jp = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, jp)
    get = configs.get_smoke_config
    monkeypatch.setattr(driver.configs, "get_smoke_config",
                        lambda a: get(a).replace(dtype="float32"))
    monkeypatch.setattr(driver.zoo, "init_params",
                        lambda cfg, key, device: CONVERT[cfg.family](
                            host, cfg, device))
    table = np.random.default_rng(5).integers(
        0, vocab, (n_shards, steps, 1, seq)).astype(np.int32)
    monkeypatch.setattr(pipeline.ShardedTokenPipeline, "_shard_batch",
                        lambda self, s, t, n: torch.from_numpy(table[s, t,
                                                                     :n]))
    monkeypatch.setattr(jpipeline.ShardedTokenPipeline, "_shard_batch",
                        lambda self, s, t, n: jnp.asarray(table[s, t, :n]))
    return jcfg, jp


def reference_train(jcfg, params, n_steps, batch, seq, ckpt_dir,
                    resume=False, ckpt_every=10, n_hosts=4, lr=3e-4,
                    fail_host_at=None, features=None):
    """``repro.launch.train.train``'s loop without its mesh: (rows of
    (step, loss, lr), start step, pipeline). ``features(step)``: the
    batch's other inputs (whisper's frames), where the reference's
    ``make_batch`` draws them with ``jax.random``."""
    opt_cfg = joptim.AdamWConfig(lr_peak=lr,
                                 warmup_steps=max(2, n_steps // 10),
                                 total_steps=n_steps)
    pipe = jpipeline.ShardedTokenPipeline(jpipeline.PipelineConfig(
        vocab=jcfg.vocab, seq_len=seq, global_batch=batch, n_hosts=n_hosts))
    runner = JRunner(JFTConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every),
                     n_hosts=n_hosts, pipeline=pipe)
    balancer = JBalancer(n_hosts)
    opt_state = joptim.init(params)
    start = 0
    if resume:
        start, restored = runner.restore_latest({"params": params,
                                                 "opt": opt_state})
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
    step_fn = jax.jit(jsteps.make_train_step(jcfg, opt_cfg))
    rows = []
    for step in range(start, n_steps):
        if fail_host_at is not None and step == fail_host_at:
            runner.on_failure(n_hosts - 1)
        t0 = time.time()
        inputs = {"tokens": pipe.global_batch(step)[:batch]}
        if features is not None:
            inputs.update(features(step))
        params, opt_state, m = step_fn(params, opt_state, inputs)
        loss = float(m["loss"])
        dt = time.time() - t0
        for h in range(n_hosts):
            if runner.hosts[h].alive:
                balancer.observe(h, dt * (1.0 + 0.05 * h))
                runner.heartbeat(h)
        balancer.rebalance(pipe)
        runner.maybe_save(step, {"params": params, "opt": opt_state})
        rows.append((step, loss, float(m["lr"])))
    runner.saver.wait()
    return rows, start, pipe


def check_against(tr, rows, start, jpipe, lr_peak=3e-4):
    assert tr.start_step == start
    assert [r["step"] for r in tr.history] == [r[0] for r in rows]
    for r, (step, loss, lr) in zip(tr.history, rows):
        assert abs(r["lr"] - lr) <= 1e-7 * lr_peak, step
        assert np.isfinite(r["loss"])
        assert abs(r["loss"] - loss) <= LOSS_TOL * abs(loss), step
    np.testing.assert_array_equal(tr.pipe.shard_owner, jpipe.shard_owner)


def state_of(tr) -> list:
    leaves, _ = ckpt._flatten(tr.tree())
    return [x.detach().clone() for x in leaves]


def test_driver_matches_reference_and_resumes_bit_for_bit(monkeypatch,
                                                          tmp_path):
    """mamba2-130m's smoke config: 6 steps of 4 × 32 tokens on 2 hosts
    with a checkpoint every 2 steps, then a resume to 8 steps, in the port
    and in the reference loop."""
    n_hosts, batch, seq = 2, 4, 32
    jcfg, jp = setup_both(monkeypatch, "mamba2-130m", 8 * n_hosts, 8, seq)
    tdir, jdir = str(tmp_path / "torch"), str(tmp_path / "jax")
    kw = dict(batch=batch, seq=seq, n_hosts=n_hosts)
    a = driver.Trainer("mamba2-130m", 6, ckpt_dir=tdir, ckpt_every=2,
                       device="cpu", **kw)
    losses = a.run()
    rows, start, jpipe = reference_train(jcfg, jp, 6, ckpt_dir=jdir,
                                         ckpt_every=2, **kw)
    assert len(losses) == 6 and np.isfinite(losses).all()
    check_against(a, rows, start, jpipe)
    assert sorted(ckpt.all_steps(tdir)) == sorted(
        jckpt.all_steps(jdir)) == [0, 2, 4]
    assert [r["saved"] for r in a.history] == [True, False] * 3

    b = driver.Trainer("mamba2-130m", 8, ckpt_dir=tdir, resume=True,
                       device="cpu", **kw)
    saved = ckpt.restore(tdir, 4, b.tree())
    restored = state_of(b)
    for x, y in zip(restored, ckpt._flatten(saved)[0]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # resume repeats the checkpointed step: batch 4 trains again
    assert b.start_step == 4 and b.restore_s is not None
    losses2 = b.run()
    rows2, start2, jpipe2 = reference_train(jcfg, jp, 8, ckpt_dir=jdir,
                                            resume=True, **kw)
    assert len(losses2) == 4
    check_against(b, rows2, start2, jpipe2)
    assert sorted(ckpt.all_steps(tdir)) == sorted(
        jckpt.all_steps(jdir)) == [0, 2, 4]


def test_driver_restores_what_it_saved_at_the_last_step(monkeypatch,
                                                        tmp_path):
    """A checkpoint at the run's last step holds the run's final state:
    a resume restores it bit for bit, the step count included."""
    setup_both(monkeypatch, "mamba2-130m", 16, 4, 32)
    kw = dict(batch=4, seq=32, n_hosts=2, ckpt_dir=str(tmp_path),
              device="cpu")
    a = driver.Trainer("mamba2-130m", 4, ckpt_every=3, **kw)
    a.run()
    final = state_of(a)
    b = driver.Trainer("mamba2-130m", 4, resume=True, **kw)
    assert b.start_step == 3 and int(b.opt_state["step"]) == 4
    for x, y in zip(final, state_of(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_a_checkpoint_holds_the_state_of_its_step(monkeypatch, tmp_path):
    """With a writer slower than a step, the next step's in-place update
    runs while the save is still being written: every committed step
    still holds the state as it was right after that step."""
    setup_both(monkeypatch, "mamba2-130m", 16, 4, 32)
    savez = np.savez

    def slow(*args, **kwargs):
        time.sleep(0.5)
        savez(*args, **kwargs)

    monkeypatch.setattr(np, "savez", slow)
    d = str(tmp_path)
    tr = driver.Trainer("mamba2-130m", 4, batch=4, seq=32, n_hosts=2,
                        ckpt_dir=d, ckpt_every=2, device="cpu")
    at = {}
    tr.run(on_step=lambda row: at.update({row["step"]: state_of(tr)})
           if row["saved"] else None)
    assert sorted(at) == sorted(ckpt.all_steps(d)) == [0, 2]
    for step, want in at.items():
        got = ckpt._flatten(ckpt.restore(d, step, tr.tree()))[0]
        assert all(torch.equal(x, y) for x, y in zip(want, got)), step


def test_driver_survives_host_failure_like_the_reference(monkeypatch,
                                                         tmp_path):
    """phi3.5-moe's smoke config on 3 hosts, host 2 lost before step 3:
    its shards re-paired as the reference re-pairs them, every shard on a
    live host, the losses as the reference's."""
    n_hosts, batch, seq = 3, 4, 32
    jcfg, jp = setup_both(monkeypatch, "phi3.5-moe-42b-a6.6b", 8 * n_hosts,
                          6, seq)
    kw = dict(batch=batch, seq=seq, n_hosts=n_hosts, fail_host_at=3)
    tr = driver.Trainer("phi3.5-moe-42b-a6.6b", 6,
                        ckpt_dir=str(tmp_path / "torch"), device="cpu", **kw)
    losses = tr.run()
    rows, start, jpipe = reference_train(
        jcfg, jp, 6, ckpt_dir=str(tmp_path / "jax"), **kw)
    assert len(losses) == 6 and np.isfinite(losses).all()
    check_against(tr, rows, start, jpipe)
    assert len(tr.evacuated) == 8 and not tr.runner.hosts[2].alive
    counts = np.bincount(tr.pipe.shard_owner, minlength=3)
    assert counts[2] == 0 and counts.sum() == 24


def test_driver_refuses_families_not_ported(monkeypatch, tmp_path):
    """No family is refused any more: the driver trains gemma3-1b's and
    whisper-small's smoke configs (4 steps of 4 × 32 tokens on 2 hosts;
    whisper's frames [4, 32, 64] a step) with the losses and lrs of the
    reference's loop. Both read one table of tokens (``_shard_batch``)
    and one of frames (the port's ``_normals``, the loop's
    ``features``), bf16 values as the reference's ``make_batch`` draws
    them."""
    n_hosts, batch, seq, steps = 2, 4, 32, 4
    kw = dict(batch=batch, seq=seq, n_hosts=n_hosts)
    for arch in ("gemma3-1b", "whisper-small"):
        jcfg, jp = setup_both(monkeypatch, arch, 8 * n_hosts, steps, seq)
        frames = torch.randn((steps, batch, seq, jcfg.d_model),
                             generator=torch.Generator().manual_seed(6)).to(
            torch.bfloat16).float().numpy()
        monkeypatch.setattr(driver, "_normals",
                            lambda step, shape, device: torch.from_numpy(
                                frames[step]).to(device, torch.bfloat16))
        tr = driver.Trainer(arch, steps, ckpt_dir=str(tmp_path / arch),
                            device="cpu", **kw)
        assert ("frames" in tr.make_batch(0)) == (arch == "whisper-small")
        losses = tr.run()
        features = None
        if jcfg.family == "audio":
            def features(step):
                return {"frames": jnp.asarray(frames[step], jnp.bfloat16)}
        rows, start, jpipe = reference_train(
            jcfg, jp, steps, ckpt_dir=str(tmp_path / f"jax-{arch}"),
            features=features, **kw)
        assert len(losses) == steps and np.isfinite(losses).all()
        check_against(tr, rows, start, jpipe)
