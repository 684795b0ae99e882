"""The training feed and its failure path against the JAX package: the
sharded token pipeline (``data/pipeline.py``), the straggler balancer
(``runtime/straggler.py``) and the failure runner and re-mesh plan
(``runtime/fault_tolerance.py``). The same inputs go to both packages
and everything must be equal exactly: shard ownership, batches built
from one token table, the balancer's moves, signals, queues and flaps,
the evacuation moves, the checkpoint round trip and ``plan_remesh``.

The reference samples tokens with ``jax.random.choice``, which torch
cannot reproduce, so batches are compared with ``_shard_batch`` reading
one NumPy table in both packages; the port's own sampler is held to its
contract (a pure function of (seed, shard, step), in range, zipf
frequencies) on its own.
"""
import os
import tempfile

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro.data import pipeline as jpipeline
from repro.runtime import fault_tolerance as jft
from repro.runtime import straggler as jstraggler
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.core import streams
from repro_torch.data import pipeline
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime import straggler

CPU = "cpu"


def pipes(**kw):
    return (pipeline.ShardedTokenPipeline(pipeline.PipelineConfig(**kw)),
            jpipeline.ShardedTokenPipeline(jpipeline.PipelineConfig(**kw)))


def same_owner(p, jp):
    np.testing.assert_array_equal(p.shard_owner, jp.shard_owner)


# ------------------------------------------------------------ the pipeline

def test_pipeline_config_defaults_match_reference():
    a = pipeline.PipelineConfig(vocab=10, seq_len=4, global_batch=8)
    b = jpipeline.PipelineConfig(vocab=10, seq_len=4, global_batch=8)
    assert vars(a) == vars(b)


def test_shard_ownership_matches_reference_over_seeded_moves():
    """``move_shard``'s return value, ``shard_owner`` and every host's
    ``shards_of`` after each of 200 seeded moves (hosts that own nothing
    included)."""
    p, jp = pipes(vocab=64, seq_len=8, global_batch=24, n_hosts=4,
                  n_shards_per_host=3)
    rng = np.random.default_rng(7)
    for _ in range(200):
        a, b = (int(x) for x in rng.integers(0, 4, 2))
        assert p.move_shard(a, b) == jp.move_shard(a, b)
        same_owner(p, jp)
        for h in range(4):
            np.testing.assert_array_equal(p.shards_of(h), jp.shards_of(h))


@pytest.mark.parametrize("global_batch", [6, 16])
def test_batches_match_reference_on_one_token_table(monkeypatch,
                                                    global_batch):
    """``host_batch`` and ``global_batch`` with ``_shard_batch`` reading
    one table indexed by (shard, step) in both packages: one row a shard
    (global batch 6 < 8 shards, cut to 6) and two (16); after moves that
    leave host 1 with no shard (an empty [0, seq_len] batch)."""
    V, S, steps, n_shards = 50, 8, 3, 8
    table = np.random.default_rng(1).integers(
        0, V, (n_shards, steps, 2, S)).astype(np.int32)
    monkeypatch.setattr(pipeline.ShardedTokenPipeline, "_shard_batch",
                        lambda self, s, t, n: torch.from_numpy(table[s, t,
                                                                     :n]))
    monkeypatch.setattr(jpipeline.ShardedTokenPipeline, "_shard_batch",
                        lambda self, s, t, n: jnp.asarray(table[s, t, :n]))
    p, jp = pipes(vocab=V, seq_len=S, global_batch=global_batch,
                  n_hosts=2, n_shards_per_host=4)
    for pp in (p, jp):
        for _ in range(4):
            pp.move_shard(1, 0)
        pp.move_shard(0, 1)
        pp.move_shard(1, 0)
    same_owner(p, jp)
    for step in range(steps):
        for h in range(2):
            got, want = p.host_batch(h, step), jp.host_batch(h, step)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = p.global_batch(step)
        assert got.shape[0] == min(global_batch, n_shards * max(
            1, global_batch // n_shards))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jp.global_batch(step)))
    assert p.host_batch(1, 0).shape == (0, S)


def test_port_sampler_is_pure_in_range_and_zipf():
    """The port's ``_shard_batch``: equal for equal (seed, shard, step)
    whatever was drawn before, different when any of the three differs,
    int32 in [0, vocab), and over 409,600 tokens every token's frequency
    within 5 standard deviations (√(p(1 − p)/N)) plus 1/N of
    ``zipf_probs``."""
    kw = dict(vocab=64, seq_len=256, global_batch=32, n_hosts=2,
              n_shards_per_host=4)
    a = pipeline.ShardedTokenPipeline(pipeline.PipelineConfig(**kw))
    b = pipeline.ShardedTokenPipeline(pipeline.PipelineConfig(**kw))
    c = pipeline.ShardedTokenPipeline(pipeline.PipelineConfig(seed=1, **kw))
    first = a._shard_batch(3, 5, 4)
    b.global_batch(0)
    assert torch.equal(b._shard_batch(3, 5, 4), first)
    assert torch.equal(a._shard_batch(3, 5, 4), first)
    for other in (a._shard_batch(2, 5, 4), a._shard_batch(3, 6, 4),
                  c._shard_batch(3, 5, 4)):
        assert not torch.equal(other, first)
    toks = torch.cat([a.global_batch(t) for t in range(50)]).numpy()
    assert toks.dtype == np.int32 and toks.shape == (50 * 32, 256)
    assert toks.min() >= 0 and toks.max() < 64
    n = toks.size
    freq = np.bincount(toks.ravel(), minlength=64) / n
    p = streams.zipf_probs(64, 1.1)
    assert np.all(np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1 / n)


# -------------------------------------------------------------- the balancer

BALANCER_MODES = {
    "static": dict(window=2),
    "static_budget1": dict(window=3, max_moves_per_slot=1),
    "hysteresis": dict(window=1, hysteresis=True, dwell=2),
    "adaptive": dict(window=1, adaptive_moves=True, max_moves_per_slot=4),
    "adaptive_hysteresis": dict(window=1, adaptive_moves=True,
                                hysteresis=True, dwell=1,
                                max_moves_per_slot=4),
}


def test_straggler_config_defaults_match_reference():
    assert vars(straggler.StragglerConfig()) == vars(
        jstraggler.StragglerConfig())


@pytest.mark.parametrize("mode", list(BALANCER_MODES))
def test_balancer_matches_reference_on_seeded_traces(mode):
    """Six hosts over 40 slots of seeded step times (a drifting
    straggler, a fast host, one host silent for the first 5 slots, noise
    on every sample; 1–3 samples a host a slot) and a real pipeline each:
    after every slot the moves, the signals, the FCFS queues, the flap
    count, the controller's budget and the shard owners are equal."""
    kw = BALANCER_MODES[mode]
    bal = straggler.DelegationBalancer(6, straggler.StragglerConfig(**kw),
                                       device=CPU)
    jbal = jstraggler.DelegationBalancer(6, jstraggler.StragglerConfig(**kw))
    p, jp = pipes(vocab=16, seq_len=4, global_batch=8, n_hosts=6,
                  n_shards_per_host=2)
    rng = np.random.default_rng(11)
    for t in range(40):
        base = np.array([1.0, 1.0, 1.0, 0.6, 1.0, 1.0])
        base[(t // 8) % 3] = 1.3 + 0.5 * np.sin(t / 3.0)   # the straggler
        for h in range(6):
            if h == 5 and t < 5:
                continue
            for _ in range(int(rng.integers(1, 4))):
                s = float(base[h] * np.exp(rng.normal(0.0, 0.05)))
                bal.observe(h, s)
                jbal.observe(h, s)
        assert bal.signals() == jbal.signals()
        assert bal.rebalance(p) == jbal.rebalance(jp), t
        for name in ("busy_since", "idle_since", "slot"):
            np.testing.assert_array_equal(
                getattr(bal._queues, name).numpy(),
                np.asarray(getattr(jbal._queues, name)), err_msg=name)
        assert bal.flap_count == jbal.flap_count
        if jbal._controller is not None:
            assert bal._controller.last_budget == jbal._controller.last_budget
        same_owner(p, jp)
    assert bal.moves == jbal.moves and len(bal.moves) > 0


def test_balancer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        straggler.DelegationBalancer(4)


# ------------------------------------------------------------ the runner

def runners(tmp_path, n_hosts=3, per_host=8, capacities=None):
    p, jp = pipes(vocab=64, seq_len=8, global_batch=24, n_hosts=n_hosts,
                  n_shards_per_host=per_host)
    r = ft.FaultTolerantRunner(ft.FTConfig(ckpt_dir=str(tmp_path / "t")),
                               n_hosts, pipeline=p, capacities=capacities,
                               device=CPU)
    jr = jft.FaultTolerantRunner(jft.FTConfig(ckpt_dir=str(tmp_path / "j")),
                                 n_hosts, pipeline=jp, capacities=capacities)
    return r, jr


def test_ft_config_defaults_match_reference_but_the_directory():
    a, b = vars(ft.FTConfig()), vars(jft.FTConfig())
    assert a.pop("ckpt_dir") == os.path.join(tempfile.gettempdir(),
                                             "repro_torch_ckpt")
    assert b.pop("ckpt_dir") != ft.FTConfig().ckpt_dir
    assert a == b
    assert vars(ft.HostState()) == vars(jft.HostState())


@pytest.mark.parametrize("n_hosts,per_host,capacities,dead", [
    (3, 8, None, 1),                       # uniform
    (4, 4, None, 1),                       # uniform, 5/5/6
    (4, 8, None, 3),                       # the driver's failure
    (3, 8, [1.0, 1.0, 3.0], 0),            # a 3x survivor
    (5, 6, [2.0, 0.5, 1.0, 4.0, 1.5], 3),  # skewed
])
def test_on_failure_moves_match_reference(tmp_path, n_hosts, per_host,
                                          capacities, dead):
    r, jr = runners(tmp_path, n_hosts, per_host, capacities)
    moved = r.on_failure(dead)
    assert moved == jr.on_failure(dead)
    assert len(moved) == per_host
    same_owner(r.pipeline, jr.pipeline)
    assert len(r.pipeline.shards_of(dead)) == 0


def test_cascading_failures_match_reference(tmp_path):
    r, jr = runners(tmp_path)
    for host in (0, 2, 1):
        assert r.on_failure(host) == jr.on_failure(host)
        same_owner(r.pipeline, jr.pipeline)
    assert np.bincount(r.pipeline.shard_owner, minlength=3).tolist() == [
        0, 24, 0]
    assert [h for _, h in r.failures] == [h for _, h in jr.failures]


def test_on_failure_is_idempotent_like_the_reference(tmp_path):
    r, jr = runners(tmp_path)
    assert r.on_failure(0) == jr.on_failure(0)
    assert r.on_failure(0) == jr.on_failure(0) == []
    for runner in (r, jr):
        runner.heartbeat(1)
        runner.heartbeat(2)
    assert r.check_failures(timeout_s=1.0) == jr.check_failures(
        timeout_s=1.0) == []
    assert len(r.failures) == len(jr.failures) == 1
    same_owner(r.pipeline, jr.pipeline)


def test_check_failures_timeout_zero_matches_reference(tmp_path):
    """With timeout 0 every live host is declared dead, in index order,
    each through ``on_failure``: the last survivor keeps every shard."""
    r, jr = runners(tmp_path, n_hosts=4, per_host=3)
    assert r.check_failures(timeout_s=0.0) == jr.check_failures(
        timeout_s=0.0) == [0, 1, 2, 3]
    same_owner(r.pipeline, jr.pipeline)
    assert all(not h.alive for h in r.hosts)


def test_restore_latest_round_trip(tmp_path):
    """``maybe_save`` at ``ckpt_every`` only; ``restore_latest`` gives the
    step and the tree back bit for bit (bf16 through its f32 widening,
    an int32 step), on the like's dtypes; the committed files restore in
    the reference as well (the layout is shared)."""
    r, jr = runners(tmp_path)
    g = torch.Generator().manual_seed(0)
    tree = {"params": {"w": torch.randn(5, 3, generator=g).bfloat16(),
                       "b": torch.randn(3, generator=g)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
    assert r.maybe_save(50, tree) and not r.maybe_save(51, tree)
    r.saver.wait()
    like = {"params": {"w": torch.zeros(5, 3, dtype=torch.bfloat16),
                       "b": torch.zeros(3)},
            "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    step, got = r.restore_latest(like)
    assert step == 50
    for (k, x), y in zip(sorted(tree["params"].items()),
                         (got["params"][k] for k in sorted(tree["params"]))):
        assert y.dtype == x.dtype and torch.equal(x, y), k
    assert torch.equal(got["opt"]["step"], tree["opt"]["step"])
    assert r.restore_latest(like)[0] == ckpt.latest_step(r.cfg.ckpt_dir)
    jr.cfg.ckpt_dir = r.cfg.ckpt_dir
    js, jgot = jr.restore_latest(
        {"params": {"w": np.zeros((5, 3), np.float32),
                    "b": np.zeros(3, np.float32)},
         "opt": {"step": np.zeros((), np.int32)}})
    assert js == 50 == jckpt.latest_step(r.cfg.ckpt_dir)
    np.testing.assert_array_equal(jgot["params"]["w"],
                                  tree["params"]["w"].float().numpy())
    assert int(jgot["opt"]["step"]) == 7
    empty = ft.FaultTolerantRunner(ft.FTConfig(ckpt_dir=str(tmp_path / "e")),
                                   1, device=CPU)
    assert empty.restore_latest(like) == (0, None)


@pytest.mark.parametrize("chips,mp,want", [
    (64, 16, (4, 16)), (63, 16, (3, 16)), (16, 16, (1, 16)),
    (8, 16, (1, 16)), (96, 16, (6, 16)),
    (256, None, (16, 16)), (240, None, (15, 16)), (8, None, (1, 16))])
def test_plan_remesh_matches_reference(chips, mp, want):
    args = (chips,) if mp is None else (chips, mp)
    assert ft.plan_remesh(*args) == jft.plan_remesh(*args) == want
