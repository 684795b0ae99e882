"""The port's ``chunked_attention`` against the JAX package's, and a whole
prefill past a lowered ``attn_chunk_threshold`` on the zamba2 and
phi3.5-moe smoke configs.

Inputs come from numpy with a seed and go through both packages.
Tolerances, on max|a − b| / max|ref|: in f32 1e-5 (the chunk products
and the exponentials round differently in XLA and torch on the CPU); in
bf16 2e-2, one bf16 rounding of the output (both compute in f32 inside
and cast at the end).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro_torch import configs, convert
from repro_torch.models import layers
from repro_torch.models import model_zoo as zoo

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def close(ours, theirs, rtol):
    theirs = np.asarray(jnp.asarray(theirs, jnp.float32))
    ours = ours.detach().float().numpy()
    assert ours.shape == theirs.shape
    scale = np.abs(theirs).max()
    assert np.abs(ours - theirs).max() <= rtol * scale, (
        np.abs(ours - theirs).max() / scale)


def qkv(B, Sq, Sk, H, KV, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, Dh)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, Dh)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, Dh)).astype(np.float32))


# (name, causal, Sq, Sk, H, KV, q_chunk, kv_chunk): the triangular schedule
# (causal, Sq == Sk) with 1, 2 and 4 q chunks and kv_chunk != q_chunk;
# the rectangular sweep non-causal and with Sq != Sk; GQA with KV < H
CASES = [
    ("tri_1chunk", True, 64, 64, 4, 4, 64, 64),
    ("tri_2chunks", True, 64, 64, 4, 4, 32, 32),
    ("tri_4chunks", True, 64, 64, 4, 4, 16, 16),
    ("tri_kv_wider", True, 64, 64, 4, 4, 16, 32),
    ("tri_kv_narrower", True, 64, 64, 4, 4, 32, 8),
    ("rect_noncausal", False, 64, 64, 4, 4, 16, 32),
    ("rect_noncausal_sq_ne_sk", False, 32, 96, 4, 4, 16, 32),
    ("rect_causal_sq_ne_sk", True, 32, 64, 4, 4, 16, 16),
    ("tri_gqa", True, 64, 64, 8, 2, 16, 32),
    ("rect_gqa_mqa", False, 32, 64, 4, 1, 32, 16),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_chunked_attention_matches_jax(case, dtype):
    _, causal, Sq, Sk, H, KV, qc, kc = case
    q, k, v = qkv(2, Sq, Sk, H, KV, 16)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jlayers.chunked_attention(
        *(jnp.asarray(x, jd) for x in (q, k, v)), causal=causal,
        q_chunk=qc, kv_chunk=kc)
    got = layers.chunked_attention(
        *(torch.from_numpy(x).to(td) for x in (q, k, v)), causal=causal,
        q_chunk=qc, kv_chunk=kc)
    assert got.dtype == td
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("case", CASES[:3] + CASES[-2:],
                         ids=[c[0] for c in CASES[:3] + CASES[-2:]])
def test_chunked_equals_dense_in_f32(case):
    """The online softmax over chunks is the port's dense attention, in
    f32, up to the order of its sums (Sq == Sk cases: the dense path has
    no query offset)."""
    _, causal, Sq, Sk, H, KV, qc, kc = case
    q, k, v = (torch.from_numpy(x) for x in qkv(1, Sq, Sk, H, KV, 16, 3))
    got = layers.chunked_attention(q, k, v, causal=causal, q_chunk=qc,
                                   kv_chunk=kc)
    want = layers.dense_attention(q, k, v, causal=causal)
    close(got, want.numpy(), TOL["float32"])


@pytest.mark.parametrize("causal,Sq,Sk,qc,kc", [
    (True, 48, 48, 32, 16),      # triangular: Sq % q_chunk
    (True, 48, 48, 16, 32),      # triangular: Sq % kv_chunk
    (False, 48, 64, 32, 32),     # rectangular: Sq % q_chunk
    (False, 32, 80, 32, 32),     # rectangular: Sk % kv_chunk
])
def test_chunks_that_do_not_divide_raise(causal, Sq, Sk, qc, kc):
    q, k, v = (torch.from_numpy(x) for x in qkv(1, Sq, Sk, 2, 2, 8))
    with pytest.raises(ValueError, match="not a multiple"):
        layers.chunked_attention(q, k, v, causal=causal, q_chunk=qc,
                                 kv_chunk=kc)


@pytest.mark.parametrize("needs_grad", [False, True])
def test_kv_steps_checkpoint_only_when_a_gradient_is_needed(monkeypatch,
                                                            needs_grad):
    """With grad mode on, each kv step runs under a checkpoint only when
    q, k or v needs a gradient; the output is the same either way."""
    calls = []

    def counting(fn, *args, **kw):
        calls.append(fn)
        return torch.utils.checkpoint.checkpoint(fn, *args, **kw)

    monkeypatch.setattr(layers, "checkpoint", counting)
    q, k, v = (torch.from_numpy(x).requires_grad_(needs_grad)
               for x in qkv(1, 32, 32, 2, 2, 8, 5))
    got = layers.chunked_attention(q, k, v, causal=False, q_chunk=16,
                                   kv_chunk=16)
    assert len(calls) == (4 if needs_grad else 0)
    with torch.no_grad():
        want = layers.chunked_attention(q, k, v, causal=False, q_chunk=16,
                                        kv_chunk=16)
    assert torch.equal(got.detach(), want)


# the smoke configs with the threshold lowered below the prompt, so every
# attention call of the prefill takes chunked_attention (2 q chunks of 16
# against kv chunks of 8 in the triangular schedule)
LOWERED = dict(dtype="float32", attn_chunk_threshold=16, q_chunk=16,
               kv_chunk=8)
CONVERT = {"moe": convert.moe_params_from_jax,
           "hybrid": convert.hybrid_params_from_jax}


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "phi3.5-moe-42b-a6.6b"])
def test_prefill_past_the_threshold_matches_jax(arch):
    """``prefill_step`` on [2, 32] tokens, above the lowered threshold,
    then two greedy ``decode_step``s from its cache: logits within 1e-5,
    the same greedy tokens, and every attention call of the prefill went
    through ``chunked_attention``."""
    B, S = 2, 32
    jcfg = jconfigs.get_smoke_config(arch).replace(**LOWERED)
    cfg = configs.get_smoke_config(arch).replace(**LOWERED)
    jp = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
    tp = CONVERT[cfg.family](jax.tree.map(np.asarray, jp), cfg, "cpu")
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    before = layers.chunked_attention.calls
    jl, jc = jax.jit(lambda p, t: jzoo.prefill_step(
        p, jcfg, {"tokens": t}, pad_to=S + 2))(jp, tok)
    tl, tc = zoo.prefill_step(tp, cfg, {"tokens": torch.from_numpy(tok)},
                              pad_to=S + 2)
    n_attn = (cfg.n_layers // cfg.shared_attn_every
              if cfg.family == "hybrid" else cfg.n_layers)
    assert layers.chunked_attention.calls - before == n_attn
    close(tl, jl, TOL["float32"])
    jdec = jax.jit(lambda p, c, t: jzoo.decode_step(p, jcfg, c, t))
    for _ in range(2):
        jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl, -1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jc = jdec(jp, jc, jt)
        tl, tc = zoo.decode_step(tp, cfg, tc, tt)
        close(tl, jl, TOL["float32"])


def test_chip_smoke_long_prompt_runs_rehearse_on_cpu():
    """``chip_smoke.py``'s long-prompt runs at the smoke size with the
    threshold lowered: (o)'s ``long_run`` on the hybrid and phase 6's
    ``moe_run`` with no decode step each check that every attention call
    of the prefill went through ``chunked_attention``."""
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    dev = torch.device("cpu")
    low = dict(attn_chunk_threshold=32, q_chunk=32, kv_chunk=16)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, 64)).astype(np.int32))
    cfg = configs.get_smoke_config("zamba2-2.7b").replace(**low)
    out = chip_smoke.long_run(zoo.init_params(cfg, 0, device="cpu"), cfg,
                              tokens, dev, check_launches=False)
    assert out["launches"]["chunked_attention"] == 2
    assert out["seq"] == 64 and out["decode_ms_mean"] > 0
    cfg = chip_smoke.moe_config(None, smoke=True).replace(**low)
    out = chip_smoke.moe_run(zoo.init_params(cfg, 0, device="cpu"), cfg,
                             tokens[:1], 0, dev, check_launches=False)
    assert out["launches"]["chunked_attention"] == cfg.n_layers
    assert 0.0 <= out["drop_frac"] <= 1.0 and "decode_ms_mean" not in out
