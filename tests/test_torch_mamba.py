"""The port's Mamba-2 and zamba2-hybrid serving path against the JAX
package, on the smoke configs of both archs: ``mamba_block``,
``mamba_step``, ``hidden_states``, ``prefill_step`` and ``decode_step``
from converted parameters, the zoo's surface and the serving driver;
then a rehearsal of ``chip_smoke.py``'s Mamba-2 phase.

Parameters come from the reference's init (``*_params_from_jax``),
inputs from numpy. Tolerances: in f32 the outputs agree within 1e-5
relative to their largest magnitude (matmuls, exp and the chunked sums
round differently in XLA and torch on the CPU; measured ~1e-6) and the
greedy tokens are equal; in bf16 the frameworks round products at other
places, so the bf16 checks ask for 5e-2.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import hybrid as jhybrid
from repro.models import mamba2 as jmamba2
from repro.models import model_zoo as jzoo
from repro_torch import configs, convert
from repro_torch.launch import serve
from repro_torch.models import hybrid, mamba2
from repro_torch.models import model_zoo as zoo

ARCHS = ("mamba2-130m", "zamba2-2.7b")
CONVERT = {"ssm": convert.mamba2_params_from_jax,
           "hybrid": convert.hybrid_params_from_jax}
B, S = 2, 64


def close(ours, theirs, rtol=1e-5):
    theirs = np.asarray(theirs, np.float32)
    ours = ours.detach().float().numpy()
    scale = np.abs(theirs).max()
    assert ours.shape == theirs.shape
    assert np.abs(ours - theirs).max() <= rtol * scale, (
        np.abs(ours - theirs).max() / scale)


_PARAMS = {}


def params(arch, dtype="float32"):
    """The reference's init and its conversion into the port, once."""
    if (arch, dtype) not in _PARAMS:
        jcfg = jconfigs.get_smoke_config(arch).replace(dtype=dtype)
        cfg = configs.get_smoke_config(arch).replace(dtype=dtype)
        jp = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
        tp = CONVERT[cfg.family](jax.tree.map(np.asarray, jp), cfg, "cpu")
        _PARAMS[arch, dtype] = (jp, tp, jcfg, cfg)
    return _PARAMS[arch, dtype]


def first_layer(arch, jp, tp):
    """Layer 0 of the model in both packages (the hybrid's stacks are
    [n_groups, per_group, ...])."""
    if arch == "zamba2-2.7b":
        return jax.tree.map(lambda a: a[0, 0], jp["layers"]), tp.layers[0][0]
    return jax.tree.map(lambda a: a[0], jp["layers"]), tp.layers[0]


def tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq", [40, 64])
def test_mamba_block_matches_jax(arch, seq):
    """The block without and with its final state (conv tail, SSM state);
    a length of 40 takes chunk 10 (``pick_chunk``), 64 chunk 16."""
    jp, tp, jcfg, cfg = params(arch)
    jlp, lp = first_layer(arch, jp, tp)
    x = np.random.default_rng(seq).standard_normal(
        (B, seq, cfg.d_model)).astype(np.float32)
    close(mamba2.mamba_block(torch.from_numpy(x), lp, cfg),
          jmamba2.mamba_block(x, jlp, jcfg))
    out, (conv, h) = mamba2.mamba_block(torch.from_numpy(x), lp, cfg,
                                        return_state=True)
    jout, (jconv, jh) = jmamba2.mamba_block(x, jlp, jcfg, return_state=True)
    close(out, jout)
    close(conv, jconv)
    close(h, jh)


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_step_matches_jax(arch):
    """One token of the recurrence from a random conv window and state."""
    jp, tp, jcfg, cfg = params(arch)
    jlp, lp = first_layer(arch, jp, tp)
    s, d_in, H, d_xbc = mamba2._dims(cfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((B, s.d_conv - 1, d_xbc)).astype(np.float32)
    h = rng.standard_normal((B, H, s.head_dim, s.d_state)).astype(np.float32)
    ours = mamba2.mamba_step(torch.from_numpy(x), lp, cfg,
                             torch.from_numpy(conv), torch.from_numpy(h))
    theirs = jmamba2.mamba_step(x, jlp, jcfg, conv, h)
    for a, b in zip(ours, theirs):
        close(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_hidden_states_match_jax(arch):
    jp, tp, jcfg, cfg = params(arch)
    x = np.random.default_rng(4).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    if arch == "zamba2-2.7b":
        pos = np.broadcast_to(np.arange(S), (B, S))
        close(hybrid.hidden_states(tp, cfg, torch.from_numpy(x),
                                   torch.from_numpy(pos.copy())),
              jhybrid.hidden_states(jp, jcfg, x, pos))
    else:
        close(mamba2.hidden_states(tp, cfg, torch.from_numpy(x)),
              jmamba2.hidden_states(jp, jcfg, x))


def _prefill_decode(arch, dtype, steps=4):
    """Prefill with headroom, then ``steps`` greedy decode steps, in both
    packages, each feeding its own greedy tokens; the port's cache after
    each step is copied (its decode writes the K/V in place)."""
    jp, tp, jcfg, cfg = params(arch, dtype)
    tok = tokens(cfg.vocab, (B, S), seed=5)
    jl, jc = jax.jit(lambda p, t: jzoo.prefill_step(
        p, jcfg, {"tokens": t}, pad_to=S + steps))(jp, tok)
    tl, tc = zoo.prefill_step(tp, cfg, {"tokens": torch.from_numpy(tok)},
                              pad_to=S + steps)
    logits = [(jl, tl)]
    caches = [(jc, {n: c.clone() for n, c in tc.items()})]
    step = jax.jit(lambda p, c, t: jzoo.decode_step(p, jcfg, c, t))
    for _ in range(steps):
        jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl, -1)[:, None].to(torch.int32)
        jl, jc = step(jp, jc, jt)
        tl, tc = zoo.decode_step(tp, cfg, tc, tt)
        logits.append((jl, tl))
        caches.append((jc, {n: c.clone() for n, c in tc.items()}))
    return logits, caches


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_jax(arch):
    """f32: the last logits of the prefill and of 4 decode steps, every
    cache entry, and the greedy tokens."""
    logits, caches = _prefill_decode(arch, "float32")
    for jl, tl in logits:
        assert tl.dtype == torch.float32
        close(tl, jl)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(jl).argmax(-1))
    for jc, tc in caches:
        assert set(tc) == set(jc)
        for name in jc:
            close(tc[name], jc[name])
    assert int(caches[-1][1]["pos"]) == S + 4


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_in_bf16(arch):
    """The smoke config in its own dtype, bf16: loose tolerance (see the
    module docstring); the caches keep the reference's dtypes."""
    logits, caches = _prefill_decode(arch, "bfloat16", steps=2)
    for jl, tl in logits:
        close(tl, jl, rtol=5e-2)
    jc, tc = caches[-1]
    assert tc["conv"].dtype == torch.bfloat16
    assert tc["h"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_consistency(arch):
    """prefill(prompt) ≡ prefill(prompt[:-1]) + decode(prompt[-1]), in
    the config's own bf16 (``tests/test_models_smoke.py``'s property and
    bound); the shorter prompt takes another chunk (63 → 9)."""
    cfg = configs.get_smoke_config(arch)
    model = zoo.init_params(cfg, 0, device="cpu")
    tok = torch.from_numpy(tokens(cfg.vocab, (B, S), seed=6))
    full, _ = zoo.prefill_step(model, cfg, {"tokens": tok})
    _, cache = zoo.prefill_step(model, cfg, {"tokens": tok[:, :-1]},
                                pad_to=S)
    inc, cache = zoo.decode_step(model, cfg, cache, tok[:, -1:])
    assert int(cache["pos"]) == S
    rel = float((full - inc).abs().max() / full.abs().max())
    assert rel < 5e-2, rel


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_surface(arch):
    """Parameter counts, the converted leaves, the cache's shapes and
    dtypes equal the reference's; random init is deterministic per seed
    and has the reference's shapes."""
    jp, tp, jcfg, cfg = params(arch, "bfloat16")
    assert zoo.count_params(tp) == jzoo.count_params(jp)
    assert zoo.active_params(cfg, 7) == 7 and zoo.metric_zeros(cfg) == {}
    spec, jspec = zoo.cache_spec(cfg, 4, 32), jzoo.cache_spec(jcfg, 4, 32)
    assert set(spec) == set(jspec)
    for name in jspec:
        assert tuple(spec[name].shape) == tuple(jspec[name].shape), name
        assert str(spec[name].dtype).split(".")[1] == str(jspec[name].dtype)
        assert spec[name].device.type == "meta"
    cache = zoo.init_cache(cfg, 4, 32, device="cpu")
    assert all(float(v.abs().max()) == 0 for v in cache.values())
    a = zoo.init_params(cfg, 5, device="cpu")
    b = zoo.init_params(cfg, 5, device="cpu")
    for (n, x), y in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(x, y), n
    jshapes = {jax.tree_util.keystr(k): v.shape for k, v in
               jax.tree_util.tree_flatten_with_path(jp)[0]}
    stack = 2 if arch == "zamba2-2.7b" else 1
    for n, x in a.named_parameters():
        parts = n.split(".")
        if parts[0] == "layers":
            parts = parts[:1] + parts[1 + stack:]
        key = "".join(f"['{p}']" for p in parts)
        assert tuple(jshapes[key][stack if parts[0] == "layers" else 0:]) \
            == tuple(x.shape), n
        assert x.dtype == tp.get_parameter(n).dtype, n
    tok = torch.zeros((1, 16), dtype=torch.int32)
    logits, _ = zoo.prefill_step(a, cfg, {"tokens": tok})
    assert logits.shape == (1, cfg.vocab) and bool(logits.isfinite().all())


def test_unported_archs_say_so():
    """The encoder-decoder family (whisper) still raises, naming the
    ROADMAP item that ports it; the dense and VLM families are ported
    (``tests/test_torch_dense.py``)."""
    for arch in ("whisper-small",):
        with pytest.raises(NotImplementedError, match="item 10"):
            configs.get_config(arch)
        with pytest.raises(NotImplementedError, match="item 10"):
            zoo.init_params(jconfigs.get_smoke_config(arch), 0, device="cpu")
    assert set(ARCHS) <= set(configs.ARCH_IDS)


# --------------------------------------------------------------- serving

@pytest.mark.parametrize("arch", ARCHS)
def test_serving_replica_generates_jax_tokens(arch):
    """The port's ``build_replica`` and the reference's give the same
    greedy tokens from the same (converted) f32 parameters."""
    jp, tp, jcfg, cfg = params(arch)
    prompts = [5, 17, 200, 3, 99]
    ours = serve.build_replica(cfg, tp, decode_steps=4)(prompts)
    want = jserve.build_replica(jcfg, jp, decode_steps=4)(prompts)
    np.testing.assert_array_equal(ours, want)
    assert ours.shape == (5, 4)


def test_serve_driver_serves_zamba2_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch zamba2-2.7b --device
    cpu`` at the smoke size with a slow replica: every request is served
    once and gets its decode_steps tokens."""
    out = serve.main(["--arch", "zamba2-2.7b", "--device", "cpu",
                      "--hetero", "--requests", "16", "--decode-steps", "3"])
    assert "served 16 requests" in capsys.readouterr().out
    eng = out["engine"]
    assert out["served"] == eng.submitted == 16 and eng.in_flight == 0
    assert sorted(out["outputs"]) == list(range(16))
    vocab = configs.get_smoke_config("zamba2-2.7b").vocab
    for ids in out["outputs"].values():
        assert ids.shape == (3,) and 0 <= ids.min() and ids.max() < vocab


def test_chip_smoke_ssm_phase_rehearses_on_cpu():
    """``chip_smoke.py``'s phase 7 at the smoke size with the plain scan:
    (k) and (l) prefill, decode and the prefill/decode consistency, (m)
    serving all 64 requests, (n) the card-vs-CPU check (here CPU against
    CPU); and phase 3's SSD checks at small shapes."""
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    dev = torch.device("cpu")
    k = chip_smoke.ssm_path(dev, 0, "zamba2-2.7b", batch=2, seq=64,
                            decode_steps=4, smoke=True, serving=True,
                            check_launches=False)
    mm = chip_smoke.ssm_path(dev, 0, "mamba2-130m", batch=2, seq=64,
                             decode_steps=4, smoke=True,
                             check_launches=False)
    for r in (k, mm):
        assert r["run"]["consistency_rel_err"] < chip_smoke.CONSISTENCY_TOL
        assert r["consistency_f32_rel_err"] < chip_smoke.CONSISTENCY_TOL_F32
        assert r["run"]["launches"]["plain_ssd_on_cuda"] == 0
    assert sum(k["serving"]["per_replica"]) == 64
    ref = chip_smoke.ssm_reference_check(dev, 0)
    assert ref["max_rel_err"] == {"zamba2-2.7b": 0.0, "mamba2-130m": 0.0}
    shapes = chip_smoke.ssd_model_shapes()
    assert [s[0] for s in shapes] == ["zamba2-2.7b", "mamba2-130m"]
    assert shapes[0][1:] == (8, 1024, 80, 64, 1, 64, 128)
    assert shapes[1][1:] == (8, 4096, 24, 64, 1, 128, 128)
    err = chip_smoke.check_ssd(dev, [("tiny", 1, 64, 8, 16, 1, 16, 16)])
    assert err == dict(max_abs_err=0.0, max_rel_err=0.0)
