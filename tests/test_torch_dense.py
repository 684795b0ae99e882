"""The port's dense decoder family and its VLM variant against the JAX
package, on the smoke configs of the five archs (gemma3-1b,
internlm2-20b, starcoder2-3b, command-r-plus-104b, internvl2-2b): the
layer options only these families use, the model's prefill, greedy
decode and loss from converted parameters, gemma3's ring-buffer
long-context decode, the zoo's surface and ``launch/serve.py``.

Parameters come from the reference's init (``dense_params_from_jax``),
with its zero biases, zero LayerNorm shifts and unit scales moved by
numpy noise so that each is exercised; inputs come from numpy seeds.
Tolerances: in f32 the outputs agree within 1e-5 relative to their
largest magnitude (matmuls, exp and tanh round differently in XLA and
torch on the CPU; measured ~1e-6) and the greedy tokens are equal; in
bf16 the frameworks round products at other places, so the bf16 checks
ask for 5e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import layers as jl
from repro.models import model_zoo as jzoo
from repro.models import sp_decode as jsp
from repro.models import transformer as jtf
from repro_torch import configs, convert
from repro_torch.configs.base import SHAPES
from repro_torch.launch import serve, steps
from repro_torch.models import layers as tl
from repro_torch.models import model_zoo as zoo
from repro_torch.models import sp_decode as tsp
from repro_torch.models import transformer as tf

ARCHS = ("gemma3-1b", "internlm2-20b", "starcoder2-3b",
         "command-r-plus-104b", "internvl2-2b")
B, S = 2, 64
DECODE_STEPS = 4
_NOISY = ("'scale'", "'bias'", "'b1'", "'b2'", "'bq'", "'bk'", "'bv'",
          "'bo'")


def close(ours, theirs, rtol=1e-5):
    theirs = np.asarray(theirs, np.float32)
    ours = ours.detach().float().numpy()
    assert ours.shape == theirs.shape
    scale = np.abs(theirs).max()
    assert np.abs(ours - theirs).max() <= rtol * scale, (
        np.abs(ours - theirs).max() / scale)


def t(x):
    return torch.from_numpy(np.asarray(x))


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


_PARAMS = {}


def params(arch, dtype="float32", **kw):
    """The reference's init with its norms and biases moved by noise,
    as jnp arrays and converted into the port, once per (arch, dtype)."""
    key = (arch, dtype, tuple(sorted(kw.items())))
    if key not in _PARAMS:
        jcfg = jconfigs.get_smoke_config(arch).replace(dtype=dtype, **kw)
        cfg = configs.get_smoke_config(arch).replace(dtype=dtype, **kw)
        rng = np.random.default_rng(7)

        def noisy(path, x):
            x = np.asarray(x)
            if any(n in jax.tree_util.keystr(path) for n in _NOISY):
                noise = rng.normal(0.0, 0.1, x.shape)
                x = (x.astype(np.float32) + noise).astype(x.dtype)
            return x
        tree = jax.tree_util.tree_map_with_path(
            noisy, jzoo.init_params(jcfg, jax.random.PRNGKey(0)))
        _PARAMS[key] = (jax.tree.map(jnp.asarray, tree),
                        convert.dense_params_from_jax(tree, cfg, "cpu"),
                        jcfg, cfg)
    return _PARAMS[key]


def batch_of(cfg, seed=1, seq=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rand(rng, B, cfg.n_patches, cfg.vision_dim)
    return batch


def tbatch(batch):
    return {k: t(v) for k, v in batch.items()}


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x, scale, bias = rand(rng, 3, 5, 32) * 4 + 1, rand(rng, 32), rand(rng, 32)
    jx = jnp.asarray(x, dtype)
    ours = tl.layernorm(t(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype)), t(scale), t(bias))
    assert ours.dtype == getattr(torch, dtype)
    close(ours, jl.layernorm(jx, scale, bias).astype(jnp.float32),
          1e-6 if dtype == "float32" else 5e-2)


@pytest.mark.parametrize("bias", [False, True])
def test_gelu_mlp_matches_jax(bias):
    """The tanh form of GELU (``jax.nn.gelu``'s default), with and
    without the biases ``b1``, ``b2``."""
    rng = np.random.default_rng(4)
    p = {"w1": rand(rng, 16, 48), "w2": rand(rng, 48, 16)}
    if bias:
        p.update(b1=rand(rng, 48), b2=rand(rng, 16))
    mlp = tl.GeluMLP(16, 48, torch.float32, "cpu", bias=bias)
    with torch.no_grad():
        for name, value in p.items():
            getattr(mlp, name).copy_(t(value))
    x = rand(rng, 2, 7, 16)
    close(mlp(t(x)), jl.gelu_mlp(x, p))


def qkv(seed, Sq=32, Sk=32, H=4, KV=2, Dh=8):
    rng = np.random.default_rng(seed)
    return rand(rng, 2, Sq, H, Dh), rand(rng, 2, Sk, KV, Dh), \
        rand(rng, 2, Sk, KV, Dh)


@pytest.mark.parametrize("case", [
    dict(causal=True, window=6, window_flag=True),
    dict(causal=True, window=6, window_flag=False),
    dict(causal=True, window=6),
    dict(causal=False, window=5, q_offset=9, window_flag=True),
    dict(causal=True, q_offset=7)], ids=str)
def test_dense_attention_window_matches_jax(case):
    q, k, v = qkv(5, Sq=32 - case.get("q_offset", 0))
    jcase = dict(case)
    if "window_flag" in jcase:
        jcase["window_flag"] = jnp.asarray(jcase["window_flag"])
    close(tl.dense_attention(t(q), t(k), t(v), **case),
          jl.dense_attention(q, k, v, **jcase))


@pytest.mark.parametrize("case", [
    dict(window=6, window_flag=True),
    dict(window=6, window_flag=False),
    dict(window=6),
    dict(window=None),
    dict(window=12, q_offset=16, window_flag=True),
    dict(window=12, q_offset=16, window_flag=False),
    dict(causal=False, window=12, window_flag=True)], ids=str)
def test_chunked_attention_window_matches_jax(case):
    """The triangular schedule (causal, no offset; a local layer skips
    the kv chunks wholly below its window, the reference only when no
    flag is given) and the rectangular sweep (an offset, or non-causal),
    each against the reference's chunked attention and the dense one."""
    case = {"causal": True, **case}
    q, k, v = qkv(6, Sq=32 - case.get("q_offset", 0))
    jcase = dict(case)
    if "window_flag" in jcase:
        jcase["window_flag"] = jnp.asarray(jcase["window_flag"])
    ours = tl.chunked_attention(t(q), t(k), t(v), q_chunk=8, kv_chunk=8,
                                **case)
    close(ours, jl.chunked_attention(q, k, v, q_chunk=8, kv_chunk=8,
                                     **jcase))
    close(ours, jl.dense_attention(q, k, v, **jcase))


def test_decode_attention_and_seqpar_lo_match_jax():
    """``decode_attention``'s ``lo_idx`` and ``seqpar_update_and_attend``'s
    ``lo`` (given as device tensors, as the decode step gives them); the
    port writes the caches it is given in place and returns them."""
    q, k, v = qkv(8, Sq=1)
    close(tl.decode_attention(t(q), t(k), t(v), 20, lo_idx=5),
          jl.decode_attention(q, k, v, 20, lo_idx=5))
    rng = np.random.default_rng(9)
    kn, vn = rand(rng, 2, 1, 2, 8), rand(rng, 2, 1, 2, 8)
    pos, lo = np.int32(17), np.int32(9)
    kc, vc = t(k).clone(), t(v).clone()
    ours = tsp.seqpar_update_and_attend(
        t(q), kc, vc, t(kn), t(vn), torch.tensor(17, dtype=torch.int32),
        lo=torch.tensor(9, dtype=torch.int32))
    theirs = jsp.seqpar_update_and_attend(q, k, v, kn, vn, pos, lo=lo)
    assert ours[1] is kc and ours[2] is vc
    for a, b in zip(ours, theirs):
        close(a, b)


# ---------------------------------------------------------------- models

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill on [2, 64] tokens (past gemma3's smoke window of 16; with
    8 patches first for internvl2, which its cache position counts), the
    primed cache, then 4 greedy decode steps: logits within 1e-5, tokens
    equal."""
    jp, tp, jcfg, cfg = params(arch)
    batch = batch_of(cfg)
    pad = S + cfg.n_patches * (cfg.family == "vlm") + DECODE_STEPS
    jlog, jcache = jax.jit(lambda p, b: jzoo.prefill_step(
        p, jcfg, b, pad_to=pad))(jp, batch)
    tlog, tcache = zoo.prefill_step(tp, cfg, tbatch(batch), pad_to=pad)
    close(tlog, jlog)
    for name in ("k", "v"):
        close(tcache[name], jcache[name])
    assert int(tcache["pos"]) == int(jcache["pos"]) == pad - DECODE_STEPS
    jstep = jax.jit(lambda p, c, x: jzoo.decode_step(p, jcfg, c, x))
    serve_step = steps.make_serve_step(cfg)
    jtok = jnp.argmax(jlog, -1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tlog, -1)[:, None].to(torch.int32)
    for _ in range(DECODE_STEPS):
        jlog, jcache = jstep(jp, jcache, jtok)
        tlog, tcache = serve_step(tp, tcache, ttok)
        close(tlog, jlog)
        jtok = jnp.argmax(jlog, -1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tlog, -1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    close(tcache["k"], jcache["k"])
    assert int(tcache["pos"]) == pad


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch):
    """``loss_fn`` (the VLM's patch prefix left out of the loss)."""
    jp, tp, jcfg, cfg = params(arch)
    batch = batch_of(cfg, seed=2)
    close(zoo.loss_fn(tp, cfg, tbatch(batch)),
          jax.jit(lambda p, b: jzoo.loss_fn(p, jcfg, b))(jp, batch))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma3_chunked_prefill_matches_jax(dtype):
    """gemma3's smoke config past a lowered ``attn_chunk_threshold``
    (chunks of 16 over 64 tokens): every layer takes
    ``chunked_attention``, the local ones masked by the window of 16
    (and skipping the kv chunks below it), the global ones not."""
    kw = dict(attn_chunk_threshold=32, q_chunk=16, kv_chunk=16)
    jp, tp, jcfg, cfg = params("gemma3-1b", dtype, **kw)
    batch = batch_of(cfg, seed=3)
    before = tl.chunked_attention.calls
    tlog, tcache = zoo.prefill_step(tp, cfg, tbatch(batch))
    assert tl.chunked_attention.calls - before == cfg.n_layers
    jlog, jcache = jax.jit(lambda p, b: jzoo.prefill_step(p, jcfg, b))(
        jp, batch)
    tol = 1e-5 if dtype == "float32" else 5e-2
    close(tlog, jlog.astype(jnp.float32), tol)
    close(tcache["v"], jcache["v"].astype(jnp.float32), tol)
    # the same config below the threshold: the dense path agrees
    dense, _ = zoo.prefill_step(tp, cfg.replace(attn_chunk_threshold=1 << 30),
                                tbatch(batch))
    close(tlog, dense.numpy(), tol)


def test_longctx_decode_matches_jax_and_uniform():
    """gemma3's ring-buffer decode over 40 steps, past the smoke window's
    wrap (16), against the reference's ``decode_step_longctx`` (each
    step's logits within 1e-5) and against the port's uniform-cache
    decode (within 1e-5: the same entries summed in another order); the
    zoo picks the ring past 65,536 positions and dispatches on it."""
    jp, tp, jcfg, cfg = params("gemma3-1b")
    ring = zoo.init_cache(cfg, B, 70_000, device="cpu")
    assert set(ring) == {"local_k", "local_v", "global_k", "global_v", "pos"}
    assert ring["local_k"].shape == (4, B, 16, 1, 16)
    assert ring["global_k"].shape == (2, B, 70_000, 1, 16)
    ring = tf.init_longctx_cache(cfg, B, 64, device="cpu")
    jring = jtf.init_longctx_cache(jcfg, B, 64)
    uni = zoo.init_cache(cfg, B, 64, device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (40, B, 1)) \
        .astype(np.int32)
    jstep = jax.jit(lambda p, c, x: jtf.decode_step_longctx(p, jcfg, c, x))
    for x in toks:
        jlog, jring = jstep(jp, jring, x)
        rlog, ring = zoo.decode_step(tp, cfg, ring, t(x))
        ulog, uni = zoo.decode_step(tp, cfg, uni, t(x))
        close(rlog, jlog)
        close(rlog, ulog.numpy())
    close(ring["local_v"], jring["local_v"])
    close(ring["global_k"], jring["global_k"])
    assert int(ring["pos"]) == int(jring["pos"]) == 40


# ---------------------------------------------------------------- surface

@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_surface(arch):
    """Parameter counts equal the reference's and ``cfg.param_count()``
    (which, in both packages, counts no bias and no LayerNorm shift:
    starcoder2's are added here); the weights' names and shapes are the
    reference's leaves; cache specs are meta tensors of the reference's
    shapes; random init is deterministic per seed."""
    jp, tp, jcfg, cfg = params(arch)
    total = zoo.count_params(tp)
    d, L = cfg.d_model, cfg.n_layers
    qkvo = cfg.n_heads * cfg.d_head + 2 * cfg.n_kv_heads * cfg.d_head + d
    extra = (L * (qkvo + cfg.d_ff + d + 2 * d) + d) if cfg.use_bias else 0
    assert total == jzoo.count_params(jp) == cfg.param_count() + extra
    specs = zoo.param_specs(cfg)
    assert zoo.count_params_specs(specs) == total
    jshapes = {jax.tree_util.keystr(k): v.shape for k, v in
               jax.tree_util.tree_flatten_with_path(jp)[0]}
    for name, p in specs.items():
        parts = name.split(".")
        stacked = parts[0] == "layers"
        if stacked:
            parts = parts[:1] + parts[2:]
        jshape = jshapes["".join(f"['{part}']" for part in parts)]
        assert tuple(jshape[1:] if stacked else jshape) == tuple(p.shape)
        assert p.device.type == "meta"
    spec, jspec = zoo.cache_spec(cfg, 4, 32), jzoo.cache_spec(jcfg, 4, 32)
    assert set(spec) == set(jspec)
    for name in jspec:
        assert tuple(spec[name].shape) == tuple(jspec[name].shape)
        assert spec[name].device.type == "meta"
    a = zoo.init_params(cfg, 5, device="cpu")
    b = zoo.init_params(cfg, 5, device="cpu")
    for (n, x), y in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(x, y), n
    logits, _ = zoo.prefill_step(a, cfg, tbatch(batch_of(cfg)))
    assert logits.shape == (B, cfg.vocab) and bool(logits.isfinite().all())


def test_longctx_spec_input_specs_and_cells():
    """gemma3's long-context cache spec (meta, as the reference's), the
    VLM's input specs (patches and S - n_patches tokens), and the
    registry's cells and applicability equal the reference's, every arch
    of it ported, whisper-small's config too."""
    for arch in ("gemma3-1b",):
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        spec = zoo.cache_spec(cfg, 1, 524_288)
        jspec = jzoo.cache_spec(jcfg, 1, 524_288)
        assert set(spec) == set(jspec) and "local_k" in spec
        for name in jspec:
            assert tuple(spec[name].shape) == tuple(jspec[name].shape)
            assert str(spec[name].dtype).split(".")[1] == \
                str(jspec[name].dtype)
            assert spec[name].device.type == "meta"
        assert tuple(tf.longctx_cache_spec(cfg, 1, 524_288)["global_k"]
                     .shape) == (4, 1, 524_288, 1, 256)
    cfg = configs.get_config("internvl2-2b")
    jcfg = jconfigs.get_config("internvl2-2b")
    for shape in SHAPES.values():
        ours, theirs = zoo.input_specs(cfg, shape), jzoo.input_specs(
            jcfg, shape)
        got = jax.tree_util.tree_map(lambda x: tuple(x.shape), ours)
        want = jax.tree_util.tree_map(lambda x: tuple(x.shape), theirs)
        assert got == want, shape.name
    want = jconfigs.cells()
    assert configs.cells() == want and len(want) == 40
    for arch, shape, ok in want:
        assert configs.shape_applicable(arch, shape) == ok
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in ARCHS + ("whisper-small",):
        ours = configs.get_config(arch)
        theirs = jconfigs.get_config(arch)
        assert {f: getattr(ours, f) for f in ours.__dataclass_fields__} \
            == {f: getattr(theirs, f) for f in theirs.__dataclass_fields__}
        assert configs.get_smoke_config(arch).__dict__ == \
            jconfigs.get_smoke_config(arch).__dict__


# --------------------------------------------------------------- serving

def test_serving_replica_generates_jax_tokens():
    """The port's ``build_replica`` and the reference's give the same
    greedy tokens over gemma3's smoke config from the same (converted)
    f32 parameters."""
    jp, tp, jcfg, cfg = params("gemma3-1b")
    prompts = [5, 17, 200, 3, 99]
    ours = serve.build_replica(cfg, tp, decode_steps=DECODE_STEPS)(prompts)
    want = jserve.build_replica(jcfg, jp, decode_steps=DECODE_STEPS)(prompts)
    np.testing.assert_array_equal(ours, want)
    assert ours.shape == (5, DECODE_STEPS)


def test_serve_main_serves_gemma3_by_default(capsys):
    """``python -m repro_torch.launch.serve --device cpu`` serves
    gemma3-1b's smoke config, as the reference's ``main`` does: every
    request once, and each request's ids those of ``serve`` over that
    config (a dense model's rows do not depend on their batch mates)."""
    out = serve.main(["--device", "cpu", "--hetero", "--requests", "16",
                      "--decode-steps", "3"])
    assert "served 16 requests" in capsys.readouterr().out
    eng = out["engine"]
    assert out["served"] == eng.submitted == 16 and eng.in_flight == 0
    cfg = configs.get_smoke_config("gemma3-1b")
    want = serve.serve(cfg, zoo.init_params(cfg, 0, device="cpu"),
                       requests=16, decode_steps=3, device="cpu")
    assert sorted(out["outputs"]) == list(range(16))
    for i, ids in out["outputs"].items():
        np.testing.assert_array_equal(ids, want["outputs"][i])


def test_chip_smoke_dense_phase_rehearses_on_cpu():
    """``chip_smoke.py``'s phase 12 at the smoke sizes: gemma3's runs
    (prefill + decode, the prefill/decode gap in bf16 and f32 past the
    window, a longer prefill, the ring against the uniform cache past
    65,536 positions, and again from a prefill just short of the window
    past its wrap, ``serve`` with all 64 requests served), the VLM
    and starcoder2 runs, and the card-vs-CPU reference check (here CPU
    against CPU, the ring against the uniform decode past the window's
    wrap)."""
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    dev = torch.device("cpu")
    out = chip_smoke.dense_path(dev, 0, "gemma3-1b", batch=2, seq=32,
                                decode_steps=3, smoke=True, long=(2, 64, 2),
                                gap=True, ring=(2, 70_000, 4, 3), serving=True,
                                check_launches=False)
    assert out["consistency_f32_rel_err"] < 1e-4
    assert out["ring"]["ring"]["cache_gb"] < out["ring"]["uniform"]["cache_gb"]
    wrap = out["ring_wrap"]
    assert wrap["start"] + wrap["steps"] > wrap["window"]
    assert wrap["max_rel_err_past_wrap"] < chip_smoke.CONSISTENCY_TOL
    assert sum(out["serving"]["per_replica"]) == 64
    assert out["long"]["seq"] == 64 and out["run"]["decode_steps"] == 3
    for arch in ("starcoder2-3b", "internvl2-2b"):
        run = chip_smoke.dense_path(dev, 0, arch, batch=2, seq=24,
                                    decode_steps=2, smoke=True,
                                    check_launches=False)["run"]
        assert run["seq"] == 24 + 8 * (arch == "internvl2-2b")
    errs = chip_smoke.dense_reference_check(dev, 0, ring_steps=20)
    assert set(errs["max_rel_err"]) == set(ARCHS) | {
        "gemma3-1b ring vs uniform"}
    assert errs["max_rel_err"]["gemma3-1b"] == 0.0
