"""The port's whisper (``models/encdec.py``) and the training pieces it
brings to the dense, VLM and audio families, against the JAX package:
``layernorm``'s custom VJP, the cross-attention's ``kv_override`` and
``seqpar_attend``, the encoder-decoder's ``encode``, ``decode_train``,
``loss_fn``, ``prime_cross_cache``, prefill and greedy decode and its
cache spec, whisper's loss gradients, the selective remat policies
("dots", "attn_out") and the train steps of whisper-small and
starcoder2-3b (the LayerNorm family); then a rehearsal of
``chip_smoke.py``'s phase 13.

Smoke configs (2 + 2 layers, d 64) in f32, inputs from numpy seeds
(24 frames, 16 tokens), weights from the reference's init through
``convert.encdec_params_from_jax`` / ``dense_params_from_jax``, with
the zero biases, zero LayerNorm shifts and unit scales moved by numpy
noise so that a missing bias or a wrong norm shows. Tolerances, as
max|a − b| over max|b| per tensor: 1e-5 for values and gradients
(XLA and torch round matmuls, exp and tanh differently on the CPU;
measured ~1e-6), and greedy tokens equal; 1e-6 between the remat
policies of the port (the same operations, recomputed). One gradient
is zero in exact arithmetic: the cross-attention's key bias ``bk``
(a shift common to every key leaves the softmax over keys as it is),
so each framework gives rounding noise (~1e-10); it is held to 1e-5
of the largest gradient of the model instead of its own.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import encdec as jed
from repro.models import layers as jl
from repro.models import model_zoo as jzoo
from repro.models import sp_decode as jsp
from repro_torch import configs, convert, optim
from repro_torch.configs.base import SHAPES
from repro_torch.launch import serve
from repro_torch.launch.steps import make_train_step
from repro_torch.models import encdec as ed
from repro_torch.models import layers as tl
from repro_torch.models import model_zoo as zoo
from repro_torch.models import sp_decode as tsp
from repro_torch.models import transformer as tf

ARCH = "whisper-small"
B, S_ENC, S_DEC = 2, 24, 16
_NOISY = ("'scale'", "'bias'", "'b1'", "'b2'", "'bq'", "'bk'", "'bv'",
          "'bo'")
CONVERT = {"audio": convert.encdec_params_from_jax,
           "dense": convert.dense_params_from_jax,
           "vlm": convert.dense_params_from_jax}


def rel(ours, theirs) -> float:
    ours = ours.detach().float().numpy() if isinstance(
        ours, torch.Tensor) else np.asarray(ours, np.float32)
    theirs = np.asarray(theirs, np.float32)
    assert ours.shape == theirs.shape
    return float(np.abs(ours - theirs).max()
                 / max(np.abs(theirs).max(), 1e-30))


def t(x):
    return torch.from_numpy(np.array(x))


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


_PARAMS = {}


def params(arch=ARCH, **kw):
    """The reference's f32 init with its norms and biases moved by noise:
    (jnp tree, the port's module, jcfg, cfg), once per arch and
    options."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _PARAMS:
        jcfg = jconfigs.get_smoke_config(arch).replace(dtype="float32", **kw)
        cfg = configs.get_smoke_config(arch).replace(dtype="float32", **kw)
        rng = np.random.default_rng(7)

        def noisy(path, x):
            x = np.asarray(x)
            if any(n in jax.tree_util.keystr(path) for n in _NOISY):
                x = (x + rng.normal(0.0, 0.1, x.shape)).astype(x.dtype)
            return x
        tree = jax.tree_util.tree_map_with_path(
            noisy, jzoo.init_params(jcfg, jax.random.PRNGKey(0)))
        _PARAMS[key] = (jax.tree.map(jnp.asarray, tree),
                        CONVERT[cfg.family](tree, cfg, "cpu"), jcfg, cfg)
    jp, tp, jcfg, cfg = _PARAMS[key]
    return jp, tp, jcfg, cfg


def batch_of(cfg, seed=1, seq=S_DEC, frames=S_ENC):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rand(rng, B, frames, cfg.d_model)
    if cfg.family == "vlm":
        batch["patches"] = rand(rng, B, cfg.n_patches, cfg.vision_dim)
    return batch


def tbatch(batch):
    return {k: t(v) for k, v in batch.items()}


def grads_tree(cfg, tree):
    """The port's module of a JAX pytree of gradients, by name."""
    return dict(CONVERT[cfg.family](jax.tree.map(np.asarray, tree), cfg,
                                    "cpu").named_parameters())


def check_grads(names, grads, want, tol):
    """Every gradient within ``tol`` of its own largest, or of the
    model's largest where the reference's is zero in exact arithmetic
    (the module docstring)."""
    top = max(float(g.abs().max()) for g in want.values())
    for name, g in zip(names, grads):
        w = want[name].detach()
        scale = (top if name.endswith("cross_attn.bk")
                 else float(w.abs().max()))
        err = float((g.detach() - w).abs().max())
        assert scale > 0 and err <= tol * scale, (name, err / scale)


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_vjp_matches_jax(dtype):
    """``layernorm``'s custom VJP against ``jax.vjp`` of the reference's:
    dx, dscale and dbias; the residual the backward keeps is x in its own
    dtype (and the scale); without autograd the same forward."""
    rng = np.random.default_rng(0)
    x = rand(rng, 2, 8, 64) * 3 + 1
    scale, bias = 1 + 0.1 * rand(rng, 64), 0.1 * rand(rng, 64)
    g = rand(rng, 2, 8, 64)
    jdt = jnp.dtype(dtype)
    out, vjp = jax.vjp(jl.layernorm, jnp.asarray(x, jdt),
                       jnp.asarray(scale, jdt), jnp.asarray(bias, jdt))
    dx, dscale, dbias = vjp(jnp.asarray(g, jdt))
    tdt = getattr(torch, dtype)
    tx, ts, tb = (t(a).to(tdt).requires_grad_(True) for a in (x, scale,
                                                              bias))
    tout = tl.layernorm(tx, ts, tb)
    assert [s.dtype for s in tout.grad_fn.saved_tensors] == [tdt, tdt]
    tout.backward(t(g).to(tdt))
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert tout.dtype == tdt and tx.grad.dtype == tdt
    for ours, theirs in ((tout, out), (tx.grad, dx), (ts.grad, dscale),
                         (tb.grad, dbias)):
        assert rel(ours, theirs.astype(jnp.float32)) < tol
    with torch.no_grad():
        assert torch.equal(tl.layernorm(tx, ts, tb), tout.detach())


def test_kv_override_and_seqpar_attend_match_jax():
    """``attention(..., kv_override=(k, v))`` (no RoPE on q or k; k of
    another length than x) and ``seqpar_attend`` (no cache write)."""
    jp, tp, jcfg, cfg = params()
    rng = np.random.default_rng(3)
    x = rand(rng, B, 5, cfg.d_model)
    k, v = rand(rng, B, 9, 4, 16), rand(rng, B, 9, 4, 16)
    pos = np.broadcast_to(np.arange(5), (B, 5))
    lp = tp.dec_layers[0].cross_attn
    jlp = jax.tree.map(lambda a: a[0], jp["dec_layers"])["cross_attn"]
    ours = tl.attention(t(x), lp, cfg, positions=t(pos), causal=False,
                        kv_override=(t(k), t(v)))
    assert rel(ours, jl.attention(x, jlp, jcfg, positions=pos, causal=False,
                                  kv_override=(k, v))) < 1e-5
    q = rand(rng, B, 1, 4, 16)
    kc, vc = t(k), t(v)
    out = tsp.seqpar_attend(t(q), kc, vc, 7)
    assert torch.equal(kc, t(k)) and torch.equal(vc, t(v))
    assert rel(out, jsp.seqpar_attend(q, k, v, 7)) < 1e-5


# ---------------------------------------------------------------- model

def test_encode_decode_train_and_loss_match_jax():
    jp, tp, jcfg, cfg = params()
    batch = batch_of(cfg)
    mem = ed.encode(tp, cfg, t(batch["frames"]))
    jmem = jax.jit(lambda p, f: jed.encode(p, jcfg, f))(jp, batch["frames"])
    assert rel(mem, jmem) < 1e-5
    x = ed.decode_train(tp, cfg, t(batch["tokens"]), mem)
    jx = jax.jit(lambda p, tok, m: jed.decode_train(p, jcfg, tok, m))(
        jp, batch["tokens"], jmem)
    assert rel(x, jx) < 1e-5
    loss = zoo.loss_fn(tp, cfg, tbatch(batch))
    assert rel(loss, jax.jit(lambda p, b: jzoo.loss_fn(p, jcfg, b))(
        jp, batch)) < 1e-5


def test_prefill_prime_and_decode_match_jax():
    """Prefill of 24 frames and 16 tokens into a cache padded to 20,
    ``prime_cross_cache`` on a zero cache, then 4 greedy decode steps:
    logits within 1e-5, tokens equal; the self cache written in place,
    the cross cache unchanged."""
    jp, tp, jcfg, cfg = params()
    batch = batch_of(cfg)
    pad = S_DEC + 4
    jlog, jcache = jax.jit(lambda p, b: jzoo.prefill_step(
        p, jcfg, b, pad_to=pad))(jp, batch)
    tlog, tcache = zoo.prefill_step(tp, cfg, tbatch(batch), pad_to=pad)
    assert rel(tlog, jlog) < 1e-5
    for name in ("k", "v", "cross_k", "cross_v"):
        assert rel(tcache[name], jcache[name]) < 1e-5, name
    assert int(tcache["pos"]) == int(jcache["pos"]) == S_DEC
    jmem = jed.encode(jp, jcfg, batch["frames"])
    primed = ed.prime_cross_cache(
        tp, cfg, ed.init_cache(cfg, B, pad, S_ENC, device="cpu"),
        ed.encode(tp, cfg, t(batch["frames"])))
    jprimed = jed.prime_cross_cache(jp, jcfg,
                                    jed.init_cache(jcfg, B, pad, S_ENC), jmem)
    for name in ("cross_k", "cross_v"):
        assert rel(primed[name], jprimed[name]) < 1e-5
        assert rel(primed[name], tcache[name].numpy()) < 1e-5
    jstep = jax.jit(lambda p, c, x: jzoo.decode_step(p, jcfg, c, x))
    cross = tcache["cross_k"].clone()
    k_cache = tcache["k"]
    jtok = jnp.argmax(jlog, -1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tlog, -1)[:, None].to(torch.int32)
    for _ in range(4):
        jlog, jcache = jstep(jp, jcache, jtok)
        tlog, tcache = zoo.decode_step(tp, cfg, tcache, ttok)
        assert rel(tlog, jlog) < 1e-5
        jtok = jnp.argmax(jlog, -1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tlog, -1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert tcache["k"] is k_cache and torch.equal(tcache["cross_k"], cross)
    assert rel(tcache["v"], jcache["v"]) < 1e-5
    assert int(tcache["pos"]) == int(jcache["pos"]) == pad


def test_cache_spec_zoo_surface_and_input_specs():
    """``cache_spec`` (the zoo's with ``enc_len = max_len``, encdec's with
    its own) and ``init_cache`` against the reference's; parameter
    counts against the reference's and ``cfg.param_count()`` (which
    counts no bias and no LayerNorm shift: added back here) at full and
    smoke size; the weights' names and shapes the reference's leaves;
    the audio family's input specs."""
    _, _, jsmoke, smoke = params()
    for cfg, jcfg in ((configs.get_config(ARCH), jconfigs.get_config(ARCH)),
                      (smoke, jsmoke)):
        for ours, theirs in ((zoo.cache_spec(cfg, 4, 32),
                              jzoo.cache_spec(jcfg, 4, 32)),
                             (ed.cache_spec(cfg, 4, 32, 48),
                              jed.cache_spec(jcfg, 4, 32, 48))):
            assert set(ours) == set(theirs)
            for name in theirs:
                assert tuple(ours[name].shape) == tuple(theirs[name].shape)
                assert str(ours[name].dtype).split(".")[1] == \
                    str(theirs[name].dtype)
                assert ours[name].device.type == "meta"
        d, L, E = cfg.d_model, cfg.n_layers, cfg.n_enc_layers
        extra = (E * (4 * d + cfg.d_ff + d + 2 * d)
                 + L * (8 * d + cfg.d_ff + d + 3 * d) + 2 * d)
        specs = zoo.param_specs(cfg)
        jspecs = jzoo.param_specs(jcfg)
        assert zoo.count_params_specs(specs) == jzoo.count_params_specs(
            jspecs) == cfg.param_count() + extra
        jshapes = {jax.tree_util.keystr(k): v.shape for k, v in
                   jax.tree_util.tree_flatten_with_path(jspecs)[0]}
        for name, p in specs.items():
            parts = name.split(".")
            stacked = parts[0] in ("enc_layers", "dec_layers")
            if stacked:
                parts = parts[:1] + parts[2:]
            jshape = jshapes["".join(f"['{part}']" for part in parts)]
            assert tuple(jshape[1:] if stacked else jshape) == tuple(p.shape)
        for shape in SHAPES.values():
            got = jax.tree_util.tree_map(lambda x: tuple(x.shape),
                                         zoo.input_specs(cfg, shape))
            want = jax.tree_util.tree_map(lambda x: tuple(x.shape),
                                          jzoo.input_specs(jcfg, shape))
            assert got == want, shape.name
    cache = zoo.init_cache(cfg, 2, 8, device="cpu")
    assert cache["cross_k"].shape == (2, 2, 8, 4, 16)
    assert int(cache["pos"]) == 0 and not cache["k"].any()
    tp = zoo.init_params(cfg, 5, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(
        tp.parameters(), zoo.init_params(cfg, 5, device="cpu").parameters()))
    assert zoo.count_params(tp) == zoo.count_params_specs(specs)


# --------------------------------------------------------------- training

@pytest.mark.parametrize("remat", ["none", "full"])
def test_whisper_loss_grads_match_jax(remat):
    """Loss and every gradient against ``jax.value_and_grad`` of the
    reference's ``loss_fn``; remat "full" recomputes each layer of both
    stacks in the backward."""
    jp, tp, jcfg, cfg = params()
    batch = batch_of(cfg, seed=2)
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jzoo.loss_fn(p, jcfg, b)))(jp, batch)
    model = tp.requires_grad_(True)
    c = cfg.replace(remat=remat)
    loss = zoo.loss_fn(model, c, tbatch(batch))
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    model.requires_grad_(False)
    assert rel(loss, jloss) < 1e-5
    check_grads(names, grads, grads_tree(cfg, jg), 1e-5)


def _saved(model, cfg, batch, monkeypatch):
    """(loss, gradients by name, tensors kept for the backward): what
    autograd saves outside a checkpoint (``saved_tensors_hooks``; inside
    one the checkpoint's own hooks keep nothing) plus the op outputs a
    selective policy keeps (counted at the policy, forward only)."""
    kept = [0]
    real = tf._policy

    def counting(saved):
        inner = real(saved)

        def policy(ctx, op, *args, **kwargs):
            decision = inner(ctx, op, *args, **kwargs)
            if not ctx.is_recompute and decision.name == "MUST_SAVE":
                kept[0] += 1
            return decision
        return policy

    def pack(x):
        kept[0] += 1
        return x

    monkeypatch.setattr(tf, "_policy", counting)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        loss = zoo.loss_fn(model, cfg, batch)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(names, grads)), kept[0]


@pytest.mark.parametrize("arch", [ARCH, "starcoder2-3b"])
def test_selective_remat_equals_none_and_keeps_between(arch, monkeypatch):
    """"dots" (the unbatched products kept) and "attn_out" (the named
    attention outputs kept) give the loss and every gradient of "none"
    within 1e-6; each keeps fewer tensors for the backward than "none"
    and more than "full"."""
    jp, tp, jcfg, cfg = params(arch)
    batch = tbatch(batch_of(cfg, seed=3))
    model = tp.requires_grad_(True)
    out = {r: _saved(model, cfg.replace(remat=r), batch, monkeypatch)
           for r in ("none", "full", "dots", "attn_out")}
    model.requires_grad_(False)
    loss0, g0, n_none = out["none"]
    n_full = out["full"][2]
    for remat in ("dots", "attn_out"):
        loss, g, n = out[remat]
        assert rel(loss, loss0.numpy()) <= 1e-6, remat
        for name, grad in g0.items():
            assert rel(g[name], grad.numpy()) <= 1e-6, (remat, name)
        assert n_full < n < n_none, (remat, n_full, n, n_none)
    assert out["dots"][2] > out["attn_out"][2]


@pytest.mark.parametrize("arch", [ARCH, "starcoder2-3b"])
def test_train_step_matches_jax(arch):
    """Three steps of ``make_train_step`` (remat "full") against
    ``jax.jit(repro.launch.steps.make_train_step(...))`` from the same
    weights on the same batch, as ``tests/test_torch_train.py`` holds the
    MoE's and the SSMs' train steps: AdamW eps 1e-5 (with 1e-8 an element
    whose gradient is at the frameworks' rounding noise moves by up to
    lr apart: that file's docstring); loss, lr, grad_norm within 1e-5;
    every weight afterwards within 1e-5·max|w| + 1e-3·Σ lr."""
    jp, tp, jcfg, cfg = params(arch, remat="full")
    kw = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10, eps=1e-5)
    jstep = jax.jit(jsteps.make_train_step(jcfg, joptim.AdamWConfig(**kw)))
    step = make_train_step(cfg, optim.AdamWConfig(**kw))
    model = CONVERT[cfg.family](jax.tree.map(np.asarray, jp), cfg, "cpu")
    jo, to = joptim.init(jp), optim.init(model)
    batch = batch_of(cfg, seed=4, seq=32)
    lr_sum = 0.0
    for _ in range(3):
        jp, jo, jm = jstep(jp, jo, batch)
        model, to, tm = step(model, to, tbatch(batch))
        assert set(tm) == set(jm) == {"loss", "lr", "grad_norm"}
        for name in ("loss", "lr", "grad_norm"):
            assert rel(tm[name], jm[name]) < 1e-5, name
        lr_sum += float(jm["lr"])
    want = CONVERT[cfg.family](jax.tree.map(np.asarray, jp), cfg, "cpu")
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 want.named_parameters()):
        err = float((p.detach() - q.detach()).abs().max())
        assert err <= 1e-5 * float(q.abs().max()) + 1e-3 * lr_sum, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_consistency(dtype):
    """prefill(prompt[:-1]) + decode(last) against prefill(prompt), in
    both packages on the same weights and inputs (the reference's own
    ``test_prefill_then_decode_consistency`` leaves whisper out): within
    the reference's bound 5e-2 in bf16, 1e-4 in f32, and the two
    packages' gaps alike."""
    jp, tp, jcfg, cfg = params()
    if dtype == "bfloat16":
        jcfg, cfg = jcfg.replace(dtype=dtype), cfg.replace(dtype=dtype)
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        tp = convert.encdec_params_from_jax(jax.tree.map(np.asarray, jp),
                                            cfg, "cpu")
    batch = batch_of(cfg, seed=5)
    short = dict(batch, tokens=batch["tokens"][:, :-1])
    last = batch["tokens"][:, -1:]
    full, _ = jax.jit(lambda p, b: jzoo.prefill_step(p, jcfg, b))(jp, batch)
    _, cache = jax.jit(lambda p, b: jzoo.prefill_step(
        p, jcfg, b, pad_to=S_DEC))(jp, short)
    inc, _ = jax.jit(lambda p, c, x: jzoo.decode_step(p, jcfg, c, x))(
        jp, cache, last)
    gaps = [rel(inc.astype(jnp.float32), full.astype(jnp.float32))]
    full, _ = zoo.prefill_step(tp, cfg, tbatch(batch))
    _, cache = zoo.prefill_step(tp, cfg, tbatch(short), pad_to=S_DEC)
    inc, _ = zoo.decode_step(tp, cfg, cache, t(last))
    gaps.append(rel(inc, full.numpy()))
    bound = 5e-2 if dtype == "bfloat16" else 1e-4
    assert max(gaps) < bound, gaps


def test_serving_replica_generates_jax_tokens():
    """``build_replica`` over whisper's smoke config from ``zoo.init_cache``
    (its cross cache zeros, as the reference's) gives the reference's
    greedy tokens; ``launch/serve.py --arch whisper-small`` serves every
    request."""
    jp, tp, jcfg, cfg = params()
    prompts = [5, 17, 200, 3, 99]
    ours = serve.build_replica(cfg, tp, decode_steps=3)(prompts)
    want = jserve.build_replica(jcfg, jp, decode_steps=3)(prompts)
    np.testing.assert_array_equal(ours, want)
    out = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "8",
                      "--decode-steps", "2"])
    assert out["served"] == 8 and sorted(out["outputs"]) == list(range(8))


# ------------------------------------------------------------ chip_smoke

def test_chip_smoke_encdec_phase_rehearses_on_cpu():
    """``chip_smoke.py``'s phase 13 at the smoke configs on the CPU, with
    every check it makes on the card but the launches: (aa) whisper's
    prefill + greedy decode and the prefill/decode gap in f32, (aa2)
    ``serve`` with nothing lost, the training cells (the loss falls over
    their steps), the remat policies on gemma3 (the same first loss),
    the driver's ``Trainer`` on whisper, and the card-against-CPU checks
    (here CPU against CPU)."""
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    out = chip_smoke.encdec_train_phase(torch.device("cpu"), 0, smoke=True,
                                        check_launches=False)
    aa = out["whisper"]
    assert aa["run"]["decode_steps"] == 3 and aa["gap_f32"] < 1e-4
    assert sum(aa["serving"]["per_replica"]) == 64
    assert set(out["train"]) == {"gemma3-1b", "starcoder2-3b",
                                 "internvl2-2b", "whisper-small"}
    assert set(out["remat"]) == {"none", "full", "dots", "attn_out"}
    assert len(out["driver"]["steps"]) == 3
    assert set(out["reference"]) == {"gemma3-1b", "starcoder2-3b",
                                     "internvl2-2b", "whisper-small"}
    assert all(r["loss_rel_err"] == 0.0 for r in out["reference"].values())
