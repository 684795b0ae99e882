"""The port's training path against the JAX package, on numpy-made
inputs and converted parameters: the rmsnorm custom VJP, the chunked
cross-entropy and its labels, AdamW, the dispatch's gradient, the
layer rematerialisation and the whole train step on qwen3-moe's smoke
config, routers "cg" and "topk", uniform and ``capacity_skew``
capacities, with and without gradient accumulation; then the Mamba-2
and zamba2 smoke configs: loss and every gradient (remat "none" and
"full", the SSD scan's explicit backward and autograd through
``ssd_chunked``), the hybrid past a lowered attention threshold (the
chunked attention's rematerialised backward), and the train step.

Tolerances, as max|a − b| over max|b| per tensor: 1e-5 in f32 for
values, gradients and the weights after three steps (matmuls, sums and
transcendental functions round differently in XLA and torch on the CPU:
~1e-7–1e-6 measured); 1e-6 for AdamW on the same inputs (the same
operations in the same order; only pow, cos and sqrt may differ by an
ulp); 1e-2 in bf16 (half an ulp of bf16 is 2^-9); the routing
telemetry equal. The hybrid's gradients are held to 3e-5: at its
worst tensor (the last Mamba-2 layer's ``in_proj`` before the second
shared attention) XLA's f32 gradient is 6.0e-6 and the port's 1.1e-5
from the port's f64 gradient, and the two 1.7e-5 apart (with either
SSD gradient), an f32 rounding the layer amplifies, not a fault.
"""
import dataclasses
import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.kernels.ref import ref_cg_dispatch as jax_ref_cg_dispatch
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.models import lm_common as jlm
from repro.models import model_zoo as jzoo
from repro_torch import configs, convert, optim
from repro_torch.configs.base import SHAPES
from repro_torch.kernels import ref
from repro_torch.launch.steps import make_train_step
from repro_torch.models import layers, lm_common
from repro_torch.models import model_zoo as zoo

ARCH = "qwen3-moe-235b-a22b"
# the module: ``repro_torch.kernels`` exports a function of its name
kdispatch = importlib.import_module("repro_torch.kernels.cg_dispatch")


def rel(ours, theirs) -> float:
    ours = ours.detach().float().numpy() if isinstance(
        ours, torch.Tensor) else np.asarray(ours, np.float32)
    theirs = np.asarray(theirs, np.float32)
    return float(np.abs(ours - theirs).max() / max(np.abs(theirs).max(),
                                                   1e-30))


def t(a, dtype=None, grad=False):
    x = torch.from_numpy(np.array(a))
    if dtype is not None:
        x = x.to(dtype)
    return x.requires_grad_(grad)


# ---------------------------------------------------------------- rmsnorm

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_forward_and_vjp_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(64)).astype(np.float32)
    g = rng.standard_normal((2, 8, 64)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    out, vjp = jax.vjp(jlayers.rmsnorm, jnp.asarray(x, jdt),
                       jnp.asarray(scale, jdt))
    dx, dscale = vjp(jnp.asarray(g, jdt))
    tdt = getattr(torch, dtype)
    tx, ts = t(x, tdt, True), t(scale, tdt, True)
    tout = layers.rmsnorm(tx, ts)
    # the residual the backward keeps is x in its own dtype
    assert [s.dtype for s in tout.grad_fn.saved_tensors] == [tdt, tdt]
    tout.backward(t(g, tdt))
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert tout.dtype == tdt and tx.grad.dtype == tdt
    assert rel(tout, out.astype(jnp.float32)) < tol
    assert rel(tx.grad, dx.astype(jnp.float32)) < tol
    assert rel(ts.grad, dscale.astype(jnp.float32)) < tol
    with torch.no_grad():   # serving: the same forward, no graph
        assert torch.equal(layers.rmsnorm(tx, ts), tout.detach())


# ------------------------------------------------------- chunked_xent

def test_chunked_xent_and_shift_labels_match_jax():
    """Three chunks of 16 and a tail of 8 that both leave out, labels
    with ignored (-1) positions; the loss and its gradients to x and the
    table."""
    rng = np.random.default_rng(1)
    B, S, D, V = 2, 56, 32, 97
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    embed = (0.3 * rng.standard_normal((V, D))).astype(np.float32)
    tokens = rng.integers(0, V, (B, S)).astype(np.int32)
    labels = np.array(jlm.shift_labels(jnp.asarray(tokens)))
    np.testing.assert_array_equal(
        lm_common.shift_labels(torch.from_numpy(tokens)).numpy(), labels)
    labels[0, 5:9] = -1
    loss, (gx, ge) = jax.value_and_grad(
        lambda a, b: jlm.chunked_xent(a, b, jnp.asarray(labels), chunk=16),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(embed))
    tx, te = t(x, grad=True), t(embed, grad=True)
    tl = lm_common.chunked_xent(tx, te, torch.from_numpy(labels), chunk=16)
    tl.backward()
    assert rel(tl, loss) < 1e-6
    assert rel(tx.grad, gx) < 1e-5 and rel(te.grad, ge) < 1e-5
    with torch.no_grad():
        assert rel(lm_common.chunked_xent(tx, te, torch.from_numpy(labels),
                                          chunk=16), loss) < 1e-6


# ---------------------------------------------------------------- AdamW

def test_schedule_matches_jax():
    cfg = optim.AdamWConfig(warmup_steps=3, total_steps=10)
    jcfg = joptim.AdamWConfig(warmup_steps=3, total_steps=10)
    for step in range(0, 13):
        want = joptim.schedule(jcfg, jnp.int32(step))
        got = optim.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-7 * float(want) + 1e-12


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_updates_match_jax(dtype):
    """Three updates from the same weights and gradients (the first
    clipped by the global norm): weights, m, v, master, lr, grad_norm."""
    rng = np.random.default_rng(2)
    shapes = {"a": (8, 16), "b": (3, 4, 5), "c": (7,)}
    w = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v, jdt) for k, v in w.items()}
    tp = {k: t(v, tdt) for k, v in w.items()}
    cfg = optim.AdamWConfig(lr_peak=1e-2, warmup_steps=2, total_steps=6)
    jcfg = joptim.AdamWConfig(lr_peak=1e-2, warmup_steps=2, total_steps=6)
    jst, tst = joptim.init(jp), optim.init(tp)
    for i in range(3):
        g = {k: (rng.standard_normal(s) * (3.0 if i == 0 else 0.1)).astype(
            np.float32) for k, s in shapes.items()}
        jp, jst, jm = joptim.update(jp, {k: jnp.asarray(v, jdt)
                                         for k, v in g.items()}, jst, jcfg)
        tp, tst, tm = optim.update(tp, {k: t(v, tdt) for k, v in g.items()},
                                   tst, cfg)
        assert rel(tm["lr"], jm["lr"]) < 1e-6
        assert rel(tm["grad_norm"], jm["grad_norm"]) < 1e-6
        assert int(tst["step"]) == int(jst["step"]) == i + 1
    for k in shapes:
        for part in ("m", "v", "master"):
            assert rel(tst[part][k], jst[part][k]) < 1e-6, (part, k)
        assert tp[k].dtype == tdt
        assert torch.equal(tp[k], tst["master"][k].to(tdt))
        assert rel(tp[k], jp[k].astype(jnp.float32)) < (
            1e-6 if dtype == "float32" else 1e-2)


# ------------------------------------------------- the dispatch's gradient

def routing(G, T, E, D, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((G, T, E)) + 2.0 * rng.standard_normal(
        (G, 1, E))
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    pref = np.argsort(-p, axis=-1, kind="stable")[..., :D].astype(np.int32)
    return pref, np.take_along_axis(p, pref, -1)


@pytest.mark.parametrize("E,k,D,caps", [(8, 2, 4, "uniform"),
                                        (16, 4, 8, "skewed"),
                                        (8, 2, 2, "uniform")])
def test_dispatch_gradient_matches_autograd_and_jax(E, k, D, caps):
    """``cg_dispatch_with_grad`` (the plain forward on the CPU) gives the
    same outputs as ``ref_cg_dispatch`` and, for a random cotangent of
    the weights, the gradient to ``gates`` that autograd through
    ``ref_cg_dispatch`` and JAX's autodiff of its ``ref_cg_dispatch``
    give (D = k is the top-k router's dispatch)."""
    G, T = 2, 256
    pref, gates = routing(G, T, E, D, seed=E + D)
    base = max(1, int(1.25 * T * k / E))
    kw = dict(n_experts=E, k=k, block=128)
    if caps == "uniform":
        kw["capacity"] = base
    else:
        kw["capacities"] = tuple(max(1, base - (i % 3)) for i in range(E))
    dw = np.random.default_rng(7).standard_normal((G, T, k)).astype(
        np.float32)
    tg = t(gates, grad=True)
    got = kdispatch.cg_dispatch_with_grad(t(pref), tg, **kw)
    got[2].backward(t(dw))
    tg2 = t(gates, grad=True)
    want = ref.ref_cg_dispatch(t(pref), tg2, **kw)
    want[2].backward(t(dw))
    for x, y in zip(got, want):
        assert torch.equal(x.detach(), y.detach())
    assert not got[0].requires_grad and not got[3].requires_grad
    assert rel(tg.grad, tg2.grad) < 1e-6
    jkw = dict(kw)
    if "capacities" in jkw:
        jkw["capacities"] = jnp.asarray(jkw["capacities"], jnp.float32)
    for g in range(G):
        def wts(x, g=g):
            return jax_ref_cg_dispatch(jnp.asarray(pref[g]), x, **jkw)[2]
        _, vjp = jax.vjp(wts, jnp.asarray(gates[g]))
        (jg,) = vjp(jnp.asarray(dw[g]))
        assert rel(tg.grad[g], jg) < 1e-6
    assert float(tg.grad.abs().sum()) > 0


# ------------------------------------------------------------ the model

def smoke_configs(router="cg", skew=0.0, **kw):
    c = configs.get_smoke_config(ARCH).replace(dtype="float32", **kw)
    j = jconfigs.get_smoke_config(ARCH).replace(dtype="float32", **kw)
    c = c.replace(moe=dataclasses.replace(c.moe, router=router,
                                          capacity_skew=skew))
    j = j.replace(moe=dataclasses.replace(j.moe, router=router,
                                          capacity_skew=skew))
    return c, j


_PARAMS = {}


def jax_params():
    if not _PARAMS:
        _, jcfg = smoke_configs()
        _PARAMS["jax"] = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
    return _PARAMS["jax"]


def torch_params(cfg, jp):
    return convert.moe_params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                       "cpu")


def tokens(B, S, vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def test_remat_full_equals_none_and_routes_the_same_twice(monkeypatch):
    """remat "full" (one checkpoint per layer) gives the loss and every
    gradient of remat "none"; the rematerialised forward dispatches again
    and routes exactly as the first one did."""
    cfg, _ = smoke_configs()
    toks = torch.from_numpy(tokens(2, 64, cfg.vocab))
    calls = []
    real = kdispatch.cg_dispatch

    def recording(*a, **kw):
        out = real(*a, **kw)
        calls.append(out)
        return out

    monkeypatch.setattr(kdispatch, "cg_dispatch", recording)
    out = {}
    for remat in ("none", "full"):
        c = cfg.replace(remat=remat)
        model = torch_params(c, jax_params()).requires_grad_(True)
        calls.clear()
        loss = zoo.loss_fn(model, c, {"tokens": toks})
        n_fwd = len(calls)
        names, leaves = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, leaves)
        out[remat] = (loss.detach(), dict(zip(names, grads)), list(calls),
                      n_fwd)
    (l0, g0, c0, f0), (l1, g1, c1, f1) = out["none"], out["full"]
    assert f0 == f1 == cfg.n_layers
    assert len(c0) == cfg.n_layers and len(c1) == 2 * cfg.n_layers
    for first, again in zip(c1[:cfg.n_layers], c1[cfg.n_layers:][::-1]):
        for x, y in zip(first, again):
            assert torch.equal(x, y)
    assert torch.equal(l0, l1)
    for name, g in g0.items():
        assert rel(g1[name], g.numpy()) < 1e-6, name
    with pytest.raises(NotImplementedError, match="item 10"):
        zoo.loss_fn(model, cfg.replace(remat="dots"), {"tokens": toks})


def test_zoo_specs_and_unported_training():
    cfg = configs.get_config(ARCH).replace(n_layers=1)
    specs = zoo.param_specs(cfg)
    assert all(p.device.type == "meta" for p in specs.values())
    assert zoo.count_params_specs(specs) == cfg.param_count() \
        == 3_110_088_704
    small, _ = smoke_configs()
    model = zoo.init_params(small, 0, device="cpu")
    assert zoo.count_params_specs(zoo.param_specs(small)) \
        == zoo.count_params(model)
    spec = zoo.input_specs(small, SHAPES["train_4k"])
    assert spec["batch"]["tokens"].shape == (256, 4096)
    spec = zoo.input_specs(small, SHAPES["decode_32k"])
    assert spec["tokens"].shape == (128, 1)
    assert spec["cache"]["k"].shape[2] == 32_768
    for arch in SSM_ARCHS:
        c = configs.get_smoke_config(arch)
        m = zoo.init_params(c, 0, device="cpu")
        loss = zoo.loss_fn(m, c, {"tokens": np.zeros((1, 16), np.int32)})
        assert loss.shape == () and bool(torch.isfinite(loss))


@pytest.mark.parametrize("grad_accum,router,skew", [
    (1, "cg", 0.0), (2, "cg", 3.0), (1, "topk", 3.0), (2, "topk", 0.0)])
def test_train_step_matches_jax(grad_accum, router, skew):
    """Three steps of ``make_train_step`` against
    ``jax.jit(repro.launch.steps.make_train_step(...))`` from the same
    weights on the same batch (4 × 64 tokens): loss, lr, grad_norm
    (1e-5), the routing telemetry (equal), and every weight afterwards:
    max|Δw| ≤ 1e-5·max|w| + 1e-3·Σ lr. AdamW moves an element by about lr
    a step whatever its gradient's size, so where a gradient is as small
    as the two frameworks' rounding difference (~1e-6 of the tensor's
    largest) the move differs by up to lr·δg/(|g| + eps): with eps 1e-8
    a router weight of this case moved 2.1e-5 (8% of Σ lr) apart, which
    says nothing of the port. So eps is 1e-5 here, which bounds that
    amplification at δg/1e-5; measured ≤ 6.7e-7 (the table; the norms'
    scales, which start at 0, 1.3e-7)."""
    cfg, jcfg = smoke_configs(router, skew, grad_accum=grad_accum)
    kw = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10, eps=1e-5)
    jstep = jax.jit(jsteps.make_train_step(jcfg, joptim.AdamWConfig(**kw)))
    step = make_train_step(cfg, optim.AdamWConfig(**kw))
    jp = jax_params()
    model = torch_params(cfg, jp)
    jo, to = joptim.init(jp), optim.init(model)
    batch = tokens(4, 64, cfg.vocab, seed=grad_accum)
    lr_sum = 0.0
    for _ in range(3):
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(batch)})
        model, to, tm = step(model, to, {"tokens": torch.from_numpy(batch)})
        assert set(tm) == set(jm)
        for name in ("loss", "lr", "grad_norm"):
            assert rel(tm[name], jm[name]) < 1e-5, name
        for name in ("moe_drop_frac", "moe_max_load_frac", "moe_load"):
            np.testing.assert_array_equal(tm[name].numpy(),
                                          np.asarray(jm[name]), err_msg=name)
        lr_sum += float(jm["lr"])
    want = torch_params(cfg, jp)
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 want.named_parameters()):
        err = float((p.detach() - q.detach()).abs().max())
        assert err <= 1e-5 * float(q.abs().max()) + 1e-3 * lr_sum, name


@pytest.mark.parametrize("router", ["cg", "topk"])
def test_train_steps_on_the_token_stream_match_jax(router):
    """``chip_smoke.py``'s (t) at the smoke size: five steps, step i on the
    port's ``ShardedTokenPipeline(...).global_batch(i)`` (zipf(1.1), a
    fresh batch each step), with AdamW as (t) has it (peak 3e-4, warm-up
    2, eps 1e-8), in the port and in the reference on the same weights
    and tokens. The losses agree within 1e-5 relative (the driver's
    parity bound, ``tests/test_torch_train_driver.py``: eps 1e-8 lets the
    weights drift apart by more than a step's rounding) and the routing
    telemetry is equal, so the trend of the loss on a stream is the
    reference's, not the port's."""
    from repro_torch.data import PipelineConfig, ShardedTokenPipeline
    cfg, jcfg = smoke_configs(router)
    kw = dict(warmup_steps=2, total_steps=5)
    jstep = jax.jit(jsteps.make_train_step(jcfg, joptim.AdamWConfig(**kw)))
    step = make_train_step(cfg, optim.AdamWConfig(**kw))
    jp = jax_params()
    model = torch_params(cfg, jp)
    jo, to = joptim.init(jp), optim.init(model)
    pipe = ShardedTokenPipeline(PipelineConfig(
        vocab=cfg.vocab, seq_len=64, global_batch=8, n_hosts=4))
    losses = []
    for i in range(5):
        batch = pipe.global_batch(i)
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(batch.numpy())})
        model, to, tm = step(model, to, {"tokens": batch})
        assert rel(tm["loss"], jm["loss"]) < 1e-5, i
        for name in ("moe_drop_frac", "moe_max_load_frac", "moe_load"):
            np.testing.assert_array_equal(tm[name].numpy(),
                                          np.asarray(jm[name]), err_msg=name)
        losses.append((float(tm["loss"]), float(jm["loss"])))
    print(router, "losses (port, reference):", losses)


# ------------------------------------------------- Mamba-2 and zamba2

SSM_ARCHS = ("mamba2-130m", "zamba2-2.7b")
SSM_CONVERT = {"ssm": convert.mamba2_params_from_jax,
               "hybrid": convert.hybrid_params_from_jax}
# per-tensor gradient bounds (the module docstring)
SSM_GRAD_TOL = {"mamba2-130m": 1e-5, "zamba2-2.7b": 3e-5}


def ssm_configs(arch, **kw):
    return (configs.get_smoke_config(arch).replace(dtype="float32", **kw),
            jconfigs.get_smoke_config(arch).replace(dtype="float32", **kw))


def ssm_params(arch):
    if arch not in _PARAMS:
        _, jcfg = ssm_configs(arch)
        _PARAMS[arch] = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
    return _PARAMS[arch]


def ssm_torch(cfg, tree):
    """The port's module of a JAX pytree of weights (or of gradients)."""
    return SSM_CONVERT[cfg.family](jax.tree.map(np.asarray, tree), cfg,
                                   "cpu")


def check_ssm_grads(arch, cfg, jcfg, toks):
    """Loss and every gradient of ``zoo.loss_and_metrics`` against
    ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    jp = ssm_params(arch)
    jl, jg = jax.value_and_grad(lambda p: jzoo.loss_fn(
        p, jcfg, {"tokens": jnp.asarray(toks)}))(jp)
    model = ssm_torch(cfg, jp).requires_grad_(True)
    loss, mm = zoo.loss_and_metrics(model, cfg,
                                    {"tokens": torch.from_numpy(toks)})
    assert mm == {} and loss.shape == ()
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    want = dict(ssm_torch(cfg, jg).named_parameters())
    assert rel(loss, jl) < 1e-5
    for name, g in zip(names, grads):
        assert float(want[name].abs().max()) > 0, name
        assert rel(g, want[name].detach().numpy()) < SSM_GRAD_TOL[arch], \
            name


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("remat,use_pallas", [("none", "auto"),
                                              ("full", "auto"),
                                              ("full", "never")])
def test_ssm_loss_and_grads_match_jax(arch, remat, use_pallas):
    """Both archs' smoke configs on 2 × 64 tokens: the loss (1e-5) and
    every gradient (``SSM_GRAD_TOL``); "auto" trains through the SSD
    scan's explicit backward (``ssd_scan_with_grad``), "never" through
    autograd of ``ssd_chunked``."""
    cfg, jcfg = ssm_configs(arch, remat=remat, use_pallas=use_pallas)
    check_ssm_grads(arch, cfg, jcfg, tokens(2, 64, cfg.vocab))


def test_hybrid_chunked_attention_grads_match_jax():
    """The hybrid past a lowered ``attn_chunk_threshold`` (32, chunks of
    16 on 64 tokens): every shared-attention call takes
    ``chunked_attention``, once in the forward and once in each group's
    recompute (remat "full"), and its rematerialised kv steps give JAX's
    gradients."""
    cfg, jcfg = ssm_configs("zamba2-2.7b", remat="full",
                            attn_chunk_threshold=32, q_chunk=16,
                            kv_chunk=16)
    calls = layers.chunked_attention.calls
    check_ssm_grads("zamba2-2.7b", cfg, jcfg, tokens(2, 64, cfg.vocab))
    n_groups = cfg.n_layers // cfg.shared_attn_every
    assert layers.chunked_attention.calls - calls == 2 * n_groups


@pytest.mark.parametrize("arch,grad_accum", [("mamba2-130m", 2),
                                             ("zamba2-2.7b", 1)])
def test_ssm_train_step_matches_jax(arch, grad_accum):
    """Three steps of ``make_train_step`` (remat "full"; mamba2 with two
    micro-batches, whose metrics are {}) against
    ``jax.jit(repro.launch.steps.make_train_step(...))`` from the same
    weights on 4 × 64 tokens, with the bounds and AdamW eps of
    ``test_train_step_matches_jax``: loss, lr, grad_norm within 1e-5,
    every weight afterwards within 1e-5·max|w| + 1e-3·Σ lr."""
    cfg, jcfg = ssm_configs(arch, remat="full", grad_accum=grad_accum)
    kw = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10, eps=1e-5)
    jstep = jax.jit(jsteps.make_train_step(jcfg, joptim.AdamWConfig(**kw)))
    step = make_train_step(cfg, optim.AdamWConfig(**kw))
    jp = ssm_params(arch)
    model = ssm_torch(cfg, jp)
    jo, to = joptim.init(jp), optim.init(model)
    batch = tokens(4, 64, cfg.vocab, seed=5)
    lr_sum = 0.0
    for _ in range(3):
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(batch)})
        model, to, tm = step(model, to, {"tokens": torch.from_numpy(batch)})
        assert set(tm) == set(jm) == {"loss", "lr", "grad_norm"}
        for name in ("loss", "lr", "grad_norm"):
            assert rel(tm[name], jm[name]) < 1e-5, name
        lr_sum += float(jm["lr"])
    want = ssm_torch(cfg, jp)
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 want.named_parameters()):
        err = float((p.detach() - q.detach()).abs().max())
        assert err <= 1e-5 * float(q.abs().max()) + 1e-3 * lr_sum, name


def test_chip_smoke_ssm_training_rehearses_on_cpu():
    """``chip_smoke.py``'s phase 9 at the smoke size on the CPU: three
    steps of each arch (the hybrid then one more on another batch shape)
    with a falling loss, and the card-against-CPU check run CPU against
    CPU. (On the card the script also requires the launches.)"""
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    dev = torch.device("cpu")
    for arch in SSM_ARCHS:
        long = (1, 64) if arch == "zamba2-2.7b" else None
        out = chip_smoke.ssm_train_path(dev, 0, arch, 2, 64, steps=3,
                                        long=long, smoke=True,
                                        check_launches=False)
        assert [r["step"] for r in out["run"]["steps"]] == [1, 2, 3]
        assert ("long" in out) == (long is not None)
        ref = chip_smoke.train_reference_check(dev, 0, arch)
        assert ref["loss_rel_err"] == 0.0
