"""The port's MoE serving path against the JAX package, on the smoke
configs of both MoE archs: the router (capacity vector, top-k order on
ties, dispatch, aux losses), the MoE FFN, and the model's prefill and
decode from converted parameters, then the serving driver.

Inputs and parameters are made once with numpy / the reference's init
and handed to both packages. Tolerances: in f32 the logits and layer
outputs agree within 1e-5 relative to their largest magnitude (matmuls
and transcendental functions round differently in XLA and torch on the
CPU; measured ~1e-6), and the routing — assignments, slots, loads,
drop fraction, per-expert load and worst utilization — is equal. In
bf16 the two frameworks round products at other places, so the bf16
check only asks for 5e-2 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import model_zoo as jzoo
from repro.models import moe_transformer as jmt
from repro.moe import layer as jlayer
from repro.moe import router as jrouter
from repro_torch import configs, convert
from repro_torch.launch import serve
from repro_torch.models import model_zoo as zoo
from repro_torch.models import moe_transformer as mt
from repro_torch.models.lm_common import embed_tokens
from repro_torch.moe import layer, router

ARCHS = tuple(a for a in configs.ARCH_IDS
              if configs.get_config(a).family == "moe")
B, S = 2, 64


def f32_configs(arch, **kw):
    c = configs.get_smoke_config(arch).replace(dtype="float32", **kw)
    j = jconfigs.get_smoke_config(arch).replace(dtype="float32", **kw)
    return c, j


def close(ours, theirs, rtol=1e-5):
    theirs = np.asarray(theirs)
    ours = ours.detach().float().numpy()
    scale = np.abs(theirs).max()
    assert np.abs(ours - theirs).max() <= rtol * scale, (
        np.abs(ours - theirs).max() / scale)


def same(ours, theirs):
    np.testing.assert_array_equal(ours.detach().numpy(), np.asarray(theirs))


_PARAMS = {}


def params(arch, dtype="float32"):
    """The reference's init and its conversion into the port, once."""
    if (arch, dtype) not in _PARAMS:
        jcfg = jconfigs.get_smoke_config(arch).replace(dtype=dtype)
        cfg = configs.get_smoke_config(arch).replace(dtype=dtype)
        jp = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
        tp = convert.moe_params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                         "cpu")
        _PARAMS[arch, dtype] = (jp, tp)
    return _PARAMS[arch, dtype]


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("case", ["rmsnorm", "expand_kv", "rope",
                                  "dense_causal", "dense_full", "decode",
                                  "decode_tensor_len", "kv_update_clamped"])
def test_layer_functions_match_jax(case):
    """The building blocks on random f32 inputs, including the write
    position clamped to the cache as ``dynamic_update_slice`` clamps it
    and a decode length given as a device tensor (as ``decode_step``
    gives it)."""
    from repro.models import layers as jl
    from repro.models import lm_common as jlm
    from repro_torch.models import layers as tl
    from repro_torch.models import lm_common as tlm
    rng = np.random.default_rng(11)
    t = torch.from_numpy

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    if case == "rmsnorm":
        x, scale = r(3, 5, 32), r(32)
        close(tl.rmsnorm(t(x), t(scale)), jl.rmsnorm(x, scale), 1e-6)
        return
    q, k, v = r(2, 12, 4, 16), r(2, 12, 2, 16), r(2, 12, 2, 16)
    if case == "expand_kv":
        same(tl._expand_kv(t(k), 4), jl._expand_kv(k, 4))
    elif case == "rope":
        pos = rng.integers(0, 500, (2, 12)).astype(np.int32)
        close(tl.apply_rope(t(q), t(pos), 1e6),
              jl.apply_rope(q, pos, 1e6), 1e-5)
    elif case in ("dense_causal", "dense_full"):
        causal = case == "dense_causal"
        close(tl.dense_attention(t(q), t(k), t(v), causal=causal),
              jl.dense_attention(q, k, v, causal=causal))
    elif case == "decode":
        close(tl.decode_attention(t(q[:, :1]), t(k), t(v), 9),
              jl.decode_attention(q[:, :1], k, v, 9))
    elif case == "decode_tensor_len":
        close(tl.decode_attention(t(q[:, :1]), t(k), t(v),
                                  torch.tensor(5, dtype=torch.int32)),
              jl.decode_attention(q[:, :1], k, v, np.int32(5)))
    else:
        kc, vc = tlm.update_kv_cache(t(k).clone(), t(v).clone(),
                                     t(k[:, :1] + 1), t(v[:, :1] + 1), 40)
        jkc, jvc = jlm.update_kv_cache(k, v, k[:, :1] + 1, v[:, :1] + 1, 40)
        same(kc, jkc)
        same(vc, jvc)


@pytest.mark.parametrize("option", [dict(sliding_window=8),
                                    dict(use_bias=True),
                                    dict(norm_kind="ln")])
def test_unported_layer_options_say_so(option):
    """Options of the dense families, which neither MoE arch sets, act on
    the MoE as they do in the reference: the model with each option
    (its biases and LayerNorm weights moved by noise so they count)
    matches the JAX MoE in f32 over a prefill of [2, 64] tokens and 4
    greedy decode steps. The prefill honors the window (its logits
    differ from the model's without it); the decode ignores it, as the
    reference's does: from the same cache its logits equal those of the
    model without the window. (The name dates from when the port refused
    these options; it is kept so the test's history stays one.)"""
    arch = "qwen3-moe-235b-a22b"
    cfg, jcfg = f32_configs(arch, **option)
    rng = np.random.default_rng(3)

    def noisy(path, x):
        x = np.asarray(x)
        name = jax.tree_util.keystr(path)
        if any(f"'{n}'" in name for n in ("bias", "bq", "bk", "bv", "bo")) \
                or ("norm" in name and "'scale'" in name):
            x = x + rng.normal(0.0, 0.1, x.shape).astype(x.dtype)
        return x
    tree = jax.tree_util.tree_map_with_path(
        noisy, jzoo.init_params(jcfg, jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.moe_params_from_jax(tree, cfg, "cpu")
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    jl, jc = jax.jit(lambda p, t: jzoo.prefill_step(
        p, jcfg, {"tokens": t}, pad_to=S + 4))(jp, tok)
    tl, tc = zoo.prefill_step(tp, cfg, {"tokens": torch.from_numpy(tok)},
                              pad_to=S + 4)
    close(tl, jl)
    close(tc["k"], jc["k"])
    plain = cfg.replace(sliding_window=None)
    if cfg.sliding_window is not None:
        full, _ = zoo.prefill_step(tp, plain,
                                   {"tokens": torch.from_numpy(tok)})
        assert float((full - tl).abs().max()) > 1e-3 * float(
            tl.abs().max())
    jdec = jax.jit(lambda p, c, t: jzoo.decode_step(p, jcfg, c, t))
    jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    tt = torch.argmax(tl, -1)[:, None].to(torch.int32)
    for _ in range(4):
        same(tt, jt)
        jl, jc = jdec(jp, jc, jt)
        ignored, _ = zoo.decode_step(
            tp, plain, {n: c.clone() for n, c in tc.items()}, tt)
        tl, tc = zoo.decode_step(tp, cfg, tc, tt)
        close(tl, jl)
        assert torch.equal(tl, ignored)
        jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl, -1)[:, None].to(torch.int32)
    same(tt, jt)


# ---------------------------------------------------------------- router

@pytest.mark.parametrize("skew", [0.0, 1.5, 3.0])
@pytest.mark.parametrize("E,k,T", [(8, 2, 64), (16, 4, 128), (128, 8, 8)])
def test_expert_capacity_vector_matches(E, k, T, skew):
    moe = configs.base.MoEConfig(n_experts=E, top_k=k, d_ff_expert=8,
                                 capacity_skew=skew)
    jmoe = jconfigs.base.MoEConfig(n_experts=E, top_k=k, d_ff_expert=8,
                                   capacity_skew=skew)
    assert router.expert_capacity_vector(moe, T) == \
        jrouter.expert_capacity_vector(jmoe, T)
    assert router.uniform_capacity(1.25, T, k, E) == \
        jrouter.uniform_capacity(1.25, T, k, E)


def test_capacity_vector_validation_matches():
    moe = configs.get_smoke_config("phi3.5-moe-42b-a6.6b").moe
    assert router.expert_capacity_vector(dataclasses.replace(
        moe, expert_capacities=(3, 1, 2, 5)), 64) == (3, 1, 2, 5)
    for bad, match in (((1, 2), "entries"), ((1, 0, 1, 1), ">= 1")):
        with pytest.raises(ValueError, match=match):
            router.expert_capacity_vector(dataclasses.replace(
                moe, expert_capacities=bad), 64)
    with pytest.raises(ValueError, match="capacity_skew"):
        router.expert_capacity_vector(dataclasses.replace(
            moe, capacity_skew=-1.0), 64)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("variant", ["cg", "topk", "skew"])
def test_route_matches_jax_on_groups(arch, variant):
    """``route`` on [G, T, D] equals the reference's vmap of ``route``:
    assignments, slots and loads exactly; weights and losses within
    1e-6 relative."""
    kw = {"cg": {}, "topk": {"router": "topk"},
          "skew": {"capacity_skew": 3.0}}[variant]
    cfg, jcfg = f32_configs(arch)
    moe = dataclasses.replace(cfg.moe, **kw)
    jmoe = dataclasses.replace(jcfg.moe, **kw)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, S, cfg.d_model)).astype(np.float32)
    w = (rng.standard_normal((cfg.d_model, moe.n_experts)) * 0.3).astype(
        np.float32)
    ours = router.route(torch.from_numpy(x), torch.from_numpy(w), moe)
    want = jax.vmap(lambda xg: jrouter.route(xg, jnp.asarray(w), jmoe))(
        jnp.asarray(x))
    for f in ("assign", "slot", "load"):
        same(getattr(ours, f), getattr(want, f))
    for f in ("weights", "aux_loss", "z_loss"):
        close(getattr(ours, f), getattr(want, f), rtol=1e-6)
    # one group without the group axis: the reference's signature
    one = router.route(torch.from_numpy(x[1]), torch.from_numpy(w), moe)
    same(one.assign, want.assign[1])


def test_route_breaks_ties_as_jax_top_k():
    """Equal router probabilities keep the lower expert first, as
    ``jax.lax.top_k`` does: a row with four equal maxima (experts 1, 2,
    4, 6) and an all-equal row. ``torch.topk`` orders such ties
    otherwise, so ``route`` uses a stable sort."""
    kw = dict(n_experts=8, top_k=2, d_ff_expert=8, overflow_depth=3,
              capacity_factor=4.0)       # no expert fills: order shows
    moe = configs.base.MoEConfig(**kw)
    jmoe = jconfigs.base.MoEConfig(**kw)
    w = np.zeros((2, 8), np.float32)
    w[0, [1, 2, 4, 6]] = 2.0
    w[0, 7] = 1.0
    x = np.zeros((8, 2), np.float32)
    x[:4, 0] = 1.0                     # tokens 0-3: the four-way tie
    ours = router.route(torch.from_numpy(x), torch.from_numpy(w), moe,
                        block=8)
    want = jrouter.route(jnp.asarray(x), jnp.asarray(w), jmoe, block=8)
    same(ours.assign, want.assign)
    same(ours.slot, want.slot)
    gates = torch.softmax(torch.from_numpy(x @ w), -1)
    assert torch.topk(gates[0], 5).indices.tolist() != [1, 2, 4, 6, 7]
    np.testing.assert_array_equal(ours.assign[:4].numpy(), [[1, 2]] * 4)
    np.testing.assert_array_equal(ours.assign[4:].numpy(), [[0, 1]] * 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch):
    cfg, jcfg = f32_configs(arch)
    jp, tp = params(arch)
    lp = tp.layers[0].moe
    jlp = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    x = np.random.default_rng(3).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        y, m = layer.moe_ffn(torch.from_numpy(x), lp, cfg)
        assert torch.equal(lp(torch.from_numpy(x))[0], y)   # the module
    jy, jm = jlayer.moe_ffn(jnp.asarray(x), jlp, jcfg)
    close(y, jy)
    for name in ("drop_frac", "max_load_frac", "load"):
        same(m[name], jm[name])
    for name in ("aux_loss", "z_loss"):
        close(m[name], jm[name], rtol=1e-6)


# ----------------------------------------------------------------- model

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_jax(arch):
    """prefill_step on [2, 64] tokens, then 4 greedy decode_steps:
    logits within 1e-5 relative, the same greedy tokens, and the
    routing telemetry of the prefill's layers equal."""
    cfg, jcfg = f32_configs(arch)
    jp, tp = params(arch)
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    jl, jc = jax.jit(lambda p, t: jzoo.prefill_step(
        p, jcfg, {"tokens": t}, pad_to=S + 4))(jp, tok)
    tl, tc = zoo.prefill_step(tp, cfg, {"tokens": torch.from_numpy(tok)},
                              pad_to=S + 4)
    close(tl, jl)
    close(tc["k"], jc["k"])
    assert int(tc["pos"]) == int(jc["pos"]) == S
    # routing telemetry over the layers
    x = jnp.take(jp["embed"], tok, axis=0) * jnp.sqrt(jnp.float32(
        jcfg.d_model))
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    _, jaux, jz, jrm = jax.jit(lambda p, x: jmt.hidden_states(
        p, jcfg, x, pos))(jp, x)
    with torch.no_grad():
        _, aux, z, rm = mt.hidden_states(
            tp, cfg, embed_tokens(tp.embed, torch.from_numpy(tok),
                                  cfg.d_model),
            torch.arange(S).expand(B, S))
    for name in ("drop_frac", "load", "max_load_frac"):
        same(rm[name], jrm[name])
    close(aux, jaux, rtol=1e-6)
    close(z, jz, rtol=1e-6)
    # greedy decode
    jdec = jax.jit(lambda p, c, t: jzoo.decode_step(p, jcfg, c, t))
    jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    tt = torch.argmax(tl, -1)[:, None].to(torch.int32)
    for _ in range(4):
        same(tt, jt)
        jl, jc = jdec(jp, jc, jt)
        tl, tc = zoo.decode_step(tp, cfg, tc, tt)
        close(tl, jl)
        jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl, -1)[:, None].to(torch.int32)
    same(tt, jt)
    close(tc["v"], jc["v"])
    assert int(tc["pos"]) == S + 4


def test_prefill_matches_jax_in_bf16():
    """The smoke config in its own dtype, bf16: loose tolerance (see the
    module docstring)."""
    arch = "qwen3-moe-235b-a22b"
    cfg = configs.get_smoke_config(arch)
    jcfg = jconfigs.get_smoke_config(arch)
    jp, tp = params(arch, "bfloat16")
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    jl, _ = jax.jit(lambda p, t: jzoo.prefill_step(
        p, jcfg, {"tokens": t}))(jp, tok)
    tl, tc = zoo.prefill_step(tp, cfg, {"tokens": torch.from_numpy(tok)})
    assert tl.dtype == torch.float32 and tc["k"].dtype == torch.bfloat16
    close(tl, jl, rtol=5e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_surface(arch):
    """Parameter counts, cache shapes and telemetry template equal the
    reference's; whisper-small, the last family to be ported, is in the
    registry and the zoo as in the reference (its config, its parameter
    count)."""
    cfg = configs.get_smoke_config(arch)
    jcfg = jconfigs.get_smoke_config(arch)
    jp, tp = params(arch, "bfloat16")
    total = zoo.count_params(tp)
    assert total == jzoo.count_params(jp) == cfg.param_count()
    assert zoo.active_params(cfg, total) == jzoo.active_params(jcfg, total)
    spec, jspec = zoo.cache_spec(cfg, 4, 32), jzoo.cache_spec(jcfg, 4, 32)
    for name in ("k", "v", "pos"):
        assert tuple(spec[name].shape) == tuple(jspec[name].shape)
        assert str(spec[name].dtype).split(".")[1] == str(jspec[name].dtype)
    cache = zoo.init_cache(cfg, 4, 32, device="cpu")
    assert cache["k"].shape == spec["k"].shape and int(cache["pos"]) == 0
    zeros = zoo.metric_zeros(cfg, device="cpu")
    assert zeros.keys() == jzoo.metric_zeros(jcfg).keys()
    assert zeros["moe_load"].shape == (cfg.moe.n_experts,)
    whisper = configs.get_config("whisper-small")
    jwhisper = jconfigs.get_config("whisper-small")
    assert whisper.__dict__ == jwhisper.__dict__
    assert zoo.count_params_specs(zoo.param_specs(whisper)) \
        == jzoo.count_params_specs(jzoo.param_specs(jwhisper))


def test_random_init_shapes_and_determinism():
    cfg = configs.get_smoke_config("phi3.5-moe-42b-a6.6b")
    a = mt.init_params(cfg, 5, device="cpu")
    b = zoo.init_params(cfg, 5, device="cpu")
    jp, _ = params("phi3.5-moe-42b-a6.6b", "bfloat16")
    named = dict(a.named_parameters())
    assert named["layers.1.moe.w2"].shape == jp["layers"]["moe"]["w2"].shape[1:]
    assert named["embed"].dtype == torch.bfloat16
    assert named["layers.0.moe.router"].dtype == torch.float32
    for (n, x), y in zip(named.items(), b.parameters()):
        assert torch.equal(x, y), n
    logits, _ = zoo.prefill_step(a, cfg, {"tokens": torch.zeros(
        (1, 16), dtype=torch.int32)})
    assert logits.shape == (1, cfg.vocab) and bool(logits.isfinite().all())


# --------------------------------------------------------------- serving

def test_serving_replica_generates_jax_tokens():
    """The port's ``build_replica`` and the reference's give the same
    greedy tokens from the same (converted) f32 parameters."""
    arch = "qwen3-moe-235b-a22b"
    cfg, jcfg = f32_configs(arch)
    jp, tp = params(arch)
    prompts = [5, 17, 200, 3, 99]
    ours = serve.build_replica(cfg, tp, decode_steps=4)(prompts)
    want = jserve.build_replica(jcfg, jp, decode_steps=4)(prompts)
    np.testing.assert_array_equal(ours, want)
    assert ours.shape == (5, 4)


def test_serve_driver_serves_every_request_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b
    --device cpu`` at the smoke
    size with a slow replica: every request is served once and gets its
    decode_steps tokens."""
    out = serve.main(["--arch", "qwen3-moe-235b-a22b", "--device", "cpu",
                      "--hetero", "--requests", "24", "--decode-steps", "3"])
    assert "served 24 requests" in capsys.readouterr().out
    eng = out["engine"]
    assert out["served"] == eng.submitted == 24
    assert sum(r.served for r in eng.replicas) == 24 and eng.in_flight == 0
    assert sorted(out["outputs"]) == list(range(24))
    vocab = configs.get_smoke_config("qwen3-moe-235b-a22b").vocab
    for ids in out["outputs"].values():
        assert ids.shape == (3,) and 0 <= ids.min() and ids.max() < vocab


def test_chip_smoke_moe_phase_rehearses_on_cpu():
    """``chip_smoke.py``'s phase 6 at the smoke size with the plain
    dispatch: both routers run prefill and decode, CG drops no more than
    top-k, the serving engine serves all 64 requests, and the
    card-vs-CPU reference check runs (here CPU against CPU); phase 3's
    dispatch grid runs through the same checks."""
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    dev = torch.device("cpu")
    out = chip_smoke.moe_path(dev, 0, n_layers=None, batch=2, seq=64,
                              decode_steps=4, smoke=True,
                              check_launches=False)
    assert [r["router"] for r in out["runs"]] == ["cg", "topk"]
    assert out["runs"][0]["drop_frac"] <= out["runs"][1]["drop_frac"]
    assert out["serving"]["per_replica"] and sum(
        out["serving"]["per_replica"]) == 64
    assert chip_smoke.moe_reference_check(dev, 0)["max_rel_err"] == 0.0
    assert len(chip_smoke.dispatch_grid()) == 26
    # bids: a token that never fills its k slots bids at all D ranks, one
    # that does stops at the rank of its k-th slot
    pref, _ = chip_smoke.dispatch_inputs(2, 128, 16, 6, 1.0, dev, 0)
    none = torch.full((2, 128, 2), -1, dtype=torch.int32)
    assert chip_smoke.dispatch_bids(pref, none, 2) == 2 * 128 * 6
    assert chip_smoke.dispatch_bids(pref, pref[..., :2], 2) == 2 * 128 * 2
