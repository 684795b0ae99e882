"""The train and serve steps, unplaced and placed on a device mesh (port
of ``repro.launch.steps``).

``make_train_step`` and ``make_serve_step`` run a step eagerly on the
weights' device. ``jit_train_step``, ``jit_prefill_step`` and
``jit_serve_step`` place the same steps on a ``DeviceMesh`` by the rules
of ``launch.sharding``, under the reference's names. PyTorch has no
``jit`` with in/out shardings, so each of them returns what the
reference's does, ``(step_for, param_placements[, opt_placements])``,
and ``step_for(batch)`` (or ``step_for(cache, tokens)``) gives a callable
that

  * installs the activation rules (``install_act_rules``);
  * distributes its inputs by the placements: the weights module's
    parameters become DTensors in place (the counterpart of
    ``donate_argnums``: one copy, updated in place), so do the optimizer
    state's tensors, the batch, the cache;
  * runs the eager step under ``implicit_replication`` (a plain tensor
    the step makes, such as ``arange`` positions or masks, is taken as
    replicated): DTensor's sharding propagation does what GSPMD does in
    the reference, ``local_map`` what ``shard_map`` does (the kernels,
    the sequence-parallel decode);
  * redistributes the outputs to the reference's out placements: logits
    ``[dp, "model"]``, metrics replicated, the cache by
    ``cache_specs``.

On a one-rank mesh every placement covers the whole tensor and the
placed step computes the unplaced one's numbers; what it adds is
DTensor's host cost.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import optim
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model_zoo as zoo
from repro_torch.models.layers import act_sharding, set_act_sharding

from . import sharding as shd
from .mesh import data_axes, enter_mesh, make_smoke_mesh, n_chips

# The weights' share of one H100's 80 GB when ``jit_serve_step`` chooses
# between TP-only ("infer") and 2-D ("train") weights: half the card,
# the other half left to the KV cache and the activations.
H100_WEIGHT_BUDGET = 40e9


def act_rules_for(mesh, pure_dp: bool = False) -> dict:
    """``sharding.act_rules`` with the mesh under ``"_mesh"``, as
    ``models.layers.set_act_sharding`` takes them."""
    return {**shd.act_rules(mesh, pure_dp=pure_dp), "_mesh": mesh}


def install_act_rules(mesh, pure_dp: bool = False):
    set_act_sharding(act_rules_for(mesh, pure_dp))


@contextlib.contextmanager
def smoke_mesh(device):
    """The drivers' mesh for the ``with`` block, as the reference's
    ``train`` and ``main`` set it up: ``make_smoke_mesh``'s one-rank
    ("data", "model") mesh on ``device``, its activation rules installed
    and the mesh entered; the rules before it and no group it started
    after. On one rank every rule is the identity and the tensors stay
    plain: a driver's results and kernel launches are the unplaced
    steps'."""
    mesh = make_smoke_mesh(device=device)
    with enter_mesh(mesh), act_sharding(act_rules_for(mesh)):
        yield mesh


def _replicated(x):
    """A DTensor made whole on every rank (a partial sum summed); a plain
    tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, (Replicate(),) * x.device_mesh.ndim)


def _as_placed(g, p):
    """Gradient ``g`` laid out as its weight ``p``."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _micro_batches(batch: dict, k: int) -> list[dict]:
    """The batch cut into ``k`` micro-batches along its first axis: of a
    plain batch, k contiguous slices of the global batch; of a DTensor
    batch, k slices of each rank's shard (the same samples in all, in
    another grouping)."""
    def cut(x):
        if isinstance(x, DTensor):
            loc = x.to_local()
            loc = loc.reshape(k, loc.shape[0] // k, *loc.shape[1:])
            return [DTensor.from_local(loc[i], x.device_mesh, x.placements,
                                       run_check=False) for i in range(k)]
        x = torch.as_tensor(x)
        return list(x.reshape(k, x.shape[0] // k, *x.shape[1:]))
    cuts = {key: cut(x) for key, x in batch.items()}
    return [{key: c[i] for key, c in cuts.items()} for i in range(k)]


def make_train_step(cfg: ModelConfig, opt_cfg: optim.AdamWConfig):
    """(params, opt_state, batch) → (params, opt_state, metrics).

    ``params`` is the model's weights module, made trainable here
    (``requires_grad_``); ``opt_state`` is ``optim.init(params)``.
    ``cfg.grad_accum`` > 1 splits the global batch into that many
    micro-batches along its first axis and sums their gradients in f32
    (one f32 buffer per weight), averaging the loss and the routing
    telemetry, except ``moe_max_load_frac``, which is a worst case. The
    weights and the optimizer state are updated in place. Metrics:
    ``loss``, ``lr``, ``grad_norm`` and the model's telemetry, as
    tensors on the weights' device. On DTensor weights (``jit_train_
    step``) the loss is summed over the ranks before the backward and
    each gradient laid out as its weight."""
    k = max(1, cfg.grad_accum)

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        leaves = list(named.values())

        def grads_of(b):
            loss, mm = zoo.loss_and_metrics(params, cfg, b)
            loss = _replicated(loss)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [None if g is None else _as_placed(g, p)
                     for g, p in zip(grads, leaves)]
            return loss.detach(), mm, grads

        if k == 1:
            loss, mm, grads = grads_of(batch)
            grads = {n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(named.items(), grads)}
        else:
            gsum = {n: torch.zeros_like(p, dtype=torch.float32)
                    for n, p in named.items()}
            loss, mm = 0.0, None
            for micro in _micro_batches(batch, k):
                l, m, grads = grads_of(micro)
                for (n, _), g in zip(named.items(), grads):
                    if g is not None:
                        gsum[n].add_(g)
                del grads
                loss = loss + l
                m = {key: _replicated(val.detach()) for key, val in m.items()}
                mm = m if mm is None else {
                    key: (torch.maximum(mm[key], m[key])
                          if key == "moe_max_load_frac" else mm[key] + m[key])
                    for key in mm}
            grads = {n: g.div_(k) for n, g in gsum.items()}
            loss = loss / k
            mm = {key: (val if key == "moe_max_load_frac" else val / k)
                  for key, val in mm.items()}
        mm = {key: val.detach() for key, val in mm.items()}
        params, opt_state, om = optim.update(params, grads, opt_state,
                                             opt_cfg)
        return params, opt_state, {"loss": loss, **om, **mm}

    return train_step


def make_serve_step(cfg: ModelConfig):
    """(params, cache, tokens) → (logits, cache)."""

    def serve_step(params, cache, tokens):
        return zoo.decode_step(params, cfg, cache, tokens)

    return serve_step


# ---------------------------------------------------------------------------
# Placed steps
# ---------------------------------------------------------------------------

def _eff_pure_dp(cfg, mesh, batch: int) -> bool:
    """pure_dp only pays off when the batch covers every device."""
    return cfg.pure_dp and batch % n_chips(mesh) == 0


def _place(x, mesh, spec):
    """``x`` as a DTensor laid out by ``spec``: distributed from a plain
    tensor (every rank holds the same whole tensor), redistributed from
    another layout, as it is where it already has this one."""
    pl = shd.to_placements(spec, mesh)
    if isinstance(x, DTensor):
        return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
    return distribute_tensor(torch.as_tensor(x), mesh, pl)


@torch.no_grad()
def place_params(params: nn.Module, placements: dict) -> nn.Module:
    """Lay the weights module's parameters out by ``placements`` (name →
    ``sharding.Placement``), in place: each parameter that is not yet so
    placed is replaced by one holding the DTensor (its ``requires_grad``
    kept)."""
    for name, p in list(params.named_parameters()):
        want = placements[name]
        if isinstance(p, DTensor) and tuple(p.placements) == want.placements:
            continue
        if isinstance(p, DTensor):
            d = p.detach().redistribute(want.mesh, want.placements)
        else:
            d = distribute_tensor(p.detach(), want.mesh, want.placements)
        owner, _, leaf = name.rpartition(".")
        mod = params.get_submodule(owner) if owner else params
        setattr(mod, leaf, nn.Parameter(d, requires_grad=p.requires_grad))
    return params


@torch.no_grad()
def place_opt_state(state: dict, mesh, specs: dict) -> dict:
    """Lay the optimizer state out by ``specs`` (``optim.init_specs``), in
    place of the dict's entries."""
    for part in ("m", "v", "master"):
        for name, x in state[part].items():
            state[part][name] = _place(x, mesh, specs[part][name])
    state["step"] = _place(state["step"], mesh, specs["step"])
    return state


def _place_tree(tree: dict, mesh, specs: dict) -> dict:
    return {k: _place(x, mesh, specs[k]) for k, x in tree.items()}


def _logit_spec(mesh, batch: int, vocab: int, dp: tuple, model) -> tuple:
    return shd.spec_if_divisible((batch, vocab), mesh, [dp, model])


def jit_train_step(cfg: ModelConfig, mesh, opt_cfg=None):
    """The train step placed on ``mesh``: ``(step_for, param placements,
    opt placements)``; ``step_for(batch)`` gives ``run(params, opt_state,
    batch) → (params, opt_state, metrics)`` (module docstring). Weights
    and optimizer state are 2-D ("train") or replicated (``pure_dp``
    where the batch covers every device); metrics come back
    replicated."""
    opt_cfg = opt_cfg or optim.AdamWConfig()
    install_act_rules(mesh, pure_dp=cfg.pure_dp)
    pspecs = zoo.param_specs(cfg)
    step = make_train_step(cfg, opt_cfg)

    def layout(mode):
        specs = shd.param_specs_tree(pspecs, mesh, mode)
        return (shd.param_shardings(pspecs, mesh, mode),
                optim.init_specs(specs, ()))

    mode0 = "replicate" if cfg.pure_dp else "train"
    p_sh0, o_specs0 = layout(mode0)

    def step_for(batch_tree):
        B = next(iter(batch_tree.values())).shape[0]
        eff = _eff_pure_dp(cfg, mesh, B)
        p_sh, o_specs = layout("replicate" if eff else "train")
        b_specs = shd.batch_specs(batch_tree, mesh, pure_dp=eff)

        def run(params, opt_state, batch):
            install_act_rules(mesh, pure_dp=eff)
            place_params(params, p_sh)
            place_opt_state(opt_state, mesh, o_specs)
            batch = _place_tree(batch, mesh, b_specs)
            with implicit_replication():
                params, opt_state, metrics = step(params, opt_state, batch)
                metrics = {k: _place(_replicated(v), mesh, ())
                           for k, v in metrics.items()}
            return params, opt_state, metrics

        return run

    return step_for, p_sh0, o_specs0


def jit_prefill_step(cfg: ModelConfig, mesh, pad_to: int | None = None):
    """Inference prefill placed on ``mesh``: ``(step_for, param
    placements)``; ``step_for(batch)`` gives ``run(params, batch) →
    (logits, cache)``: logits ``[dp, "model"]``, the cache (its sequence
    padded to ``pad_to``) by ``cache_specs``."""
    install_act_rules(mesh, pure_dp=False)
    pspecs = zoo.param_specs(cfg)
    p_sh0 = shd.param_shardings(pspecs, mesh, "train")

    def step_for(batch_tree):
        B = next(iter(batch_tree.values())).shape[0]
        eff = _eff_pure_dp(cfg, mesh, B)
        p_sh = shd.param_shardings(pspecs, mesh,
                                   "replicate" if eff else "train")
        b_specs = shd.batch_specs(batch_tree, mesh, pure_dp=eff)
        logit_spec = _logit_spec(mesh, B, cfg.vocab, data_axes(mesh),
                                 "model")

        def run(params, batch):
            install_act_rules(mesh, pure_dp=eff)
            place_params(params, p_sh)
            batch = _place_tree(batch, mesh, b_specs)
            with implicit_replication():
                logits, cache = zoo.prefill_step(params, cfg, batch,
                                                 pad_to=pad_to)
                cache = _place_tree(cache, mesh, shd.cache_specs(
                    cache, mesh, pure_dp=eff))
            return _place(logits, mesh, logit_spec), cache

        return run

    return step_for, p_sh0


def jit_serve_step(cfg: ModelConfig, mesh,
                   budget_bytes: float = H100_WEIGHT_BUDGET):
    """One decode step placed on ``mesh``: ``(step_for, param
    placements)``; ``step_for(cache, tokens)`` gives ``run(params, cache,
    tokens) → (logits, cache)``. The weights are TP-only ("infer") where
    their bf16 bytes over "model" fit ``budget_bytes`` (the caller's
    device budget; the default is the card's, ``H100_WEIGHT_BUDGET``),
    else 2-D; the cache by ``cache_specs`` (its K/V written in place);
    logits ``[dp, "model"]`` (``[dp + model, None]`` under pure DP)."""
    install_act_rules(mesh, pure_dp=False)
    pspecs = zoo.param_specs(cfg)
    n_total = zoo.count_params(pspecs)
    tp_mode = ("infer" if shd.infer_mode_fits(n_total, mesh, budget_bytes)
               else "train")
    p_sh0 = shd.param_shardings(pspecs, mesh, tp_mode)

    def step_for(cache_tree, token_tree):
        B = token_tree.shape[0]
        eff = _eff_pure_dp(cfg, mesh, B)
        p_sh = shd.param_shardings(pspecs, mesh,
                                   "replicate" if eff else tp_mode)
        c_specs = shd.cache_specs(cache_tree, mesh, pure_dp=eff)
        t_spec = shd.batch_specs(token_tree, mesh, pure_dp=eff)
        dp = data_axes(mesh) + (("model",) if eff else ())
        logit_spec = _logit_spec(mesh, B, cfg.vocab, dp,
                                 None if eff else "model")

        def run(params, cache, tokens):
            install_act_rules(mesh, pure_dp=eff)
            place_params(params, p_sh)
            cache = _place_tree(cache, mesh, c_specs)
            tokens = _place(tokens, mesh, t_spec)
            with implicit_replication():
                logits, cache = zoo.decode_step(params, cfg, cache, tokens)
                cache = _place_tree(cache, mesh, c_specs)
            return _place(logits, mesh, logit_spec), cache

        return run

    return step_for, p_sh0
