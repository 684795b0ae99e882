"""Sharding rules: weights, optimizer state, batches, caches and
activations to placements on a device mesh (port of
``repro.launch.sharding``).

Strategy, as in the reference: 2-D weight sharding, FSDP over the
in-pod ``data`` axis × tensor/expert parallel over ``model``; batches
over (``pod``, ``data``); MoE experts over ``model`` (EP = TP axis).
A dimension is sharded only where the axes divide it (else it
replicates), so every (arch × shape × mesh) cell places without padding.

A rule returns the reference's per-dimension spec as a tuple: one entry
per tensor dimension, each ``None``, an axis name or a tuple of axis
names (``("pod", "data")``). :func:`to_placements` turns a spec into
DTensor placements, one per mesh dimension (``Shard(d)`` or
``Replicate()``): the counterpart of the reference's ``NamedSharding``.
Every rule takes either kind of mesh (``launch.mesh``): a
``DeviceMesh`` or the shape-only ``ShapeMesh`` of the production shapes.

The port's weights are per layer (``layers.3.moe.w1`` is [E, d, f]),
where the reference stacks them on a leading [L] dimension (zamba2's
mamba layers on two: groups × layers of a group). The rules read the
reference's trailing dimensions: the port's spec of a leaf is the
reference's with the stacked dimensions dropped. A name matches by its
dotted components (``moe``, ``shared``), and every integer component is
one stacked dimension of the reference.

The serving runtime's routing state keeps its placements on the 1-D
``("sources",)`` mesh (``routing_state_specs``):
``kernels.mesh.shard_multisource_state`` cuts a state by them.
"""
from __future__ import annotations

from typing import NamedTuple

from torch.distributed.tensor import Replicate, Shard

from .mesh import data_axes, mesh_shape


def _axes(axes) -> tuple:
    return axes if isinstance(axes, tuple) else (axes,)


def _divisible(dim: int, mesh, axes) -> bool:
    if axes is None:
        return True
    shape = mesh_shape(mesh)
    n = 1
    for a in _axes(axes):
        n *= shape[a]
    return dim % n == 0 and dim >= n


def spec_if_divisible(shape, mesh, wanted) -> tuple:
    """The spec ``wanted`` with every dimension its axes do not divide
    replicated (``None``)."""
    return tuple(axes if _divisible(dim, mesh, axes) else None
                 for dim, axes in zip(shape, wanted))


def to_placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dimension,
    ``Shard(d)`` where tensor dimension d's entry names that axis, else
    ``Replicate()``. A dimension over two axes (``("pod", "data")``) is
    sharded on both mesh dimensions, outer first, as the reference's
    ``PartitionSpec`` orders them. An axis of one device replicates: a
    shard of the whole is the whole, and DTensor refuses to reshape a
    dimension sharded even over one device."""
    sizes = mesh_shape(mesh)
    names = tuple(sizes)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        for a in _axes(axes):
            if sizes[a] > 1:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def spec_is_valid(spec, shape, mesh) -> bool:
    """Every sharded dimension divides by its axes, and no axis is used
    twice."""
    used = [a for axes in spec if axes is not None for a in _axes(axes)]
    return (len(used) == len(set(used))
            and all(_divisible(d, mesh, axes) for d, axes in zip(shape, spec)
                    if axes is not None))


def local_shape(shape, spec, mesh) -> tuple:
    """The shard of a tensor of ``shape`` each device holds under ``spec``
    (every sharded dimension divides)."""
    msh = mesh_shape(mesh)
    out = []
    for dim, axes in zip(shape, spec):
        n = 1
        for a in (() if axes is None else _axes(axes)):
            n *= msh[a]
        out.append(dim // n)
    return tuple(out)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

_MATRIX_RULES: dict[str, tuple] = {
    # name: wanted spec of the trailing dims (without the stacked dims)
    "embed": ("model", "data"),
    "vision_proj": (None, "data"),
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    "w1": ("data", "model"),
    "w3": ("data", "model"),
    "w2": ("model", "data"),
    "router": (None, None),
    "in_proj": ("data", "model"),
    "out_proj": ("model", "data"),
    "conv_w": (None, "model"),
}

_EXPERT_RULES = {
    # MoE stacked experts: E on model (EP), in-dim on data (FSDP)
    "w1": ("model", "data", None),
    "w3": ("model", "data", None),
    "w2": ("model", None, "data"),
}


def _components(name: str) -> tuple[list[str], int]:
    """A weight's dotted name as (its non-integer components, the count
    of integer ones: the reference's stacked dimensions)."""
    parts = name.split(".")
    words = [p for p in parts if not p.isdigit()]
    return words, len(parts) - len(words)


def _expert_leaf(words, nd_ref: int) -> bool:
    return "moe" in words and "shared" not in words and nd_ref >= 3


def _rule_for(name: str, ndim: int) -> tuple | None:
    words, stacked = _components(name)
    leaf = words[-1]
    if _expert_leaf(words, ndim + stacked) and leaf in _EXPERT_RULES:
        want = _EXPERT_RULES[leaf]
    elif leaf in _MATRIX_RULES:
        want = _MATRIX_RULES[leaf]
    else:
        return None      # norms, biases, scalars → replicated
    if ndim < len(want):
        return None
    return (None,) * (ndim - len(want)) + want


def param_spec(name: str, shape, mesh, mode: str = "train") -> tuple:
    """The spec of one weight (dotted ``name``, per-layer ``shape``).

    mode="train": 2-D FSDP("data") × TP("model").
    mode="infer": TP("model") only: the weights stay whole over "data"
    (no per-step FSDP all-gather; decode reads every weight once a step).
    MoE expert stacks keep their EP sharding in both modes.
    mode="replicate": pure data parallel, everything replicated.
    """
    nd = len(shape)
    if mode == "replicate":
        return (None,) * nd
    want = _rule_for(name, nd)
    if want is None:
        return (None,) * nd
    if mode == "infer":
        words, stacked = _components(name)
        if not _expert_leaf(words, nd + stacked):
            want = tuple(None if w == "data" else w for w in want)
    return spec_if_divisible(shape, mesh, want)


def param_specs_tree(params, mesh, mode: str = "train") -> dict:
    """name → spec of every weight of ``params`` (a module, or a dict of
    tensors such as ``zoo.param_specs``' meta tensors)."""
    named = (dict(params.named_parameters())
             if hasattr(params, "named_parameters") else dict(params))
    return {n: param_spec(n, tuple(p.shape), mesh, mode)
            for n, p in named.items()}


class Placement(NamedTuple):
    """A tensor's layout: the mesh and its placements (the counterpart of
    the reference's ``NamedSharding``)."""
    mesh: object
    placements: tuple


def param_shardings(params, mesh, mode: str = "train") -> dict:
    """name → ``Placement`` of every weight."""
    return {n: Placement(mesh, to_placements(s, mesh))
            for n, s in param_specs_tree(params, mesh, mode).items()}


def infer_mode_fits(n_params_total: int, mesh, budget_bytes: float) -> bool:
    """Would TP-only (whole over "data") bf16 weights fit a device's
    ``budget_bytes``? The caller says the budget: it is the device's."""
    return 2.0 * n_params_total / mesh_shape(mesh)["model"] <= budget_bytes


# ---------------------------------------------------------------------------
# Batch / cache rules
# ---------------------------------------------------------------------------

def _dp(mesh, pure_dp: bool) -> tuple:
    dp = data_axes(mesh)
    return dp + ("model",) if pure_dp else dp


def batch_specs(batch: dict, mesh, pure_dp: bool = False) -> dict:
    """Tokens/frames/patches: the batch dimension over (pod, data)
    (and "model" with ``pure_dp``)."""
    dp = _dp(mesh, pure_dp)

    def one(x):
        return spec_if_divisible(tuple(x.shape), mesh,
                                 [dp] + [None] * (x.dim() - 1))
    if not isinstance(batch, dict):
        return one(batch)
    return {k: one(x) for k, x in batch.items()}


_CACHE_KV = ("k", "v", "cross_k", "cross_v", "global_k", "global_v",
             "local_k", "local_v")


def cache_specs(cache: dict, mesh, pure_dp: bool = False) -> dict:
    """KV caches [L, B, S, KV, Dh]: batch on data, seq on model.
    SSM states [L, B, H, P, N]: batch on data, heads on model.
    Conv states [L, B, w, C]: batch on data, channels on model.
    With ``pure_dp`` the batch dimension takes every axis and nothing
    else shards. (The hybrid's caches carry two stacked dimensions, as
    the reference's do; the rules read the trailing ones.)"""
    dp = _dp(mesh, pure_dp)
    out = {}
    for name, x in cache.items():
        shape, nd = tuple(x.shape), x.dim()
        if nd == 0:
            out[name] = ()
        elif pure_dp:
            want = [None] * nd
            want[1 if name in _CACHE_KV + ("h", "conv") else 0] = dp
            out[name] = spec_if_divisible(shape, mesh, want)
        elif name in _CACHE_KV or name == "h":
            out[name] = spec_if_divisible(
                shape, mesh, [None] * (nd - 4) + [dp, "model", None, None])
        elif name == "conv":
            out[name] = spec_if_divisible(
                shape, mesh, [None] * (nd - 3) + [dp, None, "model"])
        else:
            out[name] = (None,) * nd
    return out


# ---------------------------------------------------------------------------
# Activation rules (installed through models.layers.set_act_sharding)
# ---------------------------------------------------------------------------

def act_rules(mesh, pure_dp: bool = False) -> dict:
    """kind → spec of the activations ``models.layers.shard_act`` cuts."""
    dp = data_axes(mesh)
    if pure_dp:
        # batch over every axis; no tensor/seq parallelism anywhere
        dp = dp + ("model",)
        return {
            "btd": (dp, None, None),
            "btf": (dp, None, None),
            "bshd": (dp, None, None, None),
            "bskd": (dp, None, None, None),
            "bcv": (dp, None, None),
            "becd": (dp, None, None, None),
            "vd": (),
            "bv": (dp, None),
            "bhpn": (dp, None, None, None),
        }
    return {
        # sequence parallelism: the inter-layer residual stream (and the
        # saved remat carries with it) shard over ("data", seq×"model")
        "btd": (dp, "model", None),
        "btf": (dp, None, "model"),
        "bshd": (dp, None, "model", None),
        "bskd": (dp, None, None, None),
        "bcv": (dp, None, "model"),
        "becd": (dp, "model", None, None),
        "vd": ("model", "data"),      # embedding table (+ its gradient)
        "bv": (dp, "model"),          # decode-step logits
        "bhpn": (dp, "model", None, None),   # SSD state carry
    }


def scalar_sharding(mesh) -> Placement:
    return Placement(mesh, to_placements((), mesh))


# ---------------------------------------------------------------------------
# Serving-runtime routing state (kernels.mesh source lanes)
# ---------------------------------------------------------------------------

# MultiSourcePorcState field -> placements on a ("sources",) mesh. The
# sketch lanes are listed as in the reference; the mesh refuses them.
_ROUTING_LANE_SPECS = {
    "delta": (Shard(0),),
    "sketch_delta": (Shard(0),),
}


def routing_state_specs(state) -> dict:
    """Placements per ``MultiSourcePorcState`` field on a mesh with a
    ``sources`` axis: lanes sharded, merged views replicated."""
    return {f: _ROUTING_LANE_SPECS.get(f, (Replicate(),))
            for f in type(state)._fields}


def routing_state_shardings(state, mesh):
    """A ``Placement`` per field of ``state`` (None fields stay None)."""
    specs = routing_state_specs(state)
    return type(state)(**{
        f: (None if getattr(state, f) is None else Placement(mesh, specs[f]))
        for f in type(state)._fields})
