"""Carry routing and simulator state between the JAX package and the
port.

The JAX package's state crosses over as nested dicts of numpy arrays
(``to_tree`` makes one from a NamedTuple of either package: any array
that ``numpy.asarray`` takes is a leaf), and comes back the same way.
``porc_state``, ``multisource_state`` and ``cg_state`` turn such a tree
into the port's state on ``device``, heavy-hitter sketch lanes included
— so a run begun in one package continues in the other.
``router_snapshot`` and ``load_router`` do the same for a serving
router's whole routing, delegation and controller state.
``dense_params_from_jax``, ``moe_params_from_jax``,
``mamba2_params_from_jax``, ``hybrid_params_from_jax`` and
``encdec_params_from_jax`` load a model's weights from the JAX pytree,
so both packages compute the same model.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.cg import CGState
from repro_torch.core.controller import ControllerState
from repro_torch.core.delegation import DelegationState, PairQueues
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.ref import MultiSourcePorcState, PorcState

# NamedTuple fields that hold a NamedTuple of their own
_NESTED = {(CGState, "signal_queues"): PairQueues,
           (CGState, "controller"): ControllerState,
           (DelegationState, "queues"): PairQueues}


def to_tree(state) -> dict[str, Any]:
    """A NamedTuple of arrays/tensors (nested NamedTuples allowed) as a
    nested dict of numpy arrays; None stays None."""
    out = {}
    for name, value in state._asdict().items():
        if value is None:
            out[name] = None
        elif hasattr(value, "_asdict"):
            out[name] = to_tree(value)
        elif isinstance(value, torch.Tensor):
            out[name] = value.detach().cpu().numpy()
        else:
            out[name] = np.asarray(value)
    return out


def _from_tree(cls: type[NamedTuple], tree: dict, device: torch.device):
    fields = {}
    for name in cls._fields:
        value = tree.get(name)
        if value is None:           # e.g. the sketch lanes without a policy
            fields[name] = None
        elif (cls, name) in _NESTED:
            fields[name] = _from_tree(_NESTED[(cls, name)], value, device)
        else:
            fields[name] = torch.from_numpy(np.array(value)).to(device)
    return cls(**fields)


def porc_state(tree: dict, device="cuda") -> PorcState:
    """``ref.PorcState`` from a tree of the JAX ``PorcState``."""
    return _from_tree(PorcState, tree, resolve_device(device))


def multisource_state(tree: dict, device="cuda") -> MultiSourcePorcState:
    """``ref.MultiSourcePorcState`` from a tree of the JAX one."""
    return _from_tree(MultiSourcePorcState, tree, resolve_device(device))


def cg_state(tree: dict, device="cuda") -> CGState:
    """``cg.CGState`` (with its ``PairQueues`` and ``ControllerState``)
    from a tree of the JAX ``CGState``."""
    return _from_tree(CGState, tree, resolve_device(device))


def _array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def router_snapshot(router) -> dict[str, Any]:
    """The state of a ``CGRequestRouter`` of either package — routing
    lanes and sketch, owner map, rates, FCFS queues, controller, clocks
    and byte accounting — as a tree of numpy arrays and numbers."""
    ctl = router._controller
    return {
        "routing": to_tree(router._state),
        "delegation": to_tree(router._dstate),
        "rated_load": _array(router._rated_load),
        "routed": int(router._routed),
        "moves": int(router.moves),
        "rebalance_mark": int(router._rebalance_mark),
        "queued_busy": bool(router._queued_busy),
        "queued_idle": bool(router._queued_idle),
        "vw_bytes": (None if router._vw_bytes is None
                     else np.array(router._vw_bytes)),
        "controller": None if ctl is None else to_tree(ctl.state),
    }


def load_router(router, tree: dict) -> None:
    """Load a ``router_snapshot`` tree into a port ``CGRequestRouter``
    built with the same configuration, on the router's device."""
    dev = router._dev
    router._state = _from_tree(MultiSourcePorcState, tree["routing"], dev)
    router._dstate = _from_tree(DelegationState, tree["delegation"], dev)
    router._rated_load = torch.from_numpy(
        np.array(tree["rated_load"])).to(dev)
    router._routed = int(tree["routed"])
    router.moves = int(tree["moves"])
    router._rebalance_mark = int(tree["rebalance_mark"])
    router._queued_busy = bool(tree["queued_busy"])
    router._queued_idle = bool(tree["queued_idle"])
    vb = tree["vw_bytes"]
    router._vw_bytes = None if vb is None else np.array(vb, np.float64)
    if (tree["controller"] is None) != (router._controller is None):
        raise ValueError("the snapshot's controller does not match the "
                         "router's configuration")
    if router._controller is not None:
        router._controller.state = _from_tree(ControllerState,
                                              tree["controller"], dev)


def _tensor(x, device) -> torch.Tensor:
    """A numpy array (bfloat16 ones included, as ``numpy.asarray`` of a
    JAX bf16 array gives them) as a tensor on ``device``."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _load(module: torch.nn.Module, tree: dict, device, index=()):
    """Copy every parameter of ``module`` from the leaf of ``tree`` at its
    dotted name (``attn.wq`` → ``tree["attn"]["wq"]``), taking ``index``
    into the leaf's leading (stacked) axes."""
    for pname, param in module.named_parameters():
        leaf = tree
        for part in pname.split("."):
            leaf = leaf[part]
        leaf = np.asarray(leaf)
        if index:
            leaf = leaf[index]
        param.copy_(_tensor(leaf, device))


def _load_model(model, params_np: dict, device, layer_index):
    """``embed``, ``final_norm`` (a LayerNorm's bias too), the VLM's
    ``vision_proj``, the ``shared`` block and the encoder's ``enc_norm``
    where the model has them, and every layer from the stacked leaves of
    the stack ``layer_index`` names for it, at the index it gives
    (``(stack, index, layer)``). Returns ``model``."""
    with torch.no_grad():
        model.embed.copy_(_tensor(params_np["embed"], device))
        _load(model.final_norm, params_np["final_norm"], device)
        if "vision_proj" in params_np:
            model.vision_proj.copy_(_tensor(params_np["vision_proj"], device))
        for name in ("shared", "enc_norm"):
            if name in params_np:
                _load(getattr(model, name), params_np[name], device)
        for stack, index, layer in layer_index(model):
            _load(layer, params_np[stack], device, index)
    return model


def _flat_layers(model, stack: str = "layers"):
    return ((stack, (i,), layer)
            for i, layer in enumerate(getattr(model, stack)))


def dense_params_from_jax(params_np: dict, cfg, device="cuda"):
    """The port's ``Transformer`` (the dense and VLM families) from the
    reference's parameter pytree (nested dicts of numpy arrays):
    ``embed``, the stacked ``layers/*`` leaves ([L, ...] each, biases and
    LayerNorm shifts included), ``final_norm`` and the VLM's
    ``vision_proj``."""
    from repro_torch.models.transformer import Transformer
    dev = resolve_device(device)
    return _load_model(Transformer(cfg, dev), params_np, dev, _flat_layers)


def moe_params_from_jax(params_np: dict, cfg, device="cuda"):
    """The port's ``MoETransformer`` from the reference's MoE parameter
    pytree (as nested dicts of numpy arrays): ``embed``, the stacked
    ``layers/*`` leaves (one [L, ...] array each) and ``final_norm``."""
    from repro_torch.models.moe_transformer import MoETransformer
    dev = resolve_device(device)
    return _load_model(MoETransformer(cfg, dev), params_np, dev,
                       _flat_layers)


def mamba2_params_from_jax(params_np: dict, cfg, device="cuda"):
    """The port's ``Mamba2`` from the reference's Mamba-2 parameter pytree
    (nested dicts of numpy arrays, bf16 ones included): ``embed``, the
    stacked ``layers/*`` leaves ([L, ...] each) and ``final_norm``."""
    from repro_torch.models.mamba2 import Mamba2
    dev = resolve_device(device)
    return _load_model(Mamba2(cfg, dev), params_np, dev, _flat_layers)


def hybrid_params_from_jax(params_np: dict, cfg, device="cuda"):
    """The port's ``Hybrid`` from the reference's hybrid parameter pytree:
    ``embed``, the ``layers/*`` leaves stacked [n_groups, per_group, ...],
    the ``shared`` block and ``final_norm``."""
    from repro_torch.models.hybrid import Hybrid
    dev = resolve_device(device)
    return _load_model(Hybrid(cfg, dev), params_np, dev, lambda model: (
        ("layers", (g, k), layer) for g, group in enumerate(model.layers)
        for k, layer in enumerate(group)))


def encdec_params_from_jax(params_np: dict, cfg, device="cuda"):
    """The port's ``EncDec`` (whisper) from the reference's
    encoder-decoder parameter pytree: ``embed``, the stacked
    ``enc_layers/*`` and ``dec_layers/*`` leaves ([L, ...] each),
    ``enc_norm`` and ``final_norm``."""
    from repro_torch.models.encdec import EncDec
    dev = resolve_device(device)
    return _load_model(EncDec(cfg, dev), params_np, dev, lambda model: (
        *_flat_layers(model, "enc_layers"),
        *_flat_layers(model, "dec_layers")))
