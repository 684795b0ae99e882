"""Device and engine resolution shared by the port's entry points.

* ``resolve_device`` — every entry point takes ``device="cuda"`` by
  default and raises when CUDA is absent; it never falls back to the
  CPU on its own. Callers that want the CPU say so (the tests do).
* ``resolve_engine`` — the user-facing routing-engine knob
  (``partitioners.route``, ``CGConfig.engine``): ``"ref"``/``"jnp"``/
  ``"snapshot"`` are the plain torch snapshot engine, ``"cuda"`` the
  hand-written CUDA kernel, ``"auto"`` follows the tensors' device —
  the kernel for CUDA tensors, the plain engine for CPU tensors.
  ``"strict"`` is the rank-sequential engine (Alg. 1 with the cap held
  inside a block) and follows the device the same way: the plain engine
  (``"strict"``) on the CPU, the kernel (``"strict_cuda"``) on the card.
  ``"strict_ref"`` asks for the plain strict engine on any device, the
  way ``"ref"`` does for the snapshot engine.
* ``use_kernel`` — the models' kernel knob ``cfg.use_pallas`` (the
  reference's name): ``"auto"`` follows the tensors' device the same
  way, ``"never"`` takes the plain torch version anywhere, ``"always"``
  the kernel, and raises on CPU tensors.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "torch engines on the CPU")
    return dev


STRICT_ENGINES = ("strict", "strict_ref", "strict_cuda")


def resolve_engine(engine: str, device) -> str:
    """Map an engine knob to the block engine to run on ``device``:
    ``"snapshot"`` (plain torch) or ``"cuda"`` (its kernel), ``"strict"``
    (plain rank-sequential) or ``"strict_cuda"`` (its kernel)."""
    dev = torch.device(device)
    if engine in ("ref", "jnp", "snapshot"):
        return "snapshot"
    if engine == "auto":
        return "cuda" if dev.type == "cuda" else "snapshot"
    if engine == "strict":
        return "strict_cuda" if dev.type == "cuda" else "strict"
    if engine == "strict_ref":
        return "strict"
    if engine in ("cuda", "strict_cuda"):
        if dev.type != "cuda":
            raise ValueError(f"engine={engine!r} needs CUDA tensors; use "
                             "'auto', 'ref' or 'strict' on the CPU")
        return engine
    if engine == "pallas":
        raise ValueError("engine='pallas' is the TPU kernel of the JAX "
                         "package; the port's kernel engine is 'cuda'")
    raise ValueError(f"unknown engine {engine!r}: expected 'ref' | 'cuda' "
                     "| 'auto' | 'strict' (or the internal 'snapshot', "
                     "'strict_ref', 'strict_cuda')")


def use_kernel(use_pallas: str, device) -> bool:
    """Whether a model op runs its CUDA kernel (True) or its plain torch
    version (False) on tensors on ``device``, by ``cfg.use_pallas``."""
    on_card = torch.device(device).type == "cuda"
    if use_pallas == "auto":
        return on_card
    if use_pallas == "never":
        return False
    if use_pallas == "always":
        if not on_card:
            raise ValueError("use_pallas='always' needs CUDA tensors (the "
                             "kernels have no CPU mode); use 'auto' or "
                             "'never' on the CPU")
        return True
    raise ValueError(f"unknown use_pallas {use_pallas!r}: expected 'auto' "
                     "| 'never' | 'always'")
