"""Device and engine resolution shared by the port's entry points.

* ``resolve_device`` — every entry point takes ``device="cuda"`` by
  default and raises when CUDA is absent; it never falls back to the
  CPU on its own. Callers that want the CPU say so (the tests do).
* ``resolve_engine`` — the user-facing routing-engine knob
  (``partitioners.route``, ``CGConfig.engine``): ``"ref"``/``"jnp"``/
  ``"snapshot"`` are the plain torch snapshot engine, ``"cuda"`` the
  hand-written CUDA kernel, ``"auto"`` follows the tensors' device —
  the kernel for CUDA tensors, the plain engine for CPU tensors.
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


def resolve_engine(engine: str, device) -> str:
    """Map an engine knob to the block engine to run on ``device``:
    ``"snapshot"`` (plain torch) or ``"cuda"`` (the kernel)."""
    dev = torch.device(device)
    if engine in ("ref", "jnp", "snapshot"):
        return "snapshot"
    if engine == "auto":
        return "cuda" if dev.type == "cuda" else "snapshot"
    if engine == "cuda":
        if dev.type != "cuda":
            raise ValueError("engine='cuda' needs CUDA tensors; use "
                             "'auto' or 'ref' on the CPU")
        return "cuda"
    if engine == "pallas":
        raise ValueError("engine='pallas' is the TPU kernel of the JAX "
                         "package; the port's kernel engine is 'cuda'")
    if engine == "strict":
        raise NotImplementedError(
            "engine='strict' (rank-sequential porc_assign) is not ported "
            "yet (ROADMAP Queue 2 item 3)")
    raise ValueError(f"unknown engine {engine!r}: expected 'ref' | 'cuda' "
                     "| 'auto' (or the internal 'snapshot')")
