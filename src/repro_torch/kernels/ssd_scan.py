"""Wrapper of the hand-written CUDA kernel of the Mamba-2 SSD chunked scan
(``csrc/ssd_scan.cu``): the port of the Pallas kernel
``repro/kernels/ssd_scan.py::ssd_scan``.

A CUDA tensor always goes to the kernel, which launches on the current
stream; a CPU tensor goes to the plain torch version
``models.mamba2.ssd_chunked`` (the CPU has no kernel). Unlike the Pallas
kernel, this one can also return the final [B, H, P, N] state, so the
prefill (the reference's ``ssd_chunked(return_state=True)``) and the
stateless forward (the reference's ``ssd_scan``) share it. The wrapper
counts its kernel launches in ``ssd_scan.launches``, a plain integer.
"""
from __future__ import annotations

import functools

import torch

from . import build
from .build import I as _I, P as _P
from .build import check, raise_on

# dynamic shared memory a CTA may take on the card (227 KB)
_SMEM_LIMIT = 232_448
_TQ = 32                       # rows of the weight tile (kTQ in the source)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    """The kernel's library, built at first use, with a typed entry
    point."""
    lib = build.load("ssd_scan")
    lib.ssd_scan_launch.argtypes = [_P] * 7 + [_I] * 8 + [_P]
    lib.ssd_scan_launch.restype = _I
    return lib


def smem_bytes(P: int, N: int, Q: int) -> int:
    """The kernel's shared memory: the state [P, N+1], B and C [Q, N+1],
    x [Q, P], a [32, Q] weight tile and three [Q] vectors, all f32."""
    return 4 * (P * (N + 1) + 2 * Q * (N + 1) + Q * P + _TQ * Q + 3 * Q)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             return_state: bool = False):
    """Chunked SSD scan — the function of ``ref.ref_ssd_scan`` (to float
    tolerance), computed in f32.

    Args:
      x:  [B, L, H, P] f32 or bf16; dt: [B, L, H] (read as f32);
      A:  [H] negative decay rates (read as f32);
      Bm/Cm: [B, L, G, N] in x's dtype, with H % G == 0.
      chunk: Q; L must be a multiple of it (the models pass
        ``pick_chunk(L, cfg.ssm.chunk)``).
    Returns y [B, L, H, P] in x's dtype, or (y, h_final [B, H, P, N] f32)
    with ``return_state``.
    """
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = chunk
    if Q < 1 or L % Q or H % G:
        raise ValueError(f"ssd_scan: L={L} must be a multiple of chunk={Q} "
                         f"and H={H} of G={G}")
    if not x.is_cuda:
        # imported here: models.mamba2 imports this package
        from repro_torch.models.mamba2 import ssd_chunked
        return ssd_chunked(x, dt, A, Bm, Cm, Q, return_state)
    dev = x.device
    smem = smem_bytes(P, N, Q)
    if x.dtype not in _DTYPES or smem > _SMEM_LIMIT \
            or Bsz * L * H * max(P, N) >= 2**31:
        raise ValueError(
            f"ssd_scan: x must be f32 or bf16 (got {x.dtype}); {smem} bytes "
            f"of shared memory must fit in {_SMEM_LIMIT}")
    dt = dt.to(torch.float32).contiguous()
    A = A.to(torch.float32).contiguous()
    check(x, "x", x.dtype, (Bsz, L, H, P), dev)
    check(dt, "dt", torch.float32, (Bsz, L, H), dev)
    check(A, "A", torch.float32, (H,), dev)
    check(Bm, "Bm", x.dtype, (Bsz, L, G, N), dev)
    check(Cm, "Cm", x.dtype, (Bsz, L, G, N), dev)
    y = torch.empty_like(x)
    h = (torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
         if return_state else None)
    if Bsz * H * L:
        err = _lib().ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), 0 if h is None else h.data_ptr(),
            Bsz, L, H, P, G, N, Q, _DTYPES[x.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
        raise_on(err, "ssd_scan")
        ssd_scan.launches += 1
    elif h is not None:
        h.zero_()
    return (y, h) if return_state else y


ssd_scan.launches = 0
