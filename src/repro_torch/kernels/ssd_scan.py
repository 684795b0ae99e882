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

# dynamic shared memory a CTA may take on the card (227 KB), and what an
# SM has for its CTAs (228 KB, 1 KB of it reserved per CTA)
_SMEM_LIMIT = 232_448
_SM_SMEM = 233_472
_TQ = 32                       # rows of the f32 kernel's weight tile (kTQ)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 kernel: 4 warps; chunks of at most 128 rows, at most 64 state
# rows (one 16-row block a warp), N padded to one of its templates
_TC_WARPS = 4
_TC_MAX_Q, _TC_MAX_P, _TC_N = 128, 64, (16, 32, 64, 128)


@functools.cache
def _lib():
    """The kernel's library, built at first use, with a typed entry
    point."""
    lib = build.load("ssd_scan")
    lib.ssd_scan_launch.argtypes = [_P] * 7 + [_I] * 9 + [_P]
    lib.ssd_scan_launch.restype = _I
    lib.ssd_scan_resident_ctas.argtypes = [_I] * 4
    lib.ssd_scan_resident_ctas.restype = _I
    return lib


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def smem_bytes(P: int, N: int, Q: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of one CTA, in bytes (the launcher refuses
    another sum). bf16, the tensor-core kernel, with Q, P and N padded to
    multiples of 16: the chunk's x [Q, P], B and C [Q, N], the state's hi
    and lo bf16 copies [P, N], and the chunk's dt and cumsum [Q] in f32.
    f32, the FMA kernel: the state [P, N+1], B and C [Q, N+1], x [Q, P],
    a [32, Q] weight tile and three [Q] vectors, all f32."""
    if dtype == torch.float32:
        return 4 * (P * (N + 1) + 2 * Q * (N + 1) + Q * P + _TQ * Q + 3 * Q)
    Qp, Pp, Np = _round16(Q), _round16(P), _round16(N)
    return 2 * Qp * Pp + 2 * 2 * Qp * Np + 2 * 2 * Pp * Np + 2 * 4 * Qp


def tc_takes(P: int, N: int, Q: int) -> bool:
    """Whether the bf16 (tensor-core) kernel takes these sizes: P and N
    multiples of 8, P at most 64, N padded to 16 one of its templates
    (16, 32, 64, 128), chunks of at most 128."""
    return (P % 8 == 0 and N % 8 == 0 and _round16(Q) <= _TC_MAX_Q
            and _round16(P) <= _TC_MAX_P and _round16(N) in _TC_N)


def ctas_per_sm(P: int, N: int, Q: int, dtype=torch.bfloat16) -> int:
    """CTAs of one launch that an SM holds at once, by shared memory and
    threads (2,048 an SM; 32 a warp, 4 warps a CTA in bf16, 8 in f32)."""
    threads = 32 * (_TC_WARPS if dtype == torch.bfloat16 else 8)
    return min(_SM_SMEM // (smem_bytes(P, N, Q, dtype) + 1024),
               2048 // threads)


def resident_ctas(P: int, N: int, Q: int, dtype=torch.bfloat16) -> int:
    """CTAs of the kernel that one SM of the current card holds at once
    for these sizes (the CUDA occupancy calculator: shared memory,
    registers and threads), against ``ctas_per_sm``'s count from shared
    memory and threads alone. Needs the card."""
    return _lib().ssd_scan_resident_ctas(P, N, Q, _DTYPES[dtype])


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             return_state: bool = False):
    """Chunked SSD scan — the function of ``ref.ref_ssd_scan`` (to float
    tolerance), accumulated in f32: in bf16 on the tensor cores, its f32
    operands (the weights, the state, x·coef) as hi + lo bf16 pairs; in
    f32 with f32 FMAs.

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
    if x.dtype not in _DTYPES or Bsz * L * H * max(P, N) >= 2**31:
        raise ValueError(f"ssd_scan: x must be f32 or bf16 (got {x.dtype})")
    smem = smem_bytes(P, N, Q, x.dtype)
    if x.dtype == torch.bfloat16 and not tc_takes(P, N, Q):
        raise ValueError(
            f"ssd_scan: the bf16 kernel takes P, N multiples of 8 with P <= "
            f"{_TC_MAX_P} and N padded to 16 in {_TC_N}, and chunks of at "
            f"most {_TC_MAX_Q}; got P={P} N={N} Q={Q}")
    if smem > _SMEM_LIMIT:
        raise ValueError(f"ssd_scan: {smem} bytes of shared memory must "
                         f"fit in {_SMEM_LIMIT}")
    dt = dt.to(torch.float32).contiguous()
    A = A.to(torch.float32).contiguous()
    check(x, "x", x.dtype, (Bsz, L, H, P), dev)
    check(dt, "dt", torch.float32, (Bsz, L, H), dev)
    check(A, "A", torch.float32, (H,), dev)
    check(Bm, "Bm", x.dtype, (Bsz, L, G, N), dev)
    check(Cm, "Cm", x.dtype, (Bsz, L, G, N), dev)
    # the bf16 kernel copies rows 16 bytes at a time
    x, Bm, Cm = (t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in (x, Bm, Cm))
    y = torch.empty_like(x)
    h = (torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
         if return_state else None)
    if Bsz * H * L:
        err = _lib().ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), 0 if h is None else h.data_ptr(),
            Bsz, L, H, P, G, N, Q, _DTYPES[x.dtype], smem,
            torch.cuda.current_stream(dev).cuda_stream)
        raise_on(err, "ssd_scan")
        ssd_scan.launches += 1
    elif h is not None:
        h.zero_()
    return (y, h) if return_state else y


ssd_scan.launches = 0
