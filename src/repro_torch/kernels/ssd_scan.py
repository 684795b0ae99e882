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

Training adds what the Pallas kernel lacks, a gradient:
``ssd_scan_bwd`` (a hand-written CUDA backward in the same source, or
the plain ``models.mamba2.ssd_chunked_bwd`` on CPU tensors; launches in
``ssd_scan_bwd.launches``) and ``ssd_scan_with_grad``, the
``autograd.Function`` whose forward is ``ssd_scan`` and whose backward
is ``ssd_scan_bwd``.
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
    lib.ssd_scan_bwd_launch.argtypes = [_P] * 15 + [_I] * 9 + [_P]
    lib.ssd_scan_bwd_launch.restype = _I
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


# the backward's tiles: rows or columns of a Q x Q product built at once
# (kBT), the chunk's [Q] vectors (kBwdVecs) and the block sum's slots
_BT, _BWD_VECS, _BWD_WARPS = 32, 10, 8


def bwd_smem_bytes(P: int, N: int, Q: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of one CTA of the backward, in bytes (the
    launcher refuses another sum): in f32, dh [P, N+1], three tile
    regions each holding a column tile [Q, 33], a row tile [32, Q+1] or
    a side product [32, max(P, N)+1], ten [Q] vectors and eight slots;
    then x and dy [Q, P+1] and B and C [Q, N+1] in the inputs' dtype."""
    esize = 4 if dtype == torch.float32 else 2
    rs = max(Q * (_BT + 1), _BT * (max(Q, N, P) + 1))
    floats = P * (N + 1) + 3 * rs + _BWD_VECS * Q + _BWD_WARPS
    return 4 * floats + esize * (2 * Q * (P + 1) + 2 * Q * (N + 1))


def _bwd_fits(P: int, N: int, Q: int, dtype) -> int:
    """``bwd_smem_bytes``, or ``ValueError`` where it outgrows a CTA."""
    smem = bwd_smem_bytes(P, N, Q, dtype)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"ssd_scan_bwd: {smem} bytes of shared memory "
                         f"(P={P} N={N} Q={Q} {dtype}) must fit in "
                         f"{_SMEM_LIMIT}")
    return smem


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor, *,
                 chunk: int = 128):
    """The gradient of ``ssd_scan``'s y (from a zero state) to its inputs
    for the cotangent ``dy``: (dx, ddt, dA, dBm, dCm), by the reverse-chunk
    formulas of ``models.mamba2.ssd_chunked_bwd``, accumulated in f32 FMAs.
    dx, dBm and dCm come back in x's dtype, ddt [B, L, H] and dA [H] in
    f32.

    On CUDA tensors the hand-written kernel (``ssd_scan_bwd_kernel``, one
    CTA per (b, h), then ``ssd_bwd_reduce_kernel``, which sums the heads
    of each group in a fixed order); on CPU tensors the plain version.
    Its own refusals (``ValueError``): x f32 or bf16, B, C and dy in x's
    dtype, L a multiple of ``chunk``, H of G, and ``bwd_smem_bytes``
    within a CTA's 227 KB (f32 at mamba2's P 64, N 128 and chunk 128 does
    not fit; bf16 does). Scratch: the entering states [B, H, L/Q, P, N]
    and the per-head dB, dC [B, L, H, N], all f32."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = chunk
    if Q < 1 or L % Q or H % G:
        raise ValueError(f"ssd_scan_bwd: L={L} must be a multiple of "
                         f"chunk={Q} and H={H} of G={G}")
    if not x.is_cuda:
        # imported here: models.mamba2 imports this package
        from repro_torch.models.mamba2 import ssd_chunked_bwd
        return ssd_chunked_bwd(x, dt, A, Bm, Cm, dy, Q)
    dev = x.device
    if x.dtype not in _DTYPES or Bsz * L * H * max(P, N) >= 2**31:
        raise ValueError(f"ssd_scan_bwd: x must be f32 or bf16 (got "
                         f"{x.dtype})")
    smem = _bwd_fits(P, N, Q, x.dtype)
    dt = dt.to(torch.float32).contiguous()
    A = A.to(torch.float32).contiguous()
    dy = dy.contiguous()
    check(x, "x", x.dtype, (Bsz, L, H, P), dev)
    check(dt, "dt", torch.float32, (Bsz, L, H), dev)
    check(A, "A", torch.float32, (H,), dev)
    check(Bm, "Bm", x.dtype, (Bsz, L, G, N), dev)
    check(Cm, "Cm", x.dtype, (Bsz, L, G, N), dev)
    check(dy, "dy", x.dtype, (Bsz, L, H, P), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    ddt = torch.empty((Bsz, L, H), **f32)
    dA = torch.empty(H, **f32)
    dBm, dCm = torch.empty_like(Bm), torch.empty_like(Cm)
    if not Bsz * H * L:
        for t in (dx, ddt, dA, dBm, dCm):
            t.zero_()
        return dx, ddt, dA, dBm, dCm
    dB_part = torch.empty((Bsz, L, H, N), **f32)
    dC_part = torch.empty((Bsz, L, H, N), **f32)
    dA_part = torch.empty((Bsz, H), **f32)
    states = torch.empty((Bsz, H, L // Q, P, N), **f32)
    err = _lib().ssd_scan_bwd_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        dBm.data_ptr(), dCm.data_ptr(), dA.data_ptr(), dB_part.data_ptr(),
        dC_part.data_ptr(), dA_part.data_ptr(), states.data_ptr(),
        Bsz, L, H, P, G, N, Q, _DTYPES[x.dtype], smem,
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA, dBm, dCm


ssd_scan_bwd.launches = 0


class _SSDScan(torch.autograd.Function):
    """y = ``ssd_scan``; the backward ``ssd_scan_bwd`` from the saved
    inputs (the entering states are rebuilt there, not kept)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        if x.is_cuda:
            # refuse a backward that cannot launch before any work is done
            _bwd_fits(x.shape[3], Bm.shape[3], chunk, x.dtype)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        return ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        dx, ddt, dA, dBm, dCm = ssd_scan_bwd(x, dt, A, Bm, Cm,
                                             dy.to(x.dtype), chunk=ctx.chunk)
        return dx, ddt.to(dt.dtype), dA.to(A.dtype), dBm, dCm, None


def ssd_scan_with_grad(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor, *,
                       chunk: int = 128) -> torch.Tensor:
    """``ssd_scan``'s y with a gradient to all five inputs: on CUDA
    tensors the CUDA forward and the CUDA backward, on CPU tensors
    ``ssd_chunked`` and ``ssd_chunked_bwd``. A build or launch failure
    raises, as it does in ``ssd_scan``."""
    return _SSDScan.apply(x, dt, A, Bm, Cm, chunk)
