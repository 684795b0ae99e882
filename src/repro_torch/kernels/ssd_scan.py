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

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

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
    lib.ssd_scan_bwd_tc_launch.argtypes = [_P] * 12 + [_I] * 11 + [_P]
    lib.ssd_scan_bwd_tc_launch.restype = _I
    lib.ssd_scan_bwd_scratch_floats.argtypes = [_I] * 8
    lib.ssd_scan_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.ssd_scan_bwd_resident_ctas.argtypes = [_I] * 4
    lib.ssd_scan_bwd_resident_ctas.restype = _I
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
    y = torch.empty_like(x)
    h = (torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
         if return_state else None)
    if Bsz * H * L:
        torch.ops.repro_torch.ssd_scan(x, dt, A, Bm, Cm, y, h, Q, smem)
    elif h is not None:
        h.zero_()
    return (y, h) if return_state else y


ssd_scan.launches = 0


# each launch as an op of its own, so a fake run (fake tensors have no
# data pointer) takes its fake in its place (``launch.dryrun``); defined
# on the dispatcher directly, with no Python autograd layer on the launch
# path
_OPS = torch.library.Library("repro_torch", "FRAGMENT")
_OPS.define("ssd_scan(Tensor x, Tensor dt, Tensor A, Tensor Bm, Tensor Cm, "
            "Tensor(a!) y, Tensor(b!)? h, int chunk, int smem) -> ()")
_OPS.define("ssd_scan_bwd(Tensor x, Tensor dt, Tensor A, Tensor Bm, "
            "Tensor Cm, Tensor dy, Tensor(a!) dx, Tensor(b!) ddt, "
            "Tensor(c!) dA, Tensor(d!) dBm, Tensor(e!) dCm, "
            "Tensor(f!)[] scratch, int chunk, int tile, int[] smem) -> ()")


def _ssd_scan_op(x, dt, A, Bm, Cm, y, h, chunk, smem):
    """The forward kernel's launch into ``y`` (and ``h``), the buffers
    ``ssd_scan`` allocated."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    # the bf16 kernel copies rows 16 bytes at a time
    x, Bm, Cm = (t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in (x, Bm, Cm))
    err = _lib().ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), 0 if h is None else h.data_ptr(),
        Bsz, L, H, P, G, N, chunk, _DTYPES[x.dtype], smem,
        torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(err, "ssd_scan")
    ssd_scan.launches += 1


_OPS.impl("ssd_scan", _ssd_scan_op, "CUDA")


@torch.library.register_fake("repro_torch::ssd_scan", lib=_OPS)
def _(x, dt, A, Bm, Cm, y, h, chunk, smem):
    return None


def _ssd_flops(x_shape, N: int, chunk: int, backward: bool = False) -> int:
    """The products of the plain scan ``models.mamba2.ssd_chunked``, or of
    its explicit backward ``ssd_chunked_bwd``, as torch's flop counter
    counts them there (2 flops a multiply-add, each [Q, Q] product
    whole). Per chunk and head, the forward: C·B^T [Q, Q] over N, its
    decay-weighted product with x over P, the entering state read (C·h)
    and the state update, each [Q] × P × N. The backward: three [Q, Q]
    products over N (C·B^T, dB, dC), two over P (dy·x^T, dx) and five
    [Q] × P × N (the state and cotangent increments, x·dh, B·dh,
    dy·h0)."""
    Bsz, L, H, P = x_shape
    Q = chunk
    if backward:
        return 2 * Bsz * L * H * (3 * Q * N + 2 * Q * P + 5 * P * N)
    return 2 * Bsz * L * H * (Q * N + Q * P + 2 * P * N)


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _(x, dt, A, Bm, Cm, y, h, chunk, smem, **_):
    return _ssd_flops(x, Bm[3], chunk)


# the f32 backward's tiles: rows or columns of a Q x Q product built at
# once (kBT), the chunk's [Q] vectors (kBwdVecs) and the block sum's slots
_BT, _BWD_VECS, _BWD_WARPS = 32, 10, 8
# the bf16 backward: heads of a group a chunk-body CTA takes (kBwdTile),
# the 16 x 16 tiles a chunk-body warp owns (kSlots); threads of its six
# kernels
_BWD_TILE, _BWD_SLOTS = 8, 9
_BWD_KERNELS = ("increments", "states", "chunk", "group", "ds", "sum")
_BWD_THREADS = dict(increments=32 * _TC_WARPS, states=256,
                    chunk=32 * _TC_WARPS, group=256, ds=128, sum=256)


def _bwd_tc_smem(P: int, N: int, Q: int) -> dict:
    """Dynamic shared memory of the bf16 backward's kernels, in bytes, Q,
    P, N padded to multiples of 16 (the launcher refuses other sums):
    - increments: x, dy [Q, P] and B, C [Q, N] in bf16, four [Q] vectors;
    - chunk (the chunk body): x, dy [Q, P] in bf16; G^T as f32 fragments,
      nine 16 x 16 tiles a warp; a B slab [Q, 32]; the dh slab [P, 32] as
      a hi/lo bf16 pair, or the C slab [Q, 32]; a warp's second row block
      of dx [16, P] in f32; four [Q] vectors and the column sums of M
      [8, Q];
    - group: the larger of x, dy [Q, P] with the dh, h0 slabs [P, 64] as
      hi/lo pairs and Vbar^T [Q, Q] as a hi/lo pair; B, C slabs [Q, 64];
      four [Q] vectors and a slot a warp.
    Slabs are N wide where N is narrower."""
    Qp, Pp, Np = _round16(Q), _round16(P), _round16(N)
    ns, ns4 = min(32, Np), min(64, Np)
    return dict(
        increments=4 * Qp * Pp + 4 * Qp * Np + 16 * Qp,
        chunk=(4 * Qp * Pp + 4 * _TC_WARPS * _BWD_SLOTS * 256 + 2 * Qp * ns
               + max(4 * Pp * ns, 2 * Qp * ns) + 4 * _TC_WARPS * 16 * Pp
               + 16 * Qp + 32 * Qp),
        group=(max(4 * Qp * Pp + 8 * Pp * ns4, 4 * Qp * Qp) + 4 * Qp * ns4
               + 16 * Qp + 32))


def _bwd_takes(P: int, N: int, Q: int) -> None:
    """``ValueError`` where the bf16 kernels do not take the sizes."""
    if not tc_takes(P, N, Q):
        raise ValueError(
            f"ssd_scan_bwd: the bf16 kernels take P, N multiples of 8 with "
            f"P <= {_TC_MAX_P} and N padded to 16 in {_TC_N}, and chunks of "
            f"at most {_TC_MAX_Q}; got P={P} N={N} Q={Q}")


def bwd_plan(Bsz: int, L: int, H: int, P: int, G: int, N: int,
             Q: int) -> dict:
    """The bf16 backward's launch plan at these sizes: the head tile of
    the chunk body (``tile`` heads of a group, ``tiles`` of them a
    group), each kernel's shared memory (``smem``), grid (CTAs) and CTAs
    an SM by shared memory and threads (``ctas_per_sm``), and
    the scratch it allocates in bytes (``scratch``). ``ValueError`` where
    the tensor-core kernels do not take the sizes (``tc_takes``)."""
    _bwd_takes(P, N, Q)
    Qp, Np = _round16(Q), _round16(N)
    rep, nc = H // G, L // Q
    tile = min(rep, _BWD_TILE)
    tiles = -(-rep // tile)
    smem = _bwd_tc_smem(P, N, Q)
    per_bh = -(-(P * N // 4) // 256)
    grid = dict(increments=Bsz * H * nc, states=Bsz * H * per_bh,
                chunk=Bsz * nc * G * tiles,
                group=Bsz * nc * G * tiles * (Np // min(64, Np)),
                ds=-(-(Bsz * H * nc) // 4),
                sum=min(-(-(Bsz * L * G * N * (tiles > 1) + H) // 256),
                        132 * 16))
    ctas = {k: min(_SM_SMEM // (smem.get(k, 0) + 1024),
                   2048 // _BWD_THREADS[k]) for k in _BWD_KERNELS}
    f32, slabs = 4, Np // min(64, Np)
    scratch = dict(states=2 * f32 * Bsz * H * nc * P * N,
                   decay=f32 * Bsz * H * nc,
                   vbar=f32 * Bsz * nc * G * tiles * Qp * Qp,
                   parts=2 * f32 * tiles * Bsz * L * G * N * (tiles > 1),
                   vectors=f32 * Bsz * H * ((3 + slabs) * L + slabs * nc),
                   dA=f32 * Bsz * nc * H)
    return dict(tile=tile, tiles=tiles, smem=smem, grid=grid,
                ctas_per_sm=ctas, scratch=scratch)


def bwd_smem_bytes(P: int, N: int, Q: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of one CTA of the backward, in bytes (the
    launcher refuses another sum): in f32, dh [P, N+1], three tile
    regions each holding a column tile [Q, 33], a row tile [32, Q+1] or
    a side product [32, max(P, N)+1], ten [Q] vectors and eight slots,
    then x and dy [Q, P+1] and B and C [Q, N+1], all f32; where that
    outgrows a CTA's 227 KB, x and dy are read from global memory and
    not staged (``BwdLayout::staged``: mamba2's P 64, N 128, chunk 128).
    In bf16 the largest of the tensor-core kernels' (``bwd_plan``)."""
    if dtype != torch.float32:
        return max(_bwd_tc_smem(P, N, Q).values())
    rs = max(Q * (_BT + 1), _BT * (max(Q, N, P) + 1))
    floats = P * (N + 1) + 3 * rs + _BWD_VECS * Q + _BWD_WARPS
    staged = 4 * floats + 4 * (2 * Q * (P + 1) + 2 * Q * (N + 1))
    if staged <= _SMEM_LIMIT:
        return staged
    return 4 * floats + 4 * 2 * Q * (N + 1)


def _bwd_fits(P: int, N: int, Q: int, dtype) -> int:
    """``bwd_smem_bytes``, or ``ValueError`` where the kernels do not take
    the sizes: in f32 where the CTA outgrows 227 KB, in bf16 outside
    ``tc_takes``."""
    if dtype == torch.bfloat16:
        _bwd_takes(P, N, Q)
    smem = bwd_smem_bytes(P, N, Q, dtype)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"ssd_scan_bwd: {smem} bytes of shared memory "
                         f"(P={P} N={N} Q={Q} {dtype}) must fit in "
                         f"{_SMEM_LIMIT}")
    return smem


def bwd_resident_ctas(P: int, N: int, Q: int, kernel: str = "chunk") -> int:
    """CTAs of one of the bf16 backward's kernels ("increments", "chunk"
    or "group") that one SM of the current card holds at once for these
    sizes (the CUDA occupancy calculator: shared memory, registers and
    threads), against ``bwd_plan``'s ``ctas_per_sm``. Needs the card."""
    return _lib().ssd_scan_bwd_resident_ctas(
        P, N, Q, ("increments", "chunk", "group").index(kernel))


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor, *,
                 chunk: int = 128):
    """The gradient of ``ssd_scan``'s y (from a zero state) to its inputs
    for the cotangent ``dy``: (dx, ddt, dA, dBm, dCm), by the formulas of
    ``models.mamba2.ssd_chunked_bwd``, accumulated in f32. dx, dBm and dCm
    come back in x's dtype, ddt [B, L, H] and dA [H] in f32.

    On CUDA tensors the hand-written kernels, one launch counted a call:
    in bf16 six kernels in the order of ``ssd_chunked_bwd``'s stages (the
    chunks' increments, the states, the chunk body a tile of heads at a
    time, the group products of dB and dC, ds a chunk at a time, a
    fixed-order sum; ``bwd_plan``), on the tensor cores where an operand
    is bf16; in f32 the FMA kernel (``ssd_scan_bwd_kernel``, one CTA
    per (b, h), then ``ssd_bwd_reduce_kernel``); on CPU tensors the plain
    version. Its own refusals (``ValueError``): x f32 or bf16, B, C and
    dy in x's dtype, L a multiple of ``chunk``, H of G; in bf16 the sizes
    of ``tc_takes``, as the forward; in f32 ``bwd_smem_bytes`` within a
    CTA's 227 KB (x and dy left unstaged where they do not fit).
    Scratch, all f32: in bf16 one buffer (``bwd_plan``'s ``scratch``):
    the states and their cotangents [B, H, L/Q, P, N], the tiles' Vbar
    [B, L/Q, G, tiles, Q, Q], the tiles' dB, dC [tiles, B, L, G, N] when
    a group has more heads than a tile, and [B, H, L] vectors for ds; in
    f32 the entering states
    [B, H, L/Q, P, N] and the per-head dB, dC [B, L, H, N]."""
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
    nc = L // Q
    if x.dtype == torch.bfloat16:
        plan = bwd_plan(Bsz, L, H, P, G, N, Q)
        scratch = [torch.empty(sum(plan["scratch"].values()) // 4, **f32)]
        tile = plan["tile"]
        smem = [plan["smem"][k] for k in ("increments", "chunk", "group")]
    else:
        # dB, dC a head [B, L, H, N], dA a (b, h), the entering states
        scratch = [torch.empty((Bsz, L, H, N), **f32),
                   torch.empty((Bsz, L, H, N), **f32),
                   torch.empty((Bsz, H), **f32),
                   torch.empty((Bsz, H, nc, P, N), **f32)]
        tile, smem = 0, [smem]
    torch.ops.repro_torch.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dBm,
                                       dCm, scratch, Q, tile, smem)
    return dx, ddt, dA, dBm, dCm


ssd_scan_bwd.launches = 0


def _ssd_scan_bwd_op(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dBm, dCm, scratch,
                     chunk, tile, smem):
    """The backward kernels' launch into the gradients and the scratch
    that ``ssd_scan_bwd`` allocated (bf16: ``bwd_plan``'s one buffer and
    ``tile``; f32: the per-head dB, dC and dA and the entering states),
    an op of its own as ``repro_torch::ssd_scan`` is."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = chunk
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        # the kernels copy rows 16 bytes at a time
        x, Bm, Cm, dy = (t if t.data_ptr() % 16 == 0 else t.clone()
                         for t in (x, Bm, Cm, dy))
        if _lib().ssd_scan_bwd_scratch_floats(
                Bsz, L, H, P, G, N, Q, tile) != scratch[0].numel():
            raise ValueError("ssd_scan_bwd: the plan's scratch differs from "
                             "the launcher's")
        err = _lib().ssd_scan_bwd_tc_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            dBm.data_ptr(), dCm.data_ptr(), dA.data_ptr(),
            scratch[0].data_ptr(), Bsz, L, H, P, G, N, Q, tile, *smem,
            stream)
    else:
        err = _lib().ssd_scan_bwd_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            dBm.data_ptr(), dCm.data_ptr(), dA.data_ptr(),
            *(t.data_ptr() for t in scratch), Bsz, L, H, P, G, N, Q,
            _DTYPES[x.dtype], smem[0], stream)
    raise_on(err, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1


_OPS.impl("ssd_scan_bwd", _ssd_scan_bwd_op, "CUDA")


@torch.library.register_fake("repro_torch::ssd_scan_bwd", lib=_OPS)
def _(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dBm, dCm, scratch, chunk, tile,
      smem):
    return None


@register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd)
def _(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dBm, dCm, scratch, chunk, tile,
      smem, **_):
    return _ssd_flops(x, Bm[3], chunk, backward=True)


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
