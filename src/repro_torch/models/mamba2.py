"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) decoder LM,
forward and serving path (port of ``repro.models.mamba2``).

The sequence mixer is the chunked SSD recurrence, in two versions of the
same math:
  * ``ssd_chunked`` — plain torch, the kernel's plain version: it runs on
    the CPU and in the card's checks;
  * ``repro_torch.kernels.ssd_scan`` — the hand-written CUDA kernel (state
    in shared memory across chunks), which on the card serves both the
    stateless forward and the prefill (it also returns the final state).
``cfg.use_pallas`` picks one (``kernels.backend.use_kernel``). Decode
keeps O(1) state: the [H, P, N] SSM state and the conv ring.

Training (``loss_fn``) takes the scan's gradient from
``kernels.ssd_scan.ssd_scan_with_grad``: on the card the CUDA forward
and a hand-written CUDA backward, on the CPU ``ssd_chunked`` and its
explicit backward ``ssd_chunked_bwd``; ``use_pallas="never"`` keeps
autograd through ``ssd_chunked``, which is the reference's own gradient
off a TPU. Each layer runs under ``transformer.remat``.

The weights live in a ``Mamba2`` module: ``embed`` [V, d] (the tied
head), ``layers`` (an ``nn.ModuleList`` of ``MambaLayer``s, where the
reference stacks each leaf on a leading [L] axis and scans) and
``final_norm``, held without gradients until a train step turns them
on.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.kernels.backend import resolve_device, use_kernel

from .layers import _param, as_generator, drawn_param, rmsnorm, torch_dtype
from .lm_common import (Norm, chunked_xent, embed_tokens, last_logits, norm,
                        pick_chunk, shift_labels)
from .transformer import remat


def _dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    d_xbc = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, H, d_xbc


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no linear branch above
    a threshold (``F.softplus`` returns x above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class MambaLayer(nn.Module):
    """One Mamba-2 layer's weights, under the names of the reference's
    ``_layer_init`` dict: ``norm``, ``in_proj`` [d, 2·d_in + 2GN + H],
    ``conv_w`` [d_conv, d_xbc], ``conv_b``, ``A_log``, ``D``, ``dt_bias``
    (f32, [H]), ``ssm_norm`` [d_in] and ``out_proj`` [d_in, d]. Drawn with
    ``key`` (a ``torch.Generator``) as the reference draws them (its
    shapes and scales; not its numbers); without, the drawn ones are left
    uninitialized for a caller to load (``repro_torch.convert``)."""

    def __init__(self, cfg, dtype, device="cuda", key=None):
        super().__init__()
        s, d_in, H, d_xbc = _dims(cfg)
        d = cfg.d_model

        def const(shape, value, dt=torch.float32):
            return _param(torch.full(shape, value, dtype=dt, device=device))

        self.norm = Norm(cfg, dtype, device)
        self.in_proj = drawn_param(key, (d, d_in + d_xbc + H), dtype, device)
        self.conv_w = drawn_param(key, (s.d_conv, d_xbc), dtype, device,
                                  scale=0.5)
        self.conv_b = const((d_xbc,), 0.0, dtype)
        self.A_log = const((H,), 0.0)
        self.D = const((H,), 1.0)
        self.dt_bias = const((H,), -2.0)       # softplus ≈ 0.12
        self.ssm_norm = const((d_in,), 0.0, dtype)
        self.out_proj = drawn_param(key, (d_in, d), dtype, device)


class Mamba2(nn.Module):
    """The model's weights (see the module docstring); with ``key`` drawn
    as the reference's ``init_params`` draws them, without left
    uninitialized for a caller to load."""

    def __init__(self, cfg, device="cuda", key=None):
        super().__init__()
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.dtype)
        self.embed = drawn_param(key, (cfg.vocab, cfg.d_model), dtype, dev,
                                 scale=0.02)
        self.layers = nn.ModuleList(MambaLayer(cfg, dtype, dev, key)
                                    for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg, dtype, dev)


def init_params(cfg, key, device="cuda") -> Mamba2:
    """Random weights from ``key``: a ``torch.Generator`` on ``device``,
    or an int seed for one."""
    dev = resolve_device(device)
    return Mamba2(cfg, dev, key=as_generator(key, dev))


# ---------------------------------------------------------------------------
# Chunked SSD (plain torch) — the math of kernels/ssd_scan
# ---------------------------------------------------------------------------

def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, return_state: bool = False):
    """x [B,L,H,P]; dt [B,L,H]; A [H]; Bm/Cm [B,L,G,N] → y [B,L,H,P]
    (+ final state [B,H,P,N] f32 when return_state), in f32 (f64 for
    f64 inputs) and cast back to x's dtype. L must be a multiple of
    ``chunk``.

    B/C stay in group form [.., G, N] and expand to heads inside each
    chunk's step, as in the reference. Counts its calls on CUDA tensors
    in ``ssd_chunked.tally["cuda_calls"]``: the kernel's checks make
    them; a main path on the card must make none.
    """
    ssd_chunked.tally["cuda_calls"] += x.device.type == "cuda"
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    nc = L // chunk
    f32 = _acc_dtype(x)

    def rs(a):
        return a.to(f32).reshape(Bsz, nc, chunk, *a.shape[2:])

    xs, dts, bs, cs = rs(x), rs(dt), rs(Bm), rs(Cm)
    A = A.to(f32)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    h = torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
    ys = []
    for c in range(nc):
        xc, dtc = xs[:, c], dts[:, c]                # [B,Q,H,P], [B,Q,H]
        bch = torch.repeat_interleave(bs[:, c], rep, dim=2)  # local head expand
        cch = torch.repeat_interleave(cs[:, c], rep, dim=2)
        da = dtc * A[None, None, :]                  # [B,Q,H]
        s = torch.cumsum(da, dim=1)
        g = torch.einsum("bqhn,bkhn->bhqk", cch, bch)
        diff = (s[:, :, None, :] - s[:, None, :, :]).movedim(-1, 1)  # [B,H,Q,K]
        w = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
        w = w * g * dtc.movedim(-1, 1)[:, :, None, :]
        y = torch.einsum("bhqk,bkhp->bqhp", w, xc)
        # inter-chunk
        sm = s.movedim(-1, 1)                        # [B,H,Q]
        y = y + (torch.exp(sm)[..., None]
                 * torch.einsum("bqhn,bhpn->bhqp", cch, h)).movedim(1, 2)
        coef = dtc * torch.exp(s[:, -1:, :] - s)     # [B,Q,H]
        h = torch.exp(sm[:, :, -1])[..., None, None] * h + torch.einsum(
            "bqhp,bqhn->bhpn", xc * coef[..., None], bch)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(Bsz, L, H, P).to(x.dtype)
    if return_state:
        return y, h
    return y


ssd_chunked.tally = dict(cuda_calls=0)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """What the plain scans accumulate in: f32, or f64 for f64 inputs
    (``torch.autograd.gradcheck``)."""
    return torch.promote_types(x.dtype, torch.float32)


def ssd_chunked_bwd(x, dt, A, Bm, Cm, dy, chunk: int):
    """The gradient of ``ssd_chunked``'s y (from a zero initial state) to
    its five inputs for the cotangent ``dy`` [B,L,H,P]: (dx, ddt, dA, dBm,
    dCm), by the explicit reverse-chunk formulas the CUDA backward
    (``kernels/ssd_scan.py::ssd_scan_bwd``) runs, not by autograd.

    Per chunk, with a = A[h], s = cumsum(dt·a) (inclusive), s_Q its last
    entry and h0 the state entering the chunk, the forward is
      y_i = Σ_{j≤i} e^{s_i−s_j} dt_j (C_i·B_j) x_j + e^{s_i} C_i·h0ᵀ
      h1  = e^{s_Q} h0 + Σ_j e^{s_Q−s_j} dt_j x_j ⊗ B_j.
    A pass over the chunks in order rebuilds each entering state; a pass
    in reverse carries dh = ∂/∂h1 [P, N] (zero after the last chunk) and
    forms, with G_ij = C_i·B_j, D_ij = dy_i·x_j, E_ij = [j≤i] e^{s_i−s_j}:
      dx_j  = Σ_i E_ij dt_j G_ij dy_i + e^{s_Q−s_j} dt_j (B_j dhᵀ)
      dB_j  = Σ_i E_ij dt_j D_ij C_i + e^{s_Q−s_j} dt_j (x_j dh)
      dC_i  = Σ_j E_ij dt_j D_ij B_j + e^{s_i} (dy_i h0)
      ds_i  = Σ_j T_ij − dt_i m_i + e^{s_i} r_i − dt_i u_i
              (+ e^{s_Q}⟨h0, dh⟩ + Σ_j dt_j u_j at i = Q−1)
    where T_ij = E_ij dt_j G_ij D_ij, m_j = Σ_i E_ij G_ij D_ij,
    r_i = C_i·(dy_i h0) and u_j = e^{s_Q−s_j} B_j·(x_j dh); then
    dda = the reverse cumsum of ds, ddt = a·dda + m + u, dA_h += Σ dt·dda,
    and dh ← e^{s_Q} dh + Σ_i e^{s_i} dy_i ⊗ C_i. dB and dC are summed
    over the heads of each group (H % G == 0).

    The work runs in the order of the CUDA kernels: (a) for every chunk at
    once, the state increment S_c = Σ_j e^{s_Q−s_j} dt_j x_j ⊗ B_j and the
    cotangent increment Λ_c = Σ_i e^{s_i} dy_i ⊗ C_i; (b) one short loop
    over the chunks, elementwise on [P, N]: h0_{c+1} = e^{s_Q,c} h0_c + S_c
    in order and dh_c = e^{s_Q,c+1} dh_{c+1} + Λ_{c+1} in reverse; (c)
    every chunk's local terms above, batched over the chunks; (d) dB and
    dC summed over the heads of each group, dA over batch and chunks.

    Accumulates in f32 (f64 for f64 inputs); dx, dBm and dCm come back in
    their inputs' dtypes, ddt and dA in the accumulation dtype. Counts its
    calls on CUDA tensors in ``ssd_chunked.tally["cuda_calls"]``, as
    ``ssd_chunked`` does.
    """
    ssd_chunked.tally["cuda_calls"] += x.device.type == "cuda"
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    nc = L // chunk
    acc = _acc_dtype(x)

    def rs(a):
        return a.to(acc).reshape(Bsz, nc, chunk, *a.shape[2:])

    xs, dts, dys = rs(x), rs(dt), rs(dy)                 # [B,nc,Q,H,..]
    bs = torch.repeat_interleave(rs(Bm), rep, dim=3)     # [B,nc,Q,H,N]
    cs = torch.repeat_interleave(rs(Cm), rep, dim=3)
    A = A.to(acc)
    s = torch.cumsum(dts * A, dim=2)                     # [B,nc,Q,H]
    decay = torch.exp(s[:, :, -1])                       # e^{s_Q} [B,nc,H]
    ex = torch.exp(s[:, :, -1:] - s)                     # e^{s_Q−s_j}
    coef = dts * ex
    es = torch.exp(s)

    # (a) the chunks' state and cotangent increments [B,nc,H,P,N]
    incr = torch.einsum("bcqhp,bcqhn->bchpn", xs * coef[..., None], bs)
    lam = torch.einsum("bcqhp,bcqhn->bchpn", dys * es[..., None], cs)

    # (b) the entering states in order, their cotangents in reverse
    h0s, dhs = [torch.zeros_like(incr[:, 0])], [torch.zeros_like(lam[:, 0])]
    for c in range(1, nc):
        h0s.append(decay[:, c - 1, :, None, None] * h0s[-1] + incr[:, c - 1])
        dhs.append(decay[:, nc - c, :, None, None] * dhs[-1]
                   + lam[:, nc - c])
    h0 = torch.stack(h0s, dim=1)                         # [B,nc,H,P,N]
    dh = torch.stack(dhs[::-1], dim=1)

    # (c) every chunk's local terms
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    sm = s.movedim(3, 2)                                 # [B,nc,H,Q]
    diff = sm[..., :, None] - sm[..., None, :]           # [..,Q(i),Q(j)]
    E = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    Gm = torch.einsum("bcihn,bcjhn->bchij", cs, bs)
    Dm = torch.einsum("bcihp,bcjhp->bchij", dys, xs)
    dtj = dts.movedim(3, 2)[..., None, :]                # [B,nc,H,1,Q(j)]
    V = E * dtj * Dm
    Mm = E * Gm * Dm
    XD = torch.einsum("bcjhp,bchpn->bcjhn", xs, dh)
    BD = torch.einsum("bcjhn,bchpn->bcjhp", bs, dh)
    DH = torch.einsum("bcihp,bchpn->bcihn", dys, h0)
    dx = torch.einsum("bchij,bcihp->bcjhp", E * dtj * Gm, dys) \
        + coef[..., None] * BD
    dB = torch.einsum("bchij,bcihn->bcjhn", V, cs) + coef[..., None] * XD
    dC = torch.einsum("bchij,bcjhn->bcihn", V, bs) + es[..., None] * DH
    u = ex * (bs * XD).sum(-1)                           # [B,nc,Q,H]
    r = (cs * DH).sum(-1)
    row_t = (Mm * dtj).sum(-1).movedim(2, -1)            # Σ_j T_ij
    m = Mm.sum(-2).movedim(2, -1)                        # Σ_i E G D
    ds = row_t - dts * m + es * r - dts * u
    ds[:, :, -1] += decay * (h0 * dh).sum((-1, -2)) + (dts * u).sum(2)
    dda = torch.flip(torch.cumsum(torch.flip(ds, [2]), 2), [2])
    ddt = A * dda + m + u
    dA_part = (dts * dda).sum(2)                         # [B,nc,H]

    # (d) the heads of each group, and dA over batch and chunks
    def groups(a, like):
        return a.reshape(Bsz, L, G, rep, N).sum(3).to(like.dtype)

    return (dx.reshape(Bsz, L, H, P).to(x.dtype), ddt.reshape(Bsz, L, H),
            dA_part.sum((0, 1)), groups(dB, Bm), groups(dC, Cm))


def _ssd(x, dt, A, Bm, Cm, cfg, return_state: bool = False):
    """The SSD scan by ``cfg.use_pallas``: the CUDA kernel or the plain
    ``ssd_chunked``, at the chunk ``pick_chunk(L, cfg.ssm.chunk)`` (so a
    length that 128 does not divide still runs). Under autograd, when an
    input needs a gradient, "auto" and "always" take
    ``ssd_scan_with_grad``, which follows the device (the CUDA kernels,
    or ``ssd_chunked`` and ``ssd_chunked_bwd`` on the CPU); "never"
    keeps autograd through ``ssd_chunked``."""
    chunk = pick_chunk(x.shape[1], cfg.ssm.chunk)
    kernel = use_kernel(cfg.use_pallas, x.device)
    if (not return_state and cfg.use_pallas != "never"
            and torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, dt, A, Bm, Cm))):
        return kops.ssd_scan_with_grad(x.contiguous(), dt, A,
                                       Bm.contiguous(), Cm.contiguous(),
                                       chunk=chunk)
    if kernel:
        return kops.ssd_scan(x.contiguous(), dt, A, Bm.contiguous(),
                             Cm.contiguous(), chunk=chunk,
                             return_state=return_state)
    return ssd_chunked(x, dt, A, Bm, Cm, chunk, return_state)


# ---------------------------------------------------------------------------
# Block forward (prefill)
# ---------------------------------------------------------------------------

def mamba_block(x, lp: MambaLayer, cfg, return_state: bool = False):
    """x: [B, S, D] → [B, S, D] (residual NOT included).

    return_state: also return (conv_tail [B, d_conv-1, d_xbc], h_final
    [B, H, P, N]) for decode continuation after prefill; on the card the
    kernel returns h_final too.
    """
    s, d_in, H, d_xbc = _dims(cfg)
    B, S, D = x.shape
    GN = s.n_groups * s.d_state
    zxbcdt = x @ lp.in_proj
    z, xbc_raw, dt = torch.split(zxbcdt, [d_in, d_xbc, H], dim=-1)
    # causal depthwise conv over xbc, window d_conv, in the model's dtype
    pads = xbc_raw.new_zeros((B, s.d_conv - 1, d_xbc))
    xp = torch.cat([pads, xbc_raw], dim=1)
    xbc = sum(xp[:, i:i + S] * lp.conv_w[i][None, None]
              for i in range(s.d_conv)) + lp.conv_b
    xbc = F.silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [d_in, GN, GN], dim=-1)
    xh = xs.reshape(B, S, H, s.head_dim)
    Bm = Bm.reshape(B, S, s.n_groups, s.d_state)
    Cm = Cm.reshape(B, S, s.n_groups, s.d_state)
    dtv = _softplus(dt.to(torch.float32) + lp.dt_bias)
    A = -torch.exp(lp.A_log)
    if return_state:
        y, h_fin = _ssd(xh, dtv, A, Bm, Cm, cfg, return_state=True)
    else:
        y = _ssd(xh, dtv, A, Bm, Cm, cfg)
    y = y + lp.D[None, None, :, None].to(y.dtype) * xh
    y = y.reshape(B, S, d_in)
    y = rmsnorm(y * F.silu(z), lp.ssm_norm)
    out = y @ lp.out_proj
    if return_state:
        return out, (xbc_raw[:, S - (s.d_conv - 1):], h_fin)
    return out


def hidden_states(params: Mamba2, cfg, x):
    """The layer stack, each layer under ``transformer.remat``."""
    def body(x, lp):
        return x + mamba_block(norm(x, lp.norm, cfg), lp, cfg)

    body = remat(body, cfg)
    for lp in params.layers:
        x = body(x, lp)
    return norm(x, params.final_norm, cfg)


def loss_fn(params: Mamba2, cfg, batch):
    """Next-token loss of ``batch["tokens"]`` [B, S]: the chunked
    cross-entropy of the final hidden states against the tied table."""
    embed = params.embed
    tokens = torch.as_tensor(batch["tokens"], device=embed.device)
    x = embed_tokens(embed, tokens, cfg.d_model)
    x = hidden_states(params, cfg, x)
    return chunked_xent(x, embed, shift_labels(tokens))


@torch.no_grad()
def prefill_step(params: Mamba2, cfg, batch,
                 pad_to: int | None = None):  # noqa: ARG001 (O(1) cache)
    """Prefill: forward over the prompt, returning last logits [B, V] f32
    and the O(1) recurrent state (conv tails + SSM states) as the decode
    cache. ``batch["tokens"]`` [B, S] int."""
    embed = params.embed
    tokens = torch.as_tensor(batch["tokens"], device=embed.device)
    x = embed_tokens(embed, tokens, cfg.d_model)
    convs, hs = [], []
    for lp in params.layers:
        y, (conv, h) = mamba_block(norm(x, lp.norm, cfg), lp, cfg,
                                   return_state=True)
        x = x + y
        convs.append(conv)
        hs.append(h)
    x = norm(x, params.final_norm, cfg)
    logits = last_logits(x[:, -1], embed)
    S = tokens.shape[1]
    return logits, {"conv": torch.stack(convs).to(torch_dtype(cfg.dtype)),
                    "h": torch.stack(hs),
                    "pos": torch.tensor(S, dtype=torch.int32,
                                        device=embed.device)}


# ---------------------------------------------------------------------------
# Decode (O(1) state)
# ---------------------------------------------------------------------------

def cache_spec(cfg, batch: int, max_len: int):  # noqa: ARG001
    """The cache's shapes and dtypes as tensors on the "meta" device;
    ``max_len`` only sets ``pos`` semantics — the state is O(1) in
    sequence length."""
    s, d_in, H, d_xbc = _dims(cfg)
    L = cfg.n_layers
    return {
        "conv": torch.empty((L, batch, s.d_conv - 1, d_xbc),
                            dtype=torch_dtype(cfg.dtype), device="meta"),
        "h": torch.empty((L, batch, H, s.head_dim, s.d_state),
                         dtype=torch.float32, device="meta"),
        "pos": torch.empty((), dtype=torch.int32, device="meta"),
    }


def mamba_step(xt, lp: MambaLayer, cfg, conv_state, h):
    """Single-token recurrence. xt: [B, D] → ([B, D], conv_state, h)."""
    s, d_in, H, d_xbc = _dims(cfg)
    B = xt.shape[0]
    GN = s.n_groups * s.d_state
    f32 = torch.float32
    zxbcdt = xt @ lp.in_proj
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_xbc, H], dim=-1)
    win = torch.cat([conv_state, xbc[:, None]], dim=1)         # [B, dc, C]
    xbc = torch.einsum("bdc,dc->bc", win.to(f32),
                       lp.conv_w.to(f32)) + lp.conv_b
    xbc = F.silu(xbc).to(xt.dtype)
    conv_state = win[:, 1:]
    xs, Bm, Cm = torch.split(xbc, [d_in, GN, GN], dim=-1)
    rep = H // s.n_groups
    xh = xs.reshape(B, H, s.head_dim).to(f32)
    Bm = torch.repeat_interleave(Bm.reshape(B, s.n_groups, s.d_state), rep,
                                 dim=1).to(f32)
    Cm = torch.repeat_interleave(Cm.reshape(B, s.n_groups, s.d_state), rep,
                                 dim=1).to(f32)
    dtv = _softplus(dt.to(f32) + lp.dt_bias)                   # [B, H]
    A = -torch.exp(lp.A_log)
    decay = torch.exp(dtv * A[None])[..., None, None]          # [B,H,1,1]
    h = decay * h + (dtv[..., None] * xh)[..., None] * Bm[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", h, Cm)
    y = y + lp.D[None, :, None] * xh
    y = y.reshape(B, d_in).to(xt.dtype)
    y = rmsnorm(y * F.silu(z), lp.ssm_norm)
    return y @ lp.out_proj, conv_state, h


@torch.no_grad()
def decode_step(params: Mamba2, cfg, cache, tokens):
    """One decode step. tokens: [B, 1] → (logits [B, V] f32, new cache);
    ``cache["pos"]`` stays a device tensor: no host sync."""
    embed = params.embed
    tokens = torch.as_tensor(tokens, device=embed.device)
    x = embed_tokens(embed, tokens, cfg.d_model)[:, 0]          # [B, D]
    convs, hs = [], []
    for lp, conv, h in zip(params.layers, cache["conv"], cache["h"]):
        y, conv, h = mamba_step(norm(x, lp.norm, cfg), lp, cfg, conv, h)
        x = x + y
        convs.append(conv)
        hs.append(h)
    x = norm(x, params.final_norm, cfg)
    return last_logits(x, embed), {
        "conv": torch.stack(convs), "h": torch.stack(hs),
        "pos": cache["pos"] + 1}
