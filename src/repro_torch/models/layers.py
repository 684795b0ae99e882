"""Shared neural building blocks (port of ``repro.models.layers``).

Plain functions on tensors, the ``Attention`` module that holds the
attention sub-layer's weights under the names of the JAX package's
``attn_params`` dict (``wq``, ``wk``, ``wv``, ``wo``) and the ``MLP``
module of its ``mlp_params`` dict (``w1``, ``w3``, ``w2``); the functions
read a module's weights as attributes.

Only what the MoE, Mamba-2 and hybrid archs run is here. Left out:
``shard_act`` and the activation-sharding rules, which are the identity
on one device (the port runs on one device; the mesh tier is ROADMAP
Queue 1 item 7); the rematerialisation of the chunked attention's scan
(its backward here is autograd's over the stored chunks; it comes with
the training of long prompts, ROADMAP Queue 1 item 8b). ``rmsnorm``
carries the reference's custom VJP.
``layernorm``, biases, the sliding window and its local/global flag, a
query offset, a decode window's lower bound and cross-attention's
precomputed k/v belong to the dense, audio and VLM families (ROADMAP
Queue 1 item 10) and come with them.
"""
from __future__ import annotations

import torch
from torch import nn

_RMS_EPS = 1e-6
_NEG = -1e30            # the reference's mask value: finite, not -inf


def torch_dtype(name: str) -> torch.dtype:
    """``cfg.dtype`` ("bfloat16", "float32", ..) as a torch dtype."""
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + _RMS_EPS) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


class _RMSNorm(torch.autograd.Function):
    """The reference's custom VJP (``_rms_fwd``/``_rms_bwd``): the
    backward keeps ``x`` in its own dtype (bf16 residuals, not an f32
    copy) and works in f32."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(x, scale)
        return _rmsnorm(x, scale)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        xf = x.to(torch.float32)
        gf = g.to(torch.float32)
        d = x.shape[-1]
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        r = torch.rsqrt(var + _RMS_EPS)
        gs = gf * (1.0 + scale.to(torch.float32))
        dx = r * gs - xf * (r ** 3 / d) * torch.sum(gs * xf, -1,
                                                    keepdim=True)
        dscale = torch.sum(gf * xf * r, dim=tuple(range(x.dim() - 1)))
        return dx.to(x.dtype), dscale.to(scale.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMSNorm with a zero-centred scale, ``(1 + scale)``, in f32 and
    cast back to ``x``'s dtype; differentiable with the reference's
    custom VJP."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale)
    return _rmsnorm(x, scale)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device="cuda") -> torch.Tensor:
    """1 / theta^(2i/d_head) in f32 (theta enters the power as a scalar:
    no host-to-device copy)."""
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: [..., S] int. Split halves (not
    interleaved), in f32, cast back."""
    d_head = x.shape[-1]
    inv = rope_freqs(d_head, theta, x.device)              # [Dh/2]
    ang = positions[..., None].to(torch.float32) * inv     # [..., S, Dh/2]
    cos = torch.cos(ang)[..., None, :]                     # [..., S, 1, Dh/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, KV, Dh] -> [B, S, H, Dh] by group repeat."""
    rep = n_heads // k.shape[2]
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def _scale(d_head: int) -> torch.Tensor:
    return 1.0 / torch.sqrt(torch.tensor(float(d_head), dtype=torch.float32))


def dense_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """Materialized-scores attention for short sequences.

    q: [B, Sq, H, Dh]; k, v: [B, Sk, KV, Dh]. Returns [B, Sq, H, Dh].
    """
    H = q.shape[2]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * _scale(q.shape[-1])
    if causal:
        dev = q.device
        iq = torch.arange(q.shape[1], device=dev)[:, None]
        jk = torch.arange(k.shape[1], device=dev)[None, :]
        s.masked_fill_(iq < jk, _NEG)  # in place: s is this call's own
    p = torch.softmax(s, dim=-1)
    del s
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)


def _chunks(S: int, chunk: int, what: str) -> int:
    """How many chunks of ``chunk`` cut ``S``; the reference reshapes S
    into them, so a length they do not divide is refused."""
    if chunk < 1 or S % chunk:
        raise ValueError(f"chunked_attention: {what} length {S} is not a "
                         f"multiple of its chunk {chunk}")
    return S // chunk


def _online_step(qc, kc, vc, mask, m, l, acc, scale):
    """One kv chunk of the online softmax: f32 scores of ``qc``
    [B, qc, H, Dh] against ``kc``/``vc`` [B, kc, H, Dh], the positions
    where ``mask`` [qc, kc] is False (if given) set to ``_NEG``, folded
    into the running max ``m``, sum ``l`` [B, H, qc] and ``acc``
    [B, H, qc, Dh]."""
    s = torch.einsum("bqhd,bkhd->bhqk", qc.to(torch.float32),
                     kc.to(torch.float32)) * scale
    if mask is not None:
        s.masked_fill_(~mask, _NEG)  # in place: s is this step's own
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    del s
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                               vc.to(torch.float32))
    return m_new, l, acc


def _sweep(q, k, v, causal: bool, q_chunk: int, kv_chunk: int,
           kv_blocks) -> torch.Tensor:
    """Every q chunk i over the first ``kv_blocks(i)`` kv chunks, with
    the causal mask on absolute positions when ``causal``; the running
    max starts at ``_NEG`` and the output is acc / max(l, 1e-30)."""
    B, Sq, H, Dh = q.shape
    nq = _chunks(Sq, q_chunk, "query")
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    scale = _scale(Dh)
    dev = q.device
    ar_q = torch.arange(q_chunk, device=dev)
    ar_k = torch.arange(kv_chunk, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    outs = []
    for i in range(nq):
        qc = q[:, i * q_chunk:(i + 1) * q_chunk]
        m = torch.full((B, H, q_chunk), _NEG, **f32)
        l = torch.zeros((B, H, q_chunk), **f32)
        acc = torch.zeros((B, H, q_chunk, Dh), **f32)
        for j in range(kv_blocks(i)):
            mask = ((i * q_chunk + ar_q)[:, None]
                    >= (j * kv_chunk + ar_k)[None, :]) if causal else None
            ks = slice(j * kv_chunk, (j + 1) * kv_chunk)
            m, l, acc = _online_step(qc, k[:, ks], v[:, ks], mask, m, l,
                                     acc, scale)
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None])
                    .transpose(1, 2))                    # [B, qc, H, Dh]
    return torch.cat(outs, dim=1).to(q.dtype)


def _chunked_attn_body(q, k, v, causal: bool, q_chunk: int,
                       kv_chunk: int) -> torch.Tensor:
    """The rectangular sweep: every q chunk over every kv chunk."""
    nk = _chunks(k.shape[1], kv_chunk, "key")
    return _sweep(q, k, v, causal, q_chunk, kv_chunk, lambda i: nk)


def _chunked_attn_tri(q, k, v, q_chunk: int, kv_chunk: int) -> torch.Tensor:
    """The triangular causal schedule: per q chunk, exactly the causal
    kv-chunk prefix."""
    Sq = q.shape[1]
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sq)
    _chunks(Sq, kv_chunk, "key")
    return _sweep(q, k, v, True, q_chunk, kv_chunk,
                  lambda i: -(-(i + 1) * q_chunk // kv_chunk))   # ceil


def chunked_attention(q, k, v, *, causal: bool, q_chunk: int = 1024,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over q and kv chunks: the S² score matrix
    never lives whole, only one [B, H, q_chunk, kv_chunk] f32 tile.

    q: [B, Sq, H, Dh]; k, v: [B, Sk, KV, Dh]. Returns [B, Sq, H, Dh].
    Causal self-attention (Sq == Sk) takes the triangular schedule, the
    rest the rectangular sweep, as in the reference; chunk lengths that
    do not divide their sequence raise ``ValueError``. Each call adds one
    to ``chunked_attention.calls``.
    """
    chunked_attention.calls += 1
    if causal and q.shape[1] == k.shape[1]:
        return _chunked_attn_tri(q, k, v, q_chunk, kv_chunk)
    return _chunked_attn_body(q, k, v, causal, q_chunk, kv_chunk)


# calls, summed: ``chip_smoke.py`` reads here that a long prompt's
# prefill took the chunked path
chunked_attention.calls = 0


def decode_attention(q, k_cache, v_cache, valid_len) -> torch.Tensor:
    """Single-position attention against a (padded) KV cache.

    q: [B, 1, H, Dh]; caches: [B, S, KV, Dh]; valid_len: current length
    (an int or a 0-dim tensor; entries at position ≥ valid_len are
    masked).
    """
    H = q.shape[2]
    k = _expand_kv(k_cache, H)
    v = _expand_kv(v_cache, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * _scale(q.shape[-1])
    idx = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    s.masked_fill_(idx >= valid_len, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------

def linear(x, w):
    return x @ w


def swiglu_mlp(x, p):
    """LLaMA-style gated MLP: w1 (gate), w3 (up), w2 (down); ``p`` an
    :class:`MLP`."""
    h = torch.nn.functional.silu(x @ p.w1) * (x @ p.w3)
    return h @ p.w2


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

def dense_init(key: torch.Generator, shape, dtype, scale=None,
               device="cuda") -> torch.Tensor:
    """Normal(0, 1) · scale in f32, cast to ``dtype``; the scale defaults
    to 1/√shape[0], as in the reference (for the stacked expert weights
    [E, d, f] that is 1/√E). ``key`` is a ``torch.Generator`` on
    ``device``: it does not give the reference's numbers from the same
    seed."""
    if scale is None:
        scale = shape[0] ** -0.5
    x = torch.randn(shape, generator=key, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def drawn_param(key, shape, dtype, device, scale=None) -> nn.Parameter:
    """A weight held without gradients (serving; training turns them on
    with ``module.requires_grad_()``): drawn as :func:`dense_init` draws
    it with ``key`` (a ``torch.Generator``), or left uninitialized without
    one, for a caller to load (``repro_torch.convert``)."""
    return _param(dense_init(key, shape, dtype, scale, device)
                  if key is not None
                  else torch.empty(shape, dtype=dtype, device=device))


def as_generator(key, device) -> torch.Generator:
    """``key`` if it is a ``torch.Generator``, else one on ``device``
    seeded with the int ``key``."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(int(key))


class Attention(nn.Module):
    """The attention sub-layer's weights; ``forward`` is :func:`attention`.

    Built with ``key`` (a ``torch.Generator``) the weights are drawn as
    ``attn_params`` draws them; without, they are left uninitialized for
    a caller to load (``repro_torch.convert``).
    """

    def __init__(self, cfg, dtype, device="cuda", key=None):
        super().__init__()
        self.cfg = cfg
        d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        for name, shape in (("wq", (d, H * Dh)), ("wk", (d, KV * Dh)),
                            ("wv", (d, KV * Dh)), ("wo", (H * Dh, d))):
            self.register_parameter(name,
                                    drawn_param(key, shape, dtype, device))

    def forward(self, x, *, positions, causal=True, return_kv=False):
        return attention(x, self, self.cfg, positions=positions,
                         causal=causal, return_kv=return_kv)


def attn_params(key, cfg, dtype, device="cuda") -> Attention:
    return Attention(cfg, dtype, device, key=key)


def attention(x, p, cfg, *, positions, causal=True, return_kv=False):
    """Full attention sub-layer: proj → rope → attend → out-proj.

    p: an :class:`Attention`. return_kv: also return the (roped) k/v for
    KV-cache priming. Returns output [B, S, D] (or (out, (k, v))).
    """
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = linear(x, p.wq).reshape(B, S, H, Dh)
    k = linear(x, p.wk).reshape(B, S, KV, Dh)
    v = linear(x, p.wv).reshape(B, S, KV, Dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if max(S, k.shape[1]) > cfg.attn_chunk_threshold:
        out = chunked_attention(q, k, v, causal=causal,
                                q_chunk=min(cfg.q_chunk, S),
                                kv_chunk=min(cfg.kv_chunk, k.shape[1]))
    else:
        out = dense_attention(q, k, v, causal=causal)
    out = linear(out.reshape(B, S, H * Dh), p.wo)
    if return_kv:
        return out, (k, v)
    return out


class MLP(nn.Module):
    """The gated MLP's weights ``w1``, ``w3`` [d_model, d_ff] and ``w2``
    [d_ff, d_model]; ``forward`` is :func:`swiglu_mlp`. Drawn as
    ``mlp_params`` draws them with ``key``, else left uninitialized."""

    def __init__(self, d_model: int, d_ff: int, dtype, device="cuda",
                 key=None):
        super().__init__()
        for name, shape in (("w1", (d_model, d_ff)), ("w3", (d_model, d_ff)),
                            ("w2", (d_ff, d_model))):
            self.register_parameter(name,
                                    drawn_param(key, shape, dtype, device))

    def forward(self, x):
        return swiglu_mlp(x, self)

