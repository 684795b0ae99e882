"""Shared neural building blocks (port of ``repro.models.layers``).

Plain functions on tensors, the ``Attention`` module that holds the
attention sub-layer's weights under the names of the JAX package's
``attn_params`` dict (``wq``, ``wk``, ``wv``, ``wo``) and the ``MLP``
module of its ``mlp_params`` dict (``w1``, ``w3``, ``w2``); the functions
read a module's weights as attributes.

The layer options of the dense and VLM families are here: ``layernorm``
(``norm_kind="ln"``), biases (``use_bias``: ``bq``, ``bk``, ``bv``,
``bo`` on :class:`Attention`), the 2-matrix :func:`gelu_mlp`, the
sliding window with its per-layer flag, a query offset and a decode
window's lower bound. A layer's ``window_flag`` is a Python bool (the
reference's traced flag inside its layer scan): False turns the window
off, True or None keeps it.

``attention`` takes whisper's cross-attention k and v precomputed
(``kv_override``), and names its output for a selective checkpoint
policy (:func:`attn_out`, the reference's ``checkpoint_name(out,
"attn_out")``). ``rmsnorm`` and ``layernorm`` carry the reference's
custom VJPs; the chunked attention's kv steps are rematerialised in the
backward, as the reference's ``jax.checkpoint`` of each kv step does.

Left out: ``shard_act`` and the activation-sharding rules, which are the
identity on one device (the mesh tier is ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

_RMS_EPS = 1e-6
_LN_EPS = 1e-5
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


def _layernorm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + _LN_EPS)
    out = out * scale.to(torch.float32) + bias.to(torch.float32)
    return out.to(x.dtype)


class _LayerNorm(torch.autograd.Function):
    """The reference's custom VJP (``_ln_fwd``/``_ln_bwd``): the backward
    keeps ``x`` in its own dtype and the scale, and works in f32."""

    @staticmethod
    def forward(ctx, x, scale, bias):
        ctx.save_for_backward(x, scale)
        return _layernorm(x, scale, bias)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        xf = x.to(torch.float32)
        gf = g.to(torch.float32)
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        r = torch.rsqrt(var + _LN_EPS)
        xhat = (xf - mu) * r
        gs = gf * scale.to(torch.float32)
        dx = r * (gs - torch.mean(gs, -1, keepdim=True)
                  - xhat * torch.mean(gs * xhat, -1, keepdim=True))
        axes = tuple(range(x.dim() - 1))
        return (dx.to(x.dtype), torch.sum(gf * xhat, axes).to(scale.dtype),
                torch.sum(gf, axes).to(scale.dtype))


def layernorm(x: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm in f32 with the population variance (``jnp.var``),
    eps 1e-5, cast back to ``x``'s dtype; differentiable with the
    reference's custom VJP (dx, dscale, dbias)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias)):
        return _LayerNorm.apply(x, scale, bias)
    return _layernorm(x, scale, bias)


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


def _window(window: int | None, window_flag) -> int | None:
    """The window a layer applies: none when the config has none or the
    layer's flag (a Python bool) turns it off."""
    if window is None or (window_flag is not None and not window_flag):
        return None
    return window


def _mask(qpos, kpos, causal: bool, window: int | None):
    """[Sq, Sk] True where a query at absolute position ``qpos`` sees the
    key at ``kpos``: at or before it when ``causal``, and within
    ``window`` of it (``kpos > qpos - window``); None when neither."""
    mask = qpos[:, None] >= kpos[None, :] if causal else None
    if window is not None:
        near = kpos[None, :] > qpos[:, None] - window
        mask = near if mask is None else mask & near
    return mask


def dense_attention(q, k, v, *, causal: bool, window: int | None = None,
                    q_offset: int = 0, window_flag=None) -> torch.Tensor:
    """Materialized-scores attention for short sequences.

    q: [B, Sq, H, Dh]; k, v: [B, Sk, KV, Dh]. Returns [B, Sq, H, Dh].
    Query i sits at position ``q_offset + i``; ``window`` masks keys at
    or below ``position - window`` unless ``window_flag`` is False.
    """
    H = q.shape[2]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * _scale(q.shape[-1])
    dev = q.device
    mask = _mask(torch.arange(q.shape[1], device=dev) + q_offset,
                 torch.arange(k.shape[1], device=dev), causal,
                 _window(window, window_flag))
    if mask is not None:
        s.masked_fill_(~mask, _NEG)  # in place: s is this call's own
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


def _sweep(q, k, v, causal: bool, window: int | None, q_offset: int,
           q_chunk: int, kv_chunk: int, kv_blocks) -> torch.Tensor:
    """Every q chunk i over the kv chunks ``range(*kv_blocks(i))``, with
    the causal and window masks on absolute positions (query i of chunk
    c at ``q_offset + c·q_chunk + i``); the running max starts at
    ``_NEG`` and the output is acc / max(l, 1e-30). When q, k or v needs
    a gradient, each kv step runs under ``torch.utils.checkpoint``
    (non-reentrant): the backward keeps its inputs (the running max, sum
    and acc), not its [B, H, q_chunk, kv_chunk] tiles, and recomputes
    them."""
    B, Sq, H, Dh = q.shape
    nq = _chunks(Sq, q_chunk, "query")
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    scale = _scale(Dh)
    dev = q.device
    ar_q = torch.arange(q_chunk, device=dev)
    ar_k = torch.arange(kv_chunk, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for i in range(nq):
        qc = q[:, i * q_chunk:(i + 1) * q_chunk]
        qpos = q_offset + i * q_chunk + ar_q
        m = torch.full((B, H, q_chunk), _NEG, **f32)
        l = torch.zeros((B, H, q_chunk), **f32)
        acc = torch.zeros((B, H, q_chunk, Dh), **f32)
        for j in range(*kv_blocks(i)):
            mask = _mask(qpos, j * kv_chunk + ar_k, causal, window)
            ks = slice(j * kv_chunk, (j + 1) * kv_chunk)
            args = (qc, k[:, ks], v[:, ks], mask, m, l, acc, scale)
            m, l, acc = (checkpoint(_online_step, *args, use_reentrant=False)
                         if grad else _online_step(*args))
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None])
                    .transpose(1, 2))                    # [B, qc, H, Dh]
    return torch.cat(outs, dim=1).to(q.dtype)


def _chunked_attn_body(q, k, v, causal: bool, window: int | None,
                       q_chunk: int, kv_chunk: int,
                       q_offset: int = 0) -> torch.Tensor:
    """The rectangular sweep: every q chunk over every kv chunk."""
    nk = _chunks(k.shape[1], kv_chunk, "key")
    return _sweep(q, k, v, causal, window, q_offset, q_chunk, kv_chunk,
                  lambda i: (0, nk))


def _chunked_attn_tri(q, k, v, window: int | None, q_chunk: int,
                      kv_chunk: int) -> torch.Tensor:
    """The triangular causal schedule: per q chunk, the causal kv-chunk
    prefix; with a window, less the kv chunks wholly below it for every
    query of the chunk (the reference's bound, which it takes only for a
    window on every layer; a chunk the mask covers whole adds exactly
    nothing to the online softmax, so skipping it for a local layer
    leaves every bit of the result)."""
    Sq = q.shape[1]
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sq)
    _chunks(Sq, kv_chunk, "key")

    def kv_blocks(i):
        hi = (i + 1) * q_chunk
        lo = (0 if window is None
              else max(0, (hi - q_chunk - window) // kv_chunk))
        return lo, -(-hi // kv_chunk)                      # ceil
    return _sweep(q, k, v, True, window, 0, q_chunk, kv_chunk, kv_blocks)


def chunked_attention(q, k, v, *, causal: bool, window: int | None = None,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      q_offset: int = 0, window_flag=None) -> torch.Tensor:
    """Online-softmax attention over q and kv chunks: the S² score matrix
    never lives whole, only one [B, H, q_chunk, kv_chunk] f32 tile.

    q: [B, Sq, H, Dh]; k, v: [B, Sk, KV, Dh]. Returns [B, Sq, H, Dh].
    Causal self-attention (Sq == Sk, no query offset) takes the
    triangular schedule, the rest the rectangular sweep, as in the
    reference; ``window`` and ``window_flag`` mask as in
    :func:`dense_attention`. Chunk lengths that do not divide their
    sequence raise ``ValueError``. Each call adds one to
    ``chunked_attention.calls``.
    """
    chunked_attention.calls += 1
    window = _window(window, window_flag)
    if causal and q_offset == 0 and q.shape[1] == k.shape[1]:
        return _chunked_attn_tri(q, k, v, window, q_chunk, kv_chunk)
    return _chunked_attn_body(q, k, v, causal, window, q_chunk, kv_chunk,
                              q_offset)


# calls, summed: ``chip_smoke.py`` reads here that a long prompt's
# prefill took the chunked path
chunked_attention.calls = 0


def decode_attention(q, k_cache, v_cache, valid_len,
                     lo_idx=None) -> torch.Tensor:
    """Single-position attention against a (padded) KV cache.

    q: [B, 1, H, Dh]; caches: [B, S, KV, Dh]; valid_len: current length
    (an int or a 0-dim tensor; entries at position ≥ valid_len are
    masked); ``lo_idx``: optional lower bound of the same kinds, entries
    below it masked (sliding-window decode).
    """
    H = q.shape[2]
    k = _expand_kv(k_cache, H)
    v = _expand_kv(v_cache, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * _scale(q.shape[-1])
    idx = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    masked = idx >= valid_len
    if lo_idx is not None:
        masked = masked | (idx < lo_idx)
    s.masked_fill_(masked, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Projections / MLP
# ---------------------------------------------------------------------------

def linear(x, w, b=None):
    y = x @ w
    if b is not None:
        y = y + b
    return y


def swiglu_mlp(x, p):
    """LLaMA-style gated MLP: w1 (gate), w3 (up), w2 (down); ``p`` an
    :class:`MLP`."""
    h = torch.nn.functional.silu(x @ p.w1) * (x @ p.w3)
    return h @ p.w2


def gelu_mlp(x, p):
    """2-matrix GELU MLP (starcoder2): w1, w2 and, where ``p`` has them,
    biases b1, b2. ``jax.nn.gelu`` defaults to its tanh form, so this is
    ``approximate="tanh"``."""
    h = linear(x, p.w1, getattr(p, "b1", None))
    h = torch.nn.functional.gelu(h, approximate="tanh")
    return linear(h, p.w2, getattr(p, "b2", None))


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


def zeros_param(shape, dtype, device) -> nn.Parameter:
    """A weight of zeros held without gradients (the reference's biases
    and LayerNorm shifts start at zero)."""
    return _param(torch.zeros(shape, dtype=dtype, device=device))


class Attention(nn.Module):
    """The attention sub-layer's weights; ``forward`` is :func:`attention`.

    Built with ``key`` (a ``torch.Generator``) the weights are drawn as
    ``attn_params`` draws them; without, they are left uninitialized for
    a caller to load (``repro_torch.convert``). With ``cfg.use_bias`` it
    also holds the biases ``bq``, ``bk``, ``bv``, ``bo``, zeros.
    """

    def __init__(self, cfg, dtype, device="cuda", key=None):
        super().__init__()
        self.cfg = cfg
        d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        for name, shape in (("wq", (d, H * Dh)), ("wk", (d, KV * Dh)),
                            ("wv", (d, KV * Dh)), ("wo", (H * Dh, d))):
            self.register_parameter(name,
                                    drawn_param(key, shape, dtype, device))
        if cfg.use_bias:
            for name, n in (("bq", H * Dh), ("bk", KV * Dh),
                            ("bv", KV * Dh), ("bo", d)):
                self.register_parameter(name, zeros_param(n, dtype, device))

    def forward(self, x, *, positions, causal=True, window=None,
                kv_override=None, window_flag=None, return_kv=False):
        return attention(x, self, self.cfg, positions=positions,
                         causal=causal, window=window,
                         kv_override=kv_override, window_flag=window_flag,
                         return_kv=return_kv)


def attn_params(key, cfg, dtype, device="cuda") -> Attention:
    return Attention(cfg, dtype, device, key=key)


def project_qkv(x, p, cfg, positions):
    """q [B, S, H, Dh] and k, v [B, S, KV, Dh] of ``x`` [B, S, D] through
    ``p`` (an :class:`Attention`, biases where it has them), q and k
    roped at ``positions``."""
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = linear(x, p.wq, getattr(p, "bq", None)).reshape(B, S, H, Dh)
    k = linear(x, p.wk, getattr(p, "bk", None)).reshape(B, S, KV, Dh)
    v = linear(x, p.wv, getattr(p, "bv", None)).reshape(B, S, KV, Dh)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


@torch.library.custom_op("repro_torch::attn_out", mutates_args=())
def _attn_out(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


@_attn_out.register_fake
def _(x):
    return torch.empty_like(x)


_attn_out.register_autograd(lambda ctx, g: g)


def attn_out(x: torch.Tensor) -> torch.Tensor:
    """``x`` under the name "attn_out" (the reference's
    ``checkpoint_name(out, "attn_out")``): under autograd a copy made by
    the op ``torch.ops.repro_torch.attn_out``, which a selective
    checkpoint policy can pick out (``transformer.remat``); without, ``x``
    itself."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _attn_out(x)
    return x


def attention(x, p, cfg, *, positions, causal=True, window=None,
              kv_override=None, window_flag=None, return_kv=False):
    """Full attention sub-layer: proj → rope → attend → out-proj.

    p: an :class:`Attention`. ``window``/``window_flag``: the sliding
    window and the layer's flag (:func:`dense_attention`).
    kv_override: (k, v) [B, Sk, KV, Dh] precomputed (cross-attention; no
    RoPE on q or k). return_kv: also return the (roped) k/v for KV-cache
    priming. The attention's output, before its projection, is named
    "attn_out" (:func:`attn_out`). Returns output [B, S, D] (or
    (out, (k, v))).
    """
    B, S, _ = x.shape
    if kv_override is None:
        q, k, v = project_qkv(x, p, cfg, positions)
    else:
        q = linear(x, p.wq, getattr(p, "bq", None)).reshape(
            B, S, cfg.n_heads, cfg.d_head)
        k, v = kv_override
    if max(S, k.shape[1]) > cfg.attn_chunk_threshold:
        out = chunked_attention(q, k, v, causal=causal, window=window,
                                q_chunk=min(cfg.q_chunk, S),
                                kv_chunk=min(cfg.kv_chunk, k.shape[1]),
                                window_flag=window_flag)
    else:
        out = dense_attention(q, k, v, causal=causal, window=window,
                              window_flag=window_flag)
    out = attn_out(out.reshape(B, S, -1))
    out = linear(out, p.wo, getattr(p, "bo", None))
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


class GeluMLP(nn.Module):
    """The 2-matrix GELU MLP's weights ``w1`` [d_model, d_ff] and ``w2``
    [d_ff, d_model] and, with ``bias``, ``b1`` [d_ff] and ``b2``
    [d_model] (zeros); ``forward`` is :func:`gelu_mlp`. Drawn as the
    reference's ``transformer._mlp_params`` draws them with ``key``,
    else left uninitialized."""

    def __init__(self, d_model: int, d_ff: int, dtype, device="cuda",
                 key=None, bias: bool = False):
        super().__init__()
        self.w1 = drawn_param(key, (d_model, d_ff), dtype, device)
        self.w2 = drawn_param(key, (d_ff, d_model), dtype, device)
        if bias:
            self.b1 = zeros_param(d_ff, dtype, device)
            self.b2 = zeros_param(d_model, dtype, device)

    def forward(self, x):
        return gelu_mlp(x, self)
