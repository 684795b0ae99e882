"""Model/arch configuration schema shared by all assigned architectures
(a copy of ``repro.configs.base``, which the port does not import)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25     # the paper's (1+eps) bound
    overflow_depth: int = 4           # extra PoRC probes past top_k
    router: str = "cg"                # "cg" (paper) | "topk" (drop baseline)
    # heterogeneous expert capacity (the Fig 15 unequal-worker story on
    # the expert axis). Exactly one of the two may be set; both unset =
    # uniform capacity, bit-identical to the scalar pre-vector dispatch.
    # expert_capacities: explicit per-expert buffer sizes (len n_experts,
    # absolute token slots per group — overrides capacity_factor).
    # capacity_skew s > 0: generated geometric profile cap_0/cap_{E-1} =
    # 1+s at the same total budget E·C_base (see
    # repro_torch.moe.router.expert_capacity_vector).
    expert_capacities: tuple[int, ...] | None = None
    capacity_skew: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    d_state: int                      # N
    head_dim: int = 64                # P
    n_groups: int = 1                 # G
    d_conv: int = 4
    expand: int = 2                   # d_inner = expand * d_model
    chunk: int = 128                  # SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                       # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    rope_theta: float = 10_000.0
    use_bias: bool = False
    tie_embeddings: bool = True
    mlp_kind: str = "swiglu"          # swiglu (3-mat) | gelu (2-mat)
    norm_kind: str = "rms"            # rms | ln
    # sliding-window / local-global interleave (gemma3)
    sliding_window: int | None = None
    global_every: int | None = None   # every k-th layer is global attention
    # sub-configs
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # hybrid (zamba2): shared attention block applied every k ssm layers
    shared_attn_every: int | None = None
    # enc-dec (whisper)
    n_enc_layers: int = 0
    # vlm (internvl2): stub frontend embedding dim
    vision_dim: int | None = None
    n_patches: int = 256
    # numerics / compile hygiene
    dtype: str = "bfloat16"
    remat: str = "full"               # none|dots|full
    q_chunk: int = 1024
    kv_chunk: int = 1024
    attn_chunk_threshold: int = 2048  # use chunked attention above this seq
    use_pallas: str = "auto"          # auto|never|always
    # sub-quadratic decode support (long_500k applicability)
    subquadratic_decode: bool = False
    # small models on big meshes: batch over ALL axes, params replicated
    pure_dp: bool = False
    # gradient accumulation (microbatching): activations scale 1/k
    grad_accum: int = 1

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_params_embed(self) -> int:
        return self.vocab * self.d_model

    def param_count(self) -> int:
        """Analytic parameter count (matches init_params; used for 6ND)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d
        if self.family in ("dense", "vlm"):
            attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head \
                + self.n_heads * self.d_head * d
            nmat = 3 if self.mlp_kind == "swiglu" else 2
            mlp = nmat * d * self.d_ff
            per = attn + mlp + 2 * d
            tot = emb + L * per + d
            if self.family == "vlm" and self.vision_dim:
                tot += self.vision_dim * d
            return tot
        if self.family == "moe":
            attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head \
                + self.n_heads * self.d_head * d
            router = d * self.moe.n_experts
            experts = self.moe.n_experts * 3 * d * self.moe.d_ff_expert
            shared = self.moe.n_shared_experts * 3 * d * self.moe.d_ff_expert
            per = attn + router + experts + shared + 2 * d
            return emb + L * per + d
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            H = d_in // s.head_dim
            per = d * (2 * d_in + 2 * s.n_groups * s.d_state + H) \
                + d_in * s.d_conv + d_in + H + d_in * d + 2 * d
            return emb + L * per + d
        if self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * d
            H = d_in // s.head_dim
            per = d * (2 * d_in + 2 * s.n_groups * s.d_state + H) \
                + d_in * s.d_conv + d_in + H + d_in * d + 2 * d
            attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head \
                + self.n_heads * self.d_head * d + 3 * d * self.d_ff + 2 * d
            return emb + L * per + attn + d
        if self.family == "audio":
            attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head \
                + self.n_heads * self.d_head * d
            mlp = 2 * d * self.d_ff
            enc = self.n_enc_layers * (attn + mlp + 2 * d)
            dec = self.n_layers * (2 * attn + mlp + 3 * d)
            return emb + enc + dec + 2 * d
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d
        attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head \
            + self.n_heads * self.d_head * d
        router = d * self.moe.n_experts
        act_experts = (self.moe.top_k + self.moe.n_shared_experts) * 3 * d * self.moe.d_ff_expert
        per = attn + router + act_experts + 2 * d
        return emb + L * per + d


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class SmokeSpec:
    """Reduced same-family config for CPU smoke tests."""
    seq_len: int = 64
    batch: int = 2
