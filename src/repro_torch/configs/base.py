"""Configuration system (the port's own copy of ``repro.configs.base``).

Every architecture is described by a single frozen ``ModelConfig`` dataclass.
Configs are pure data — building params / steps happens in
``repro_torch.models``.  The copy is kept field-for-field identical to the
JAX package's so a config means the same model in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0              # routed experts
    top_k: int = 0
    n_shared: int = 0               # always-on shared experts (deepseek-v2)
    d_ff_expert: int = 0            # per-expert hidden
    moe_every: int = 1              # a layer l is MoE iff l % moe_every == moe_offset
    moe_offset: int = 0
    first_dense: int = 0            # first `first_dense` layers use dense MLP
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (deepseek-v2)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 -> d_model // 16


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64            # lora rank for data-dependent decay (w)
    mix_lora: int = 32              # token-shift mixing lora rank


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 0
    enc_seq: int = 1500             # whisper: 30s audio -> 1500 frames
    enc_pos_embed: bool = True


# ---------------------------------------------------------------------------
# Main config
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "hybrid", "ssm", "encdec", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                     # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads

    norm: str = "rmsnorm"           # rmsnorm | layernorm | nonparametric_ln
    act: str = "silu"               # silu (swiglu) | gelu (plain mlp)
    glu: bool = True                # gated (SwiGLU) vs plain 2-matrix MLP
    tied_embeddings: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    qk_norm: bool = False           # chameleon uses qk-norm
    max_seq_len: int = 524288

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encdec: Optional[EncDecConfig] = None

    # hybrid (jamba): layer l is attention iff l % attn_every == attn_offset,
    # else mamba. attn_every=1 -> pure attention.
    attn_every: int = 1
    attn_offset: int = 0

    # dtypes / numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"   # bf16 for >=100B archs (fits 16GB/chip)
    logit_dtype: str = "float32"

    # execution
    cache_dtype: str = ""           # "" -> compute_dtype; "float8_e4m3fn"
    #                                 halves decode cache traffic (H2)
    remat: str = "full"             # full | dots | none
    attn_chunk: int = 1024          # KV-chunk for online-softmax attention
    ssm_chunk: int = 256            # time-chunk for mamba / rwkv6
    scan_layers: bool = True        # lax.scan over (stacked) layer blocks
    use_pallas: bool = False        # Pallas kernels (TPU); jnp ref path on CPU

    # long-context capability: sub-quadratic archs can run long_500k decode
    subquadratic: bool = False

    def __post_init__(self):
        assert self.family in FAMILIES, self.family
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.n_heads:
            assert self.n_heads % max(self.n_kv_heads, 1) == 0, (
                f"{self.arch_id}: n_heads={self.n_heads} kv={self.n_kv_heads}")

    # -- derived ------------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.moe is not None and self.moe.n_experts > 0

    @property
    def is_hybrid(self) -> bool:
        return self.attn_every > 1

    @property
    def is_encdec(self) -> bool:
        return self.encdec is not None and self.encdec.n_enc_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.rwkv is not None

    def layer_kind(self, l: int) -> str:
        """'attn' | 'mamba' | 'rwkv' sequence-mixer kind of layer l."""
        if self.rwkv is not None:
            return "rwkv"
        if self.attn_every > 1:
            return "attn" if l % self.attn_every == self.attn_offset else "mamba"
        return "attn"

    def mlp_kind(self, l: int) -> str:
        """'dense' | 'moe' channel-mixer kind of layer l."""
        if not self.is_moe or l < self.moe.first_dense:
            return "dense"
        return "moe" if (l % self.moe.moe_every == self.moe.moe_offset) else "dense"

    # -- analytic parameter count (used by tests vs published sizes) --------
    def param_count(self) -> int:
        d, v = self.d_model, self.vocab_size
        total = v * d * (1 if self.tied_embeddings else 2)
        if self.is_encdec and self.encdec.enc_pos_embed:
            total += self.encdec.enc_seq * d + self.max_position_embeddings_dec() * d

        def attn_params() -> int:
            if self.mla is not None:
                m = self.mla
                h = self.n_heads
                p = d * m.q_lora_rank
                p += m.q_lora_rank * h * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                p += m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
                p += h * m.v_head_dim * d
                return p
            hd = self.head_dim
            return (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                    + self.n_heads * hd * d)

        def mlp_params(ff: int) -> int:
            return d * ff * (3 if self.glu else 2)

        def moe_params() -> int:
            m = self.moe
            p = (m.n_experts + m.n_shared) * mlp_params(m.d_ff_expert)
            p += d * m.n_experts  # router
            return p

        def mamba_params() -> int:
            mc = self.mamba
            inner = mc.expand * d
            dt_rank = mc.dt_rank or d // 16
            p = d * 2 * inner                     # in_proj (x and z)
            p += mc.d_conv * inner                # depthwise conv
            p += inner * (dt_rank + 2 * mc.d_state)   # x_proj
            p += dt_rank * inner                  # dt_proj
            p += inner * mc.d_state + inner       # A_log, D
            p += inner * d                        # out_proj
            return p

        def rwkv_params() -> int:
            rc = self.rwkv
            # time-mix: r,k,v,g,o square proj + decay lora + first (u)
            p = 5 * d * d
            p += d * rc.decay_lora + rc.decay_lora * d   # decay lora
            p += 5 * (d * rc.mix_lora + rc.mix_lora * d)  # token-shift loras
            p += d                                         # bonus u
            # channel-mix
            p += d * self.d_ff + self.d_ff * d + d * d
            return p

        n_dec = self.n_layers
        for l in range(n_dec):
            kind = self.layer_kind(l)
            if kind == "attn":
                total += attn_params()
            elif kind == "mamba":
                total += mamba_params()
            elif kind == "rwkv":
                total += rwkv_params()
                continue  # rwkv_params includes channel mix
            total += moe_params() if self.mlp_kind(l) == "moe" else mlp_params(self.d_ff)
        if self.is_encdec:
            # encoder self-attn+mlp, decoder already counted; add cross-attn
            total += self.encdec.n_enc_layers * (attn_params() + mlp_params(self.d_ff))
            total += n_dec * attn_params()  # cross attention in decoder
        return total

    def active_param_count(self) -> int:
        """Params used per token (MoE: top_k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        m = self.moe
        d = self.d_model
        per_expert = d * m.d_ff_expert * (3 if self.glu else 2)
        inactive = 0
        for l in range(self.n_layers):
            if self.mlp_kind(l) == "moe":
                inactive += (m.n_experts - m.top_k) * per_expert
        return self.param_count() - inactive

    def max_position_embeddings_dec(self) -> int:
        return 448 if self.is_encdec else 0

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned to every LM arch)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell is runnable; else reason for the skip."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.arch_id} is full-attention (see DESIGN.md)")
    return True, ""
