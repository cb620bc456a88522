"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.
Layer l is attention iff l % 8 == 4 (1 attention : 7 mamba), MoE on every
other layer (odd layers). Sub-quadratic overall -> runs long_500k.
Moments kept in bf16 to fit 16GB/chip (DESIGN §5).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, MambaConfig

CONFIG = ModelConfig(
    arch_id="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    use_rope=False,          # jamba has no positional encoding in attn layers
    attn_every=8,
    attn_offset=4,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576,
                  moe_every=2, moe_offset=1),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    moment_dtype="bfloat16",
    subquadratic=True,       # 9 attn layers; serving memory dominated by mamba
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, attn_chunk=32, ssm_chunk=16, moment_dtype="float32",
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, moe_every=2,
                  moe_offset=1, capacity_factor=2.0),
    mamba=MambaConfig(d_state=4, d_conv=4, expand=2, dt_rank=8))
