"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060].

16L d_model=2048 16H (GQA kv=16) d_ff=1024(per-expert) vocab=50304,
MoE 64e top-8 on every layer. ~6.9B total / ~1.3B active.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    qk_norm=True,  # OLMoE uses QK-norm
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024, moe_every=1),
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
    vocab_size=256, attn_chunk=32, ssm_chunk=16,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, moe_every=1,
                  capacity_factor=2.0))
