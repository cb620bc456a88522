"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434].

60L d_model=5120 128H (GQA kv=128) d_ff=1536(per-expert) vocab=102400.
First layer uses a dense MLP (d_ff 12288), remaining 59 layers are MoE.
~236B total / ~21B active. Moments kept in bf16 to fit 16GB/chip (DESIGN §5).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,               # dense layers' hidden (first layer)
    vocab_size=102400,
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536,
                  moe_every=1, first_dense=1),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moment_dtype="bfloat16",
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, attn_chunk=32, ssm_chunk=16, moment_dtype="float32",
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_ff_expert=32,
                  moe_every=1, first_dense=1, capacity_factor=2.0),
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16))
