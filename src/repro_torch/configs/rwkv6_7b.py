"""rwkv6-7b [ssm] — Finch, data-dependent decay [arXiv:2404.05892].

32L d_model=4096 (attention-free) d_ff=14336 vocab=65536.
64 heads x head_dim 64; O(1) recurrent state -> the long_500k representative.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,              # wkv heads = d_model / head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    norm="layernorm",
    use_rope=False,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
    subquadratic=True,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, attn_chunk=32, ssm_chunk=16,
    rwkv=RWKVConfig(head_dim=16, decay_lora=8, mix_lora=4))
