"""yi-34b [dense] — llama-arch GQA [arXiv:2403.04652].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5000000.0,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=56, n_heads=7, n_kv_heads=1, d_ff=160, head_dim=8,
    vocab_size=250, attn_chunk=32, ssm_chunk=16)
