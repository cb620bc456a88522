"""olmo-1b [dense] — non-parametric LN [arXiv:2402.00838].

16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304.
OLMo uses non-parametric LayerNorm (no scale/bias), SwiGLU, RoPE, and a
tied, padded embedding (50304 = 50257 padded to a multiple of 128).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparametric_ln",
    tied_embeddings=True,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=256, attn_chunk=32, ssm_chunk=16)
