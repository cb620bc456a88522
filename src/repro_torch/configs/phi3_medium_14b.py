"""phi3-medium-14b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219].

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
40 heads / 10 kv heads are not divisible by the 16-way model axis; the
sharding layer relies on GSPMD uneven (padded) sharding for head dims
(see DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=80, n_heads=10, n_kv_heads=2, d_ff=224, head_dim=8,
    vocab_size=256, attn_chunk=32, ssm_chunk=16)
