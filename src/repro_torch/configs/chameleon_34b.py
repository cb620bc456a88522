"""chameleon-34b [vlm] — early-fusion, VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
The modality frontend (VQ-VAE image tokenizer) is a STUB: image tokens are
part of the 65536 vocab and ``input_specs()`` provides precomputed token ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    norm="rmsnorm",
    qk_norm=True,            # chameleon stabilizes early fusion with qk-norm
    rope_theta=10000.0,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=176,
    vocab_size=256, attn_chunk=32, ssm_chunk=16)
