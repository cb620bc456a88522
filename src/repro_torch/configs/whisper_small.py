"""whisper-small [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356].

12L(enc)+12L(dec) d_model=768 12H d_ff=3072 vocab=51865.
The conv1d+mel frontend is a STUB: the caller passes precomputed frame
embeddings ``enc_embeds`` (batch, 1500, 768). Whisper uses learned
positional embeddings (no RoPE) and pre-LN LayerNorm, plain GELU MLP.
The model's trained decoder context is 448 tokens; past it the decoder's
positional table is clamped to its last row (``models.encdec``).
"""
from repro_torch.configs.base import ModelConfig, EncDecConfig

CONFIG = ModelConfig(
    arch_id="whisper-small",
    family="audio",
    n_layers=12,                 # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    norm="layernorm",
    act="gelu",
    glu=False,
    use_rope=False,
    tied_embeddings=True,
    encdec=EncDecConfig(n_enc_layers=12, enc_seq=1500),
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=256, attn_chunk=32, ssm_chunk=16,
    encdec=EncDecConfig(n_enc_layers=2, enc_seq=48))
