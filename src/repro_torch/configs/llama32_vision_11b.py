"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; a cross-attention layer on the image's patch embeddings
every 5th layer (positions 3, 8, ...: ``scan_period`` 5), GQA
self-attention elsewhere, dense FFNs everywhere.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision tower is a STUB: the entry points take precomputed patch
embeddings of shape (batch, n_media_tokens, d_model)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    cross_attn_period=5,
    cross_attn_offset=3,
    n_media_tokens=6404,
)
