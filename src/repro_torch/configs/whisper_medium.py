"""whisper-medium [audio] — 24L d_model=1024 16H d_ff=4096 vocab=51865 —
enc-dec: 24 encoder blocks (non-causal GQA with qkv bias, dense FFN) and
24 decoder blocks (causal GQA with qkv bias, a cross-attention sub-layer
on the encoder's output, dense FFN).  The conv frontend is a STUB: the
entry points take precomputed frame embeddings (batch, frames, d_model).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    d_head=64,
    rope_theta=10_000.0,
    qkv_bias=True,
)
