"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE every other
layer. [arXiv:2403.19887; hf]

A layer group is 8 blocks (``scan_period`` lcm(8, 2)): GQA attention at
position 4, Mamba-2 mixers elsewhere; routed-expert FFNs (16 experts, top
2, no shared expert) at the odd positions, dense SwiGLU FFNs at the even
ones, so the one GQA block has a dense FFN."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    rope_theta=10_000.0,
    # 1 attention layer per 8 (position 4 of each period), rest Mamba
    attn_period=8,
    attn_offset=4,
    # MoE FFN every other layer (odd positions)
    n_routed_experts=16,
    n_shared_experts=0,
    moe_top_k=2,
    moe_d_ff=14336,
    moe_period=2,
    moe_offset=1,
    # Mamba sublayers (Jamba uses state=16, conv=4)
    ssm_d_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    optimizer="adamw8bit",
    microbatch=2,
)
