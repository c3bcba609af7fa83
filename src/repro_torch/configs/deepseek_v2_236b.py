"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff=1536(moe)
vocab=102400, MoE 160e top-6 — MLA kv_lora=512, 2 shared + 160 routed.
[arXiv:2405.04434; hf]

Layer 0 is MLA attention with a dense SwiGLU FFN; every later layer is MLA
attention with the routed-expert FFN (``models.moe``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,  # dense FFN of the first layer(s)
    vocab_size=102400,
    attn_kind="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
    n_routed_experts=160,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1536,
    first_dense_layers=1,
    optimizer="adamw8bit",
    microbatch=4,
)
