"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff=2048(moe)
vocab=129280, MoE 256e top-8 — MLA, 1 shared + 256 routed, MTP.
[arXiv:2412.19437; hf]

Its first ``first_dense_layers`` layers are MLA attention with a dense
SwiGLU FFN; every later layer is MLA attention with the routed-expert FFN
(``models.moe``).  Multi-token prediction is a training head the port does
not carry."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,  # dense FFN of the first 3 layers
    vocab_size=129280,
    attn_kind="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
    n_routed_experts=256,
    n_shared_experts=1,
    moe_top_k=8,
    moe_d_ff=2048,
    first_dense_layers=3,
    optimizer="adafactor",
    microbatch=8,
    grad_accum_dtype="bfloat16",
)
