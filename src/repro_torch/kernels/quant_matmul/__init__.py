from repro_torch.kernels.quant_matmul.ops import (  # noqa: F401
    PackedWeight,
    is_packed,
    mla_latent_weights,
    pack_weight,
    packed_weight_from_artifact,
    quant_matmul,
    quant_matmul_t,
)
