from repro_torch.kernels.quant_matmul.ops import (  # noqa: F401
    PackedWeight,
    is_packed,
    pack_weight,
    packed_weight_from_artifact,
    quant_matmul,
)
