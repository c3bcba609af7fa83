from repro_torch.kernels.attn_colsum.ops import attn_colsum  # noqa: F401
