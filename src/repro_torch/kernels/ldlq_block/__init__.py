"""LDLQ's in-block row loop with the E8 rounder for a stack of matrices
(``ops.ldlq_block``), its plain version (``ref``) and CUDA launcher
(``kernel``)."""
from repro_torch.kernels.ldlq_block.ops import ldlq_block  # noqa: F401
