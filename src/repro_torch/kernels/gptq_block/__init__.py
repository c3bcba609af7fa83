"""GPTQ's in-block row loop for a stack of matrices (``ops.solve_block``),
its plain version (``ref``) and CUDA launcher (``kernel``)."""
from repro_torch.kernels.gptq_block.ops import solve_block  # noqa: F401
