"""Fast Walsh-Hadamard transform of rows (``ops``), its plain version
(``ref``) and CUDA launcher (``kernel``)."""
from repro_torch.kernels.hadamard.ops import fwht, hadamard_transform  # noqa: F401
