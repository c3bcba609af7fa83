"""ctypes launcher of the CUDA fast Walsh-Hadamard transform
(``csrc/hadamard.cu``).  Shapes, types and the width limit are checked by
``ops``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.hadamard.ref import inv_sqrt

MAX_D = 1 << 15  # one row per block, in fp32 shared memory (128 KB)


def _lib():
    fn = build.library("hadamard").fwht_launch
    fn.argtypes = [build.P, build.P, build.I, build.I, build.I, build.F,
                   build.P]
    fn.restype = build.I
    return fn


def fwht_cuda(x: torch.Tensor) -> torch.Tensor:
    """(n, d) contiguous fp32 or bf16, 16-byte aligned -> the orthonormal
    transform of each row, in x's dtype, on the card."""
    n, d = x.shape
    out = torch.empty_like(x)
    err = _lib()(x.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
                 n, d, inv_sqrt(d),
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "fwht")
    return out
