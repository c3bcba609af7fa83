"""ctypes launcher of the CUDA weighted-gram kernel (``csrc/gram.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def _lib():
    lib = build.library("gram")
    fn = lib.gram_launch
    fn.argtypes = [build.P, build.I, build.P, build.P, build.I, build.I,
                   build.F, build.P]
    fn.restype = build.I
    return fn


def gram_cuda(x: torch.Tensor, r: torch.Tensor | None, out: torch.Tensor,
              alpha: float) -> None:
    """out += alpha · (X·r)ᵀ(X·r) on the card (shapes checked by ops)."""
    n, d = x.shape
    err = _lib()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                 None if r is None else r.data_ptr(), out.data_ptr(), n, d,
                 float(alpha), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "gram")
