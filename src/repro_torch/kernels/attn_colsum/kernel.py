"""ctypes launcher of the CUDA AttnCon kernels (``csrc/attn_colsum.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def _lib():
    fn = build.library("attn_colsum").attn_colsum_launch
    fn.argtypes = [build.P, build.P, build.I, build.P, build.P, build.P,
                   build.I, build.I, build.I, build.I, build.I, build.I,
                   build.P]
    fn.restype = build.I
    return fn


def attn_colsum_cuda(q: torch.Tensor, k: torch.Tensor,
                     splits: int) -> torch.Tensor:
    """Per-head column sums (B*H, T) fp32 on the card (shapes checked by
    ops): pass 1 writes (m, l) scratch, pass 2 adds into a zeroed col."""
    b, t, h, dh = q.shape
    kv = k.shape[2]
    m = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    col = torch.zeros_like(m)
    err = _lib()(q.data_ptr(), k.data_ptr(), int(q.dtype == torch.bfloat16),
                 m.data_ptr(), l.data_ptr(), col.data_ptr(), b, t, h, kv, dh,
                 splits,
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "attn_colsum")
    return col
