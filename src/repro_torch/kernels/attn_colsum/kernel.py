"""ctypes launcher of the CUDA AttnCon kernels (``csrc/attn_colsum.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def _lib():
    fn = build.library("attn_colsum").attn_colsum_launch
    fn.argtypes = [build.P, build.P, build.I, build.I, build.P, build.P] \
        + [build.I] * 5 + [build.P]
    fn.restype = build.I
    return fn


def _scratch_floats():
    fn = build.library("attn_colsum").attn_colsum_scratch
    fn.argtypes = [build.I] * 5
    fn.restype = ctypes.c_long
    return fn


def attn_colsum_cuda(q: torch.Tensor, k: torch.Tensor,
                     causal: bool = True) -> torch.Tensor:
    """(B, T) column sums over all query heads, fp32, on the card (shapes
    checked by ops), of the causal or the full softmax map: three
    launches, the scratch sized by the library."""
    b, t, h, dh = q.shape
    kv = k.shape[2]
    bf16 = int(q.dtype == torch.bfloat16)
    scratch = torch.empty((_scratch_floats()(b, t, h, kv, bf16),),
                          dtype=torch.float32, device=q.device)
    col = torch.empty((b, t), dtype=torch.float32, device=q.device)
    err = _lib()(q.data_ptr(), k.data_ptr(), bf16, int(causal),
                 scratch.data_ptr(), col.data_ptr(), b, t, h, kv, dh,
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "attn_colsum")
    return col
