"""ctypes launcher of the CUDA packed matmul (``csrc/quant_matmul.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DECODE_MAX_M = 4  # m <= this takes the split-k decode shape
DECODE_COLS = 128  # output columns per decode block
DECODE_ROWS = 1024  # most k rows a decode block stages


def _lib():
    fn = build.library("quant_matmul").qmm_launch
    fn.argtypes = [build.P, build.I, build.P, build.P, build.P, build.P,
                   build.P, build.I, build.I, build.I, build.I, build.I,
                   build.I, build.I, build.P]
    fn.restype = build.I
    return fn


def decode_splits(n_words: int, n: int, vpw: int, n_sm: int) -> tuple[int, int]:
    """(splits, words_per_split) of the decode shape: enough k splits for
    four blocks per SM, and no more than DECODE_ROWS rows per block."""
    col_blocks = -(-n // DECODE_COLS)
    max_wps = DECODE_ROWS // vpw
    splits = max(-(-n_words // max_wps), -(-4 * n_sm // col_blocks))
    splits = max(1, min(splits, n_words))
    wps = -(-n_words // splits)
    return -(-n_words // wps), wps


def quant_matmul_cuda(x: torch.Tensor, w_packed: torch.Tensor,
                      scale: torch.Tensor, zero: torch.Tensor, *, bits: int,
                      group_size: int) -> torch.Tensor:
    """(m, k) x packed (ceil(k/vpw), n) -> (m, n) in x.dtype, on the card
    (shapes, types and contiguity checked by ops)."""
    m, k = x.shape
    n = w_packed.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    partial, splits, wps = None, 0, 0
    if m <= DECODE_MAX_M:
        n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
        splits, wps = decode_splits(w_packed.shape[0], n, 32 // bits, n_sm)
        partial = torch.empty((splits, m, n), dtype=torch.float32,
                              device=x.device)
    err = _lib()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                 w_packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
                 out.data_ptr(), None if partial is None else partial.data_ptr(),
                 m, k, n, bits, group_size, splits, wps,
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "quant_matmul")
    return out
