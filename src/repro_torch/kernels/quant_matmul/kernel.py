"""ctypes launchers of the CUDA packed matmuls (``csrc/quant_matmul.cu``).

Weights may carry a leading head axis and be strided views of a parent
(``ops.mla_latent_weights``): the launchers pass the codes' and the group
parameters' row and head strides, so a view is never copied."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DECODE_MAX_M = 4  # m <= this takes the split-k decode shape
DECODE_COLS = 128  # output columns per decode block
DECODE_ROWS = 1024  # most k rows a decode block stages


def qmm_kernel(m: int, dtype: torch.dtype) -> str:
    """The kernel that ``quant_matmul_cuda`` launches for x of m rows: the
    split-k decode shape, else the tensor-core tile, in its bf16 form
    (``qmm_tc``) or its fp32 form, x split into three bf16 terms
    (``qmm_tc_f32``); ``qmm_launch`` routes the same way."""
    if m <= DECODE_MAX_M:
        return "qmm_decode"
    return "qmm_tc" if dtype == torch.bfloat16 else "qmm_tc_f32"


def qmm_t_kernel(m: int, bits: int, group_size: int) -> str:
    """The kernel that ``quant_matmul_t_cuda`` launches for x of m rows: the
    decode shape (m <= DECODE_MAX_M, m a template parameter; it needs a
    packed word to span at most two quant groups, group_size >= 32 //
    bits) or the fp32 tile.  The one owner of that choice: ``qmm_t_launch``
    launches the kernel it is given and refuses a decode launch it cannot
    serve."""
    if 1 <= m <= DECODE_MAX_M and group_size >= 32 // bits:
        return "qmm_t_decode"
    return "qmm_t_tile"


def _lib():
    fn = build.library("quant_matmul").qmm_launch
    fn.argtypes = [build.P, build.I, build.P, build.P, build.P, build.P,
                   build.P] + [build.I] * 12 + [build.P]
    fn.restype = build.I
    return fn


def _lib_t():
    fn = build.library("quant_matmul").qmm_t_launch
    fn.argtypes = [build.P] * 5 + [build.I] * 11 + [build.P]
    fn.restype = build.I
    return fn


def decode_splits(n_words: int, n: int, vpw: int, n_sm: int,
                  heads: int = 1) -> tuple[int, int]:
    """(splits, words_per_split) of the decode shape: enough k splits for
    four blocks per SM over all heads, and no more than DECODE_ROWS rows
    per block."""
    col_blocks = -(-n // DECODE_COLS) * heads
    max_wps = DECODE_ROWS // vpw
    splits = max(-(-n_words // max_wps), -(-4 * n_sm // col_blocks))
    splits = max(1, min(splits, n_words))
    wps = -(-n_words // splits)
    return -(-n_words // wps), wps


def _strides(w_packed: torch.Tensor, scale: torch.Tensor) -> list[int]:
    """[w_ld, w_hs, s_ld, s_hs]: row and head strides in elements (head
    strides 0 for a 2-D weight)."""
    hw = w_packed.stride(0) if w_packed.ndim == 3 else 0
    hs = scale.stride(0) if scale.ndim == 3 else 0
    return [w_packed.stride(-2), hw, scale.stride(-2), hs]


def quant_matmul_cuda(x: torch.Tensor, w_packed: torch.Tensor,
                      scale: torch.Tensor, zero: torch.Tensor, *, bits: int,
                      group_size: int) -> torch.Tensor:
    """(H, m, k) x packed (H, ceil(k/vpw), n) -> (H, m, n) in x.dtype, on
    the card (shapes, types and strides checked by ops)."""
    heads, m, k = x.shape
    n = w_packed.shape[-1]
    out = torch.empty((heads, m, n), dtype=x.dtype, device=x.device)
    partial, splits, wps = None, 0, 0
    if m <= DECODE_MAX_M:
        n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
        splits, wps = decode_splits(w_packed.shape[-2], n, 32 // bits, n_sm,
                                    heads)
        partial = torch.empty((heads, splits, m, n), dtype=torch.float32,
                              device=x.device)
    err = _lib()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                 w_packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
                 out.data_ptr(), None if partial is None else partial.data_ptr(),
                 heads, m, k, n, bits, group_size, splits, wps,
                 *_strides(w_packed, scale),
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "quant_matmul")
    return out


def quant_matmul_t_cuda(x: torch.Tensor, w_packed: torch.Tensor,
                        scale: torch.Tensor, zero: torch.Tensor, *, bits: int,
                        group_size: int, d_in: int,
                        kernel: str) -> torch.Tensor:
    """(H, m, d) fp32 x packed (H, ceil(d_in/vpw), d) -> (H, m, d_in) fp32:
    y = x @ Wᵀ on the card, by ``kernel`` (``qmm_t_kernel``'s choice)."""
    heads, m, d = x.shape
    out = torch.empty((heads, m, d_in), dtype=torch.float32, device=x.device)
    err = _lib_t()(x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(),
                   zero.data_ptr(), out.data_ptr(), heads, m, d, d_in, bits,
                   group_size, int(kernel == "qmm_t_decode"),
                   *_strides(w_packed, scale),
                   torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "quant_matmul_t")
    return out
