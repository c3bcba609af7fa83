"""ctypes launchers of the CUDA packed matmuls (``csrc/quant_matmul.cu``).

Weights may carry a leading head axis and be strided views of a parent
(``ops.mla_latent_weights``): the launchers pass the codes' and the group
parameters' row and head strides, so a view is never copied."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DECODE_MAX_M = 4  # m <= this takes the decode kernel


def qmm_kernel(m: int, dtype: torch.dtype) -> str:
    """The kernel that ``quant_matmul_cuda`` launches for x of m rows: the
    decode kernel (its split-k plan is the C launcher's), else the
    tensor-core tile, in its bf16 form (``qmm_tc``) or its fp32 form, x
    split into three bf16 terms (``qmm_tc_f32``); ``qmm_launch`` routes
    the same way."""
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
    fn.argtypes = [build.P, build.I, build.P, build.P, build.P, build.P] \
        + [build.I] * 10 + [build.P]
    fn.restype = build.I
    return fn


def _lib_t():
    fn = build.library("quant_matmul").qmm_t_launch
    fn.argtypes = [build.P] * 5 + [build.I] * 11 + [build.P]
    fn.restype = build.I
    return fn


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
    err = _lib()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                 w_packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
                 out.data_ptr(), heads, m, k, n, bits, group_size,
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
