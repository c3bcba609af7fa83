"""ctypes launcher of the CUDA in-block GPTQ solve (``csrc/gptq_block.cu``).
Shapes, strides and types are checked by ``ops``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

L = ctypes.c_longlong


def _lib():
    fn = build.library("gptq_block").gptq_block_launch
    fn.argtypes = [build.P, L, build.P, L, L, build.I, build.I, build.I,
                   build.I, build.I, build.I, build.F, build.P, build.P,
                   build.P, build.P, build.P, build.P, build.P, build.P]
    fn.restype = build.I
    return fn


def plan(n: int, block: int, d_out: int, rows_per_group: int,
         fixed: bool) -> dict:
    """The kernel instance and launch shape a call takes: lanes a column
    (R), threads a block, blocks along d_out, and whether a group may start
    at any row (else only at a round's first row)."""
    fn = build.library("gptq_block").gptq_block_plan
    fn.argtypes = [build.I, build.I, build.I, build.I, build.I, build.P]
    fn.restype = build.I
    out = (ctypes.c_int * 4)()
    build.check(fn(n, block, d_out, rows_per_group, int(fixed), out),
                "gptq_block_plan")
    return {"lanes": out[0], "threads": out[1], "grid_x": out[2],
            "every_row": bool(out[3])}


def solve_block_cuda(wb: torch.Tensor, ub: torch.Tensor, bits: int,
                     sym: bool, rows_per_group: int, inv: float, fixed,
                     q, deq, err, scale, zero) -> None:
    """One launch for the N matrices of ``wb`` (outputs preallocated)."""
    n, block, d_out = wb.shape
    fs, fz = (None, None) if fixed is None else (fixed[0].data_ptr(),
                                                 fixed[1].data_ptr())
    code = _lib()(wb.data_ptr(), wb.stride(0), ub.data_ptr(), ub.stride(0),
                  ub.stride(1), n, block, d_out, bits, int(sym),
                  rows_per_group, inv, fs, fz, q.data_ptr(), deq.data_ptr(),
                  err.data_ptr(),
                  None if scale is None else scale.data_ptr(),
                  None if zero is None else zero.data_ptr(),
                  torch.cuda.current_stream(wb.device).cuda_stream)
    build.check(code, "gptq_block")
