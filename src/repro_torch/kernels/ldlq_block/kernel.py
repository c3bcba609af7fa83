"""ctypes launcher of the CUDA in-block LDLQ solve (``csrc/ldlq_block.cu``).
Shapes, strides and types are checked by ``ops``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def _lib():
    fn = build.library("ldlq_block").ldlq_block_launch
    fn.argtypes = [build.P, build.L, build.P, build.L, build.L, build.P,
                   build.L, build.I, build.I, build.I, build.P, build.P,
                   build.P]
    fn.restype = build.I
    return fn


def plan(n: int, d_out: int) -> dict:
    """The launch shape a call of N matrices of d_out columns takes: lanes
    a column (R), threads a block and blocks along d_out."""
    fn = build.library("ldlq_block").ldlq_block_plan
    fn.argtypes = [build.I, build.I, build.P]
    fn.restype = build.I
    out = (ctypes.c_int * 3)()
    build.check(fn(n, d_out, out), "ldlq_block_plan")
    return {"lanes": out[0], "threads": out[1], "grid_x": out[2]}


def ldlq_block_cuda(wb: torch.Tensor, ub: torch.Tensor, scales: torch.Tensor,
                    deq: torch.Tensor, err: torch.Tensor) -> None:
    """One launch for the N matrices of ``wb`` (outputs preallocated)."""
    n, block, d_out = wb.shape
    code = _lib()(wb.data_ptr(), wb.stride(0), ub.data_ptr(), ub.stride(0),
                  ub.stride(1), scales.data_ptr(), scales.stride(0), n,
                  block, d_out, deq.data_ptr(), err.data_ptr(),
                  torch.cuda.current_stream(wb.device).cuda_stream)
    build.check(code, "ldlq_block")

