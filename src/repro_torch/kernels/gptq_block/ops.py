"""Public wrapper of GPTQ's in-block row loop (``solve_block``).

This kernel has no Pallas counterpart: in the reference XLA compiles the
loop (``repro/core/gptq.py``'s ``row_step``, a ``fori_loop`` in the scan
over blocks, vmapped by ``gptq_quantize_batched``).  Dispatch is by the
tensor's device and nothing else: a CPU tensor takes the plain version
(``ref``), a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantizer import QuantSpec
from repro_torch.kernels.gptq_block.ref import inv_step, solve_block_ref

MAX_BLOCK = 128  # the kernel's largest instance holds 128 rows a column


def solve_block(wb: torch.Tensor, ub: torch.Tensor, spec: QuantSpec,
                rows_per_group: int, fixed=None):
    """Quantize one block of rows of N matrices with GPTQ's in-block error
    compensation.

    wb: (N, block, d_out) fp32 rows (not modified); ub: (N, block, block)
    fp32, the block's diagonal tile of the upper Cholesky factor of H⁻¹;
    ``rows_per_group`` divides block; ``fixed``: None, or the fp32 (scale,
    zero) pair (N, d_out) of one global group.  Returns (q int32, deq, err)
    each (N, block, d_out) and (scale, zero) each (N, block /
    rows_per_group, d_out), or the fixed pair as (N, 1, d_out)."""
    if wb.ndim != 3 or ub.ndim != 3:
        raise ValueError(f"wb must be (N, block, d_out) and ub (N, block, "
                         f"block), got {tuple(wb.shape)}, {tuple(ub.shape)}")
    n, block, d_out = wb.shape
    if ub.shape != (n, block, block):
        raise ValueError(f"ub must be ({n}, {block}, {block}), got "
                         f"{tuple(ub.shape)}")
    if wb.dtype != torch.float32 or ub.dtype != torch.float32:
        raise TypeError(f"solve_block takes fp32, not {wb.dtype}/{ub.dtype}")
    if rows_per_group <= 0 or block % rows_per_group:
        raise ValueError(f"{rows_per_group} rows a group do not tile a "
                         f"block of {block}")
    if fixed is not None and any(t.shape != (n, d_out) or t.dtype !=
                                 torch.float32 for t in fixed):
        raise ValueError(f"fixed (scale, zero) must be fp32 ({n}, {d_out})")
    if wb.device.type == "cpu":
        return solve_block_ref(wb, ub, spec, rows_per_group, fixed)
    if wb.device.type != "cuda":
        raise ValueError(f"solve_block runs on cpu or cuda, not {wb.device}")
    from repro_torch.kernels.gptq_block.kernel import solve_block_cuda

    if block > MAX_BLOCK:
        raise ValueError(f"the kernel takes blocks of at most {MAX_BLOCK} "
                         f"rows, not {block}")
    if ub.device != wb.device or (fixed is not None and any(
            t.device != wb.device for t in fixed)):
        raise ValueError("ub and fixed must lie on wb's device")
    if wb.stride(2) != 1 or wb.stride(1) != d_out:
        wb = wb.contiguous()
    if ub.stride(2) != 1:
        ub = ub.contiguous()
    if fixed is not None:
        fixed = tuple(t.contiguous() for t in fixed)
    q = torch.empty((n, block, d_out), dtype=torch.int32, device=wb.device)
    deq = torch.empty((n, block, d_out), dtype=torch.float32,
                      device=wb.device)
    err = torch.empty_like(deq)
    if fixed is None:
        groups = block // rows_per_group
        scale = torch.empty((n, groups, d_out), dtype=torch.float32,
                            device=wb.device)
        zero = torch.empty_like(scale)
    else:
        scale = zero = None
    solve_block_cuda(wb, ub, spec.bits, spec.sym, rows_per_group,
                     inv_step(spec), fixed, q, deq, err, scale, zero)
    solve_block.launches += 1
    if fixed is not None:
        scale, zero = fixed[0][:, None], fixed[1][:, None]
    return q, deq, err, scale, zero


solve_block.launches = 0
