"""Public wrapper of LDLQ's in-block row loop with the E8 rounder
(``ldlq_block``).

This kernel has no Pallas counterpart: in the reference XLA compiles the
loop (``repro/core/ldlq.py``'s ``row_step``, a ``fori_loop`` in the scan
over blocks, vmapped by ``ldlq_quantize_batched``).  Dispatch is by the
tensor's device and nothing else: a CPU tensor takes the plain version
(``ref``), a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ldlq_block.ref import ldlq_block_ref

MAX_BLOCK = 128  # the kernel stages a block's U tile of at most 128 rows


def ldlq_block(wb: torch.Tensor, ub: torch.Tensor, scales: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize one block of rows of N matrices to the scaled E8 lattice
    with LDLQ's in-block error compensation.

    wb: (N, block, d_out) fp32 rows (not modified), d_out a multiple of 8;
    ub: (N, block, block) fp32, the block's diagonal tile of the upper
    Cholesky factor of H⁻¹; scales: (N, block) fp32, each row's scale.
    Returns (deq, err), each (N, block, d_out) fp32."""
    if wb.ndim != 3 or ub.ndim != 3 or scales.ndim != 2:
        raise ValueError(f"wb must be (N, block, d_out), ub (N, block, "
                         f"block) and scales (N, block), got "
                         f"{tuple(wb.shape)}, {tuple(ub.shape)}, "
                         f"{tuple(scales.shape)}")
    n, block, d_out = wb.shape
    if ub.shape != (n, block, block) or scales.shape != (n, block):
        raise ValueError(f"ub must be ({n}, {block}, {block}) and scales "
                         f"({n}, {block}), got {tuple(ub.shape)}, "
                         f"{tuple(scales.shape)}")
    if d_out % 8:
        raise ValueError(f"d_out {d_out} is not a multiple of 8 (E8 "
                         f"rounds octets of a row)")
    if any(t.dtype != torch.float32 for t in (wb, ub, scales)):
        raise TypeError(f"ldlq_block takes fp32, not {wb.dtype}/"
                        f"{ub.dtype}/{scales.dtype}")
    if wb.device.type == "cpu":
        return ldlq_block_ref(wb, ub, scales)
    if wb.device.type != "cuda":
        raise ValueError(f"ldlq_block runs on cpu or cuda, not {wb.device}")
    from repro_torch.kernels.ldlq_block.kernel import ldlq_block_cuda

    if block > MAX_BLOCK:
        raise ValueError(f"the kernel takes blocks of at most {MAX_BLOCK} "
                         f"rows, not {block}")
    if ub.device != wb.device or scales.device != wb.device:
        raise ValueError("ub and scales must lie on wb's device")
    if wb.stride(2) != 1 or wb.stride(1) != d_out:
        wb = wb.contiguous()
    if ub.stride(2) != 1:
        ub = ub.contiguous()
    if scales.stride(1) != 1:
        scales = scales.contiguous()
    deq = torch.empty((n, block, d_out), dtype=torch.float32,
                      device=wb.device)
    err = torch.empty_like(deq)
    ldlq_block_cuda(wb, ub, scales, deq, err)
    ldlq_block.launches += 1
    return deq, err


ldlq_block.launches = 0
