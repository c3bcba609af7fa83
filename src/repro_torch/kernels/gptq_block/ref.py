"""Plain PyTorch version of GPTQ's in-block row loop, for a stack of N
independent matrices (the loop ``core/gptq`` ran eagerly, with a leading
batch axis: every step is elementwise or a reduction over one column, so
each matrix's bits do not depend on N)."""
from __future__ import annotations

import torch

from repro_torch.core.quantizer import QuantSpec, dequantize, quantize_rtn


def solver_params(w_group: torch.Tensor, spec: QuantSpec):
    """(scale, zero) of one group, reduced over dim -2, as the reference's
    compiled solver computes them.

    ``quantizer.find_params`` divides by the constant ``maxq * 0.5`` (or
    ``maxq``).  Inside the reference's jitted ``gptq_quantize`` XLA rewrites
    that division into a multiply by the constant's fp32 reciprocal, which
    rounds differently in the last bit and then flips codes that sit on a
    rounding boundary.  The solver reproduces the compiled form so that its
    codes match the reference's."""
    wf = w_group.float()
    maxq = spec.maxq
    inv = torch.tensor(inv_step(spec), dtype=torch.float32)
    if spec.sym:
        scale = torch.clamp_min(wf.abs().amax(dim=-2) * inv, 1e-9)
        zero = torch.full_like(scale, float((maxq + 1) // 2))
    else:
        lo = torch.clamp_max(wf.amin(dim=-2), 0.0)
        hi = torch.clamp_min(wf.amax(dim=-2), 0.0)
        scale = torch.clamp_min((hi - lo) * inv, 1e-9)
        zero = torch.round(-lo / scale)
    return scale, zero


def inv_step(spec: QuantSpec) -> float:
    """The reciprocal the group scale is multiplied by, rounded to fp32."""
    step = spec.maxq * 0.5 if spec.sym else spec.maxq
    return float(torch.tensor(1.0 / step, dtype=torch.float32))


def solve_block_ref(wb: torch.Tensor, ub: torch.Tensor, spec: QuantSpec,
                    rows_per_group: int, fixed=None):
    """wb: (N, block, d_out) rows of one block; ub: (N, block, block) the
    block's diagonal tile of U; ``fixed``: None, or the (scale, zero) pair
    (N, d_out) of one global group.  Returns (q int32, deq, err) each
    (N, block, d_out) and (scale, zero) each (N, groups, d_out), groups =
    block / rows_per_group (1, the fixed pair, when ``fixed`` is given)."""
    wb = wb.float().clone()
    n, block, d_out = wb.shape
    q = torch.empty((n, block, d_out), dtype=torch.int32, device=wb.device)
    deq = torch.empty((n, block, d_out), dtype=torch.float32,
                      device=wb.device)
    errb = torch.empty_like(deq)
    scales, zeros = [], []
    if fixed is not None:
        s_cur, z_cur = fixed
        scales.append(s_cur)
        zeros.append(z_cur)
    for i in range(block):
        if fixed is None and i % rows_per_group == 0:
            # params from the current (already compensated) group rows
            s_cur, z_cur = solver_params(wb[:, i:i + rows_per_group], spec)
            scales.append(s_cur)
            zeros.append(z_cur)
        row = wb[:, i]
        qrow = quantize_rtn(row, s_cur, z_cur, spec)
        drow = dequantize(qrow, s_cur, z_cur)
        err = (row - drow) / ub[:, i, i, None]
        wb[:, i + 1:] -= ub[:, i, i + 1:, None] * err[:, None, :]
        q[:, i] = qrow
        deq[:, i] = drow
        errb[:, i] = err
    return q, deq, errb, torch.stack(scales, 1), torch.stack(zeros, 1)


def subnormal_tie_inputs(block: int, d_out: int, seed: int = 0):
    """(wb, ub) of one matrix, (1, block, d_out) and (1, block, block) fp32
    on the CPU, on which every error (x - deq) / U_ii of the row loop lies
    exactly halfway between two fp32 subnormals.

    U is diagonal with U_ii = 2 B (B odd); row i holds x = ±m B 2^-149 (m
    odd, m B < 2^24), far below the 1e-9 floor of a group's scale, so q is
    the zero point, deq is 0 and the error is x / U_ii = ±m 2^-150, which
    IEEE division rounds to the even neighbour.  Each (m, B) is one where
    the product of x with the fp64 reciprocal of U_ii rounds the other
    way: a division formed so fails on every element."""
    b = torch.arange(3, 1024, 2, dtype=torch.float64)[:, None]
    m = torch.tensor([2.0 ** j - k for j in range(3, 23) for k in (1, 3, 5, 7)],
                     dtype=torch.float64)[None, :]
    x = m * b * 2.0 ** -149  # exact in fp32 where m B < 2^24
    u = (2.0 * b).expand_as(x)
    usable = (m * b < 2.0 ** 24) & (x.float() / u.float() != (x * (1.0 / u))
                                    .float())
    rows = [(u[k, 0], x[k][usable[k]]) for k in range(b.shape[0])
            if usable[k].any()]
    gen = torch.Generator().manual_seed(seed)
    wb = torch.empty((1, block, d_out), dtype=torch.float32)
    ub = torch.zeros((1, block, block), dtype=torch.float32)
    for i in range(block):
        ui, xs = rows[i % len(rows)]
        pick = torch.randint(len(xs), (d_out,), generator=gen)
        sign = torch.randint(2, (d_out,), generator=gen) * 2.0 - 1.0
        wb[0, i] = (xs[pick] * sign).float()
        ub[0, i, i] = float(ui)
    return wb, ub
