"""GPTQ / OBC solver in plain PyTorch (no kernel of its own).

The reference restructures the per-row recursion into 128-row blocks: rows
of a block are quantized one at a time with their error compensated inside
the block, and the compensation of all later rows is deferred to one dense
matmul per block.  This is the same algorithm, eager, one weight at a time.

Math (paper Eq. 2): quantize row i, then spread
    err = (w_i - quant(w_i)) / U_ii
over the later rows through the upper-Cholesky factor U of H⁻¹
(H⁻¹ = Uᵀ U).  RSQ enters only through H = 2 X R² Xᵀ (``hessian.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core.quantizer import QuantSpec, dequantize, quantize_rtn


def solver_params(w_group: torch.Tensor, spec: QuantSpec):
    """(scale, zero) of one group as the reference's compiled solver
    computes them.

    ``quantizer.find_params`` divides by the constant ``maxq * 0.5`` (or
    ``maxq``).  Inside the reference's jitted ``gptq_quantize`` XLA rewrites
    that division into a multiply by the constant's fp32 reciprocal, which
    rounds differently in the last bit and then flips codes that sit on a
    rounding boundary.  The solver reproduces the compiled form so that its
    codes match the reference's."""
    wf = w_group.float()
    maxq = spec.maxq
    if spec.sym:
        inv = torch.tensor(1.0 / (maxq * 0.5), dtype=torch.float32)
        scale = torch.clamp_min(wf.abs().amax(dim=0) * inv, 1e-9)
        zero = torch.full_like(scale, float((maxq + 1) // 2))
    else:
        lo = torch.clamp_max(wf.amin(dim=0), 0.0)
        hi = torch.clamp_min(wf.amax(dim=0), 0.0)
        inv = torch.tensor(1.0 / maxq, dtype=torch.float32)
        scale = torch.clamp_min((hi - lo) * inv, 1e-9)
        zero = torch.round(-lo / scale)
    return scale, zero


def prepare_hessian(h: torch.Tensor, damp: float = 0.01) -> torch.Tensor:
    """Symmetrize, fix dead rows, dampen."""
    hf = h.float()
    hf = 0.5 * (hf + hf.T)
    d = torch.diagonal(hf)
    dead = d <= 0.0
    hf = hf + torch.diag(dead.float())
    mean_d = torch.where(dead, 0.0, d).mean()
    eye = torch.eye(hf.shape[0], device=hf.device)
    return hf + damp * torch.clamp_min(mean_d, 1e-8) * eye


def _inv_upper(u: torch.Tensor) -> torch.Tensor:
    """Inverse of an upper-triangular matrix.

    The reference needs a hand-blocked inverse so that vmapped and single
    solves round identically; the port solves one weight at a time, so a
    triangular solve does the job."""
    eye = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
    return torch.linalg.solve_triangular(u, eye, upper=True)


def hinv_cholesky(h: torch.Tensor) -> torch.Tensor:
    """Upper-triangular U with H⁻¹ = Uᵀ U: factor the index-reversed H as
    L̃ L̃ᵀ, so H = Ũ Ũᵀ with Ũ = J L̃ J upper-triangular, and U = Ũ⁻¹."""
    lr = torch.linalg.cholesky(h.flip(0, 1))
    return _inv_upper(lr.flip(0, 1))


def gptq_quantize(w: torch.Tensor, h: torch.Tensor, spec: QuantSpec, *,
                  damp: float = 0.01, block: int = 128) -> dict:
    """w: (d_in, d_out); h: (d_in, d_in) (token scaling already inside).

    Returns ``w_deq`` (w's dtype), ``q`` int32 codes, ``scale``/``zero``
    (n_groups, d_out) and ``err``, the proxy loss
    sum_i ||(w_i - q_i) / U_ii||² (0-d tensor)."""
    d_in, d_out = w.shape
    block = min(block, d_in)
    if d_in % block:
        raise ValueError(f"d_in {d_in} is not a multiple of block {block}")
    gs = d_in if spec.group_size == -1 else spec.group_size
    if not ((gs <= block and block % gs == 0) or spec.group_size == -1):
        raise ValueError(f"group {gs} does not tile block {block}")
    rows_per_group = min(gs, block)

    u = hinv_cholesky(prepare_hessian(h, damp))
    wc = w.float().clone()
    q = torch.empty((d_in, d_out), dtype=torch.int32, device=w.device)
    deq = torch.empty((d_in, d_out), dtype=torch.float32, device=w.device)
    scales, zeros = [], []
    if gs > block:  # one global group, from the original weight
        s_cur, z_cur = solver_params(wc, spec)
        scales.append(s_cur)
        zeros.append(z_cur)
    err_total = torch.zeros((), dtype=torch.float32, device=w.device)
    for b0 in range(0, d_in, block):
        wb = wc[b0:b0 + block].clone()
        ub = u[b0:b0 + block, b0:b0 + block]
        errb = torch.empty((block, d_out), dtype=torch.float32,
                           device=w.device)
        for i in range(block):
            if gs <= block and i % rows_per_group == 0:
                # params from the current (already compensated) group rows
                s_cur, z_cur = solver_params(wb[i:i + rows_per_group], spec)
                scales.append(s_cur)
                zeros.append(z_cur)
            row = wb[i]
            qrow = quantize_rtn(row, s_cur, z_cur, spec)
            drow = dequantize(qrow, s_cur, z_cur)
            err = (row - drow) / ub[i, i]
            wb[i + 1:] -= ub[i, i + 1:, None] * err[None, :]
            q[b0 + i] = qrow
            deq[b0 + i] = drow
            errb[i] = err
        # deferred compensation of every row after this block: one matmul
        wc[b0 + block:] -= u[b0:b0 + block, b0 + block:].T @ errb
        err_total += (errb * errb).sum()
    return {"w_deq": deq.to(w.dtype), "q": q,
            "scale": torch.stack(scales), "zero": torch.stack(zeros),
            "err": err_total}
