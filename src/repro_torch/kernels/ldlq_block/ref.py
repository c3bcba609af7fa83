"""Plain PyTorch version of LDLQ's in-block row loop with the E8 rounder,
for a stack of N independent matrices, and the rounder itself.

Every sum whose order can change its bits is spelled out left to right
(the CUDA kernel repeats the same order): the two 8-term squared
distances of ``e8_nearest`` and the parity's sum of an octet's rounded
coordinates.  ``torch.round`` rounds half to even, as ``jnp.round`` and
the kernel's ``rintf`` do; the parity is a floor-mod (``torch.remainder``);
the argmax of |δ| takes the first index on ties, the sign is +1 at δ >= 0,
and ``da <= db`` keeps the D8 point."""
from __future__ import annotations

import torch


def _sum8(v: torch.Tensor) -> torch.Tensor:
    """v[..., 0] + v[..., 1] + ... + v[..., 7], left to right."""
    s = v[..., 0]
    for j in range(1, 8):
        s = s + v[..., j]
    return s


def _nearest_d8(y: torch.Tensor) -> torch.Tensor:
    """Nearest point of D8 = {x in Z^8 : sum even}; y: (..., 8)."""
    f = torch.round(y)
    delta = y - f
    parity = torch.remainder(_sum8(f), 2.0)  # 0 even / 1 odd
    idx = torch.argmax(delta.abs(), dim=-1)  # the first index on ties
    sgn = torch.where(torch.gather(delta, -1, idx[..., None])[..., 0] >= 0,
                      1.0, -1.0)
    flip = torch.nn.functional.one_hot(idx, 8).to(y.dtype) * sgn[..., None]
    return f + flip * parity[..., None]


def e8_nearest(y: torch.Tensor) -> torch.Tensor:
    """Nearest point of E8 = D8 U (D8 + 1/2); y: (..., 8)."""
    a = _nearest_d8(y)
    b = _nearest_d8(y - 0.5) + 0.5
    da, db = y - a, y - b
    da = _sum8(da * da)
    db = _sum8(db * db)
    return torch.where((da <= db)[..., None], a, b)


def e8_quantize_row(row: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """row: (..., d_out) -> dequantized row via scaled-E8 rounding; scale
    broadcasts against row (one value a row)."""
    y = row / scale
    p = e8_nearest(y.reshape(y.shape[:-1] + (-1, 8)))
    return p.reshape(y.shape) * scale


def ldlq_block_ref(wb: torch.Tensor, ub: torch.Tensor, scales: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """wb: (N, block, d_out) rows of one block; ub: (N, block, block) the
    block's diagonal tile of U; scales: (N, block) each row's E8 scale.
    Returns (deq, err), each (N, block, d_out): the dequantized rows and
    (row - deq) / U_ii, each row compensated for the block's earlier rows'
    errors (w_j -= U_ij err_i, in the order of i) before it is rounded."""
    wb = wb.float().clone()
    n, block, d_out = wb.shape
    deq = torch.empty_like(wb)
    err = torch.empty_like(wb)
    for i in range(block):
        row = wb[:, i]
        d = e8_quantize_row(row, scales[:, i, None])
        e = (row - d) / ub[:, i, i, None]
        wb[:, i + 1:] -= ub[:, i, i + 1:, None] * e[:, None, :]
        deq[:, i] = d
        err[:, i] = e
    return deq, err


def tie_octets(n: int, step: float, seed: int = 0) -> torch.Tensor:
    """(n, 8) fp32 points on a grid of ``step`` (1/2 or 1/4) within
    [-4, 4]: every coordinate on a rounding tie or on a lattice coset, so
    that the rounder's tie rules (half to even, the first index of the
    largest |δ|, the sign at δ = 0, ``da <= db``) decide."""
    gen = torch.Generator().manual_seed(seed)
    k = torch.randint(-int(4 / step), int(4 / step) + 1, (n, 8),
                      generator=gen)
    return (k.double() * step).float()


def _reciprocal_fails(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Where fp32 x / v (fp64 x, v exact in fp32) is not what the product
    of x with v's fp64 reciprocal rounds to."""
    return x.float() / v.float() != (x * (1.0 / v)).float()


def subnormal_tie_inputs(block: int, d_out: int, seed: int = 0):
    """(wb, ub, scales) of one matrix, (1, block, d_out), (1, block, block)
    and (1, block) fp32 on the CPU, on which both divisions of every row,
    y = x / s_i and err = (x - deq) / U_ii, land exactly halfway between
    two fp32 subnormals.

    s_i = 2 B_s and U = diag(2 B_u) (B_s, B_u odd); row i holds x = ±m B_s
    B_u 2^-149 (m odd, m B_s B_u < 2^24), so y = ±m B_u 2^-150 rounds to
    the E8 point 0 (deq ±0, no compensation: U is diagonal) and err = ±m
    B_s 2^-150: each an odd multiple of 2^-150, which IEEE division rounds
    to the even neighbour.  Each x is one where the product of x with the
    fp64 reciprocal of either divisor rounds the other way: a division
    formed so fails on every element, twice."""
    odd = torch.arange(3, 1024, 2, dtype=torch.float64)
    m = torch.arange(1, 4096, 2, dtype=torch.float64)
    # divisors whose fp64 reciprocal misrounds the most such quotients
    rate = _reciprocal_fails(m[None] * odd[:, None] * 2.0 ** -149,
                             2.0 * odd[:, None]).double().mean(1)
    picked = odd[torch.argsort(rate, descending=True, stable=True)[:24]]
    rows = []
    for bs in picked.tolist():
        for bu in picked.tolist():
            if bu == bs:
                continue
            mm = torch.arange(1, 2 ** 24 // int(bs * bu), 2,
                              dtype=torch.float64)
            x = mm * bs * bu * 2.0 ** -149  # exact in fp32
            both = (_reciprocal_fails(x, torch.tensor(2.0 * bs,
                                                      dtype=torch.float64))
                    & _reciprocal_fails(x, torch.tensor(2.0 * bu,
                                                        dtype=torch.float64)))
            if int(both.sum()) >= 8:
                rows.append((2.0 * bs, 2.0 * bu, x[both]))
    gen = torch.Generator().manual_seed(seed)
    wb = torch.empty((1, block, d_out), dtype=torch.float32)
    ub = torch.zeros((1, block, block), dtype=torch.float32)
    scales = torch.empty((1, block), dtype=torch.float32)
    for i in range(block):
        si, ui, xs = rows[i % len(rows)]
        pick = torch.randint(len(xs), (d_out,), generator=gen)
        sign = torch.randint(2, (d_out,), generator=gen) * 2.0 - 1.0
        wb[0, i] = (xs[pick] * sign).float()
        ub[0, i, i] = ui
        scales[0, i] = si
    return wb, ub, scales
