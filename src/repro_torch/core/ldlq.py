"""LDLQ + E8-lattice vector quantization (paper Sec. 5.4, Tab. 6).

LDLQ is the QuIP form of the GPTQ recursion; what differs is the
rounder: each weight row (d_out,) is quantized as d_out / 8 vectors of 8
to the scaled E8 lattice (nearest point through the D8 / D8 + ½ coset
decomposition), the construction under QuIP#'s E8P codebook.  As in the
reference, the lattice is the unbounded scaled E8 (not the pruned 2^16-
entry E8P ball), and the scale of a row is its RMS times ``scale_mult``,
from the original weight.

As ``core/gptq``: the in-block row loop is one ``ldlq_block`` launch per
block for a whole stack of N matrices (``kernels/ldlq_block``: the CUDA
kernel on the card, its plain version on the CPU), and the compensation of
every later row is deferred to one batched product a block (``torch.bmm``,
the reference's masked product ``(U_rows * mask)ᵀ @ err`` without its
zero terms).  An LDLQ solve has no integer codes, so nothing of it is
packed for serving.

U is factored in fp64 and rounded to fp32 once (``FACTOR_DTYPE``); the
rest of the solve is fp32, as the reference's.  E8 couples a row's 8
columns, so an error in U that flips one octet feeds 8 columns' errors to
every later row, and fp32 solves on factors a few 1e-5 apart part on a
sixth of a llama3-8b ``wk``'s octets.  With the rounded fp64 factor the
card's and the host's solves take the same U, and the same steps after
it, and land on the fp64 solve's lattice points (``chip_smoke.py``'s
``ldlq_path`` measures both).  GPTQ's rounder is one column's, and keeps
the fp32 factor.
"""
from __future__ import annotations

import torch

from repro_torch.core.gptq import factor_stack
from repro_torch.kernels.ldlq_block.ops import ldlq_block
from repro_torch.kernels.ldlq_block.ref import (_nearest_d8,  # noqa: F401
                                                e8_nearest, e8_quantize_row)

FACTOR_DTYPE = torch.float64  # the precision of H's factorization


def row_scales(w0: torch.Tensor, scale_mult: float = 0.5) -> torch.Tensor:
    """(..., d_in, 1) E8 scales of the rows of fp32 ``w0`` (..., d_in,
    d_out): max(sqrt(mean(w0²)) · scale_mult, 1e-8), from the original
    weight.  The mean and the root are taken in fp64 and rounded to fp32
    once, so the scales do not depend on a device's summation order.  The
    reference sums in fp32 in XLA's order and lands up to 2 ulps from
    them; an fp32 sum in torch's order lands no nearer
    (``tests/test_torch_ldlq.py``)."""
    w64 = w0.double()
    rms = torch.sqrt(torch.mean(w64 * w64, dim=-1, keepdim=True))
    return torch.clamp_min((rms * scale_mult).float(), 1e-8)


def ldlq_quantize(w: torch.Tensor, h: torch.Tensor, *, damp: float = 0.01,
                  block: int = 128, scale_mult: float = 0.5) -> dict:
    """w: (d_in, d_out), d_out % 8 == 0; h: (d_in, d_in).  Returns
    ``w_deq`` (w's dtype), ``err`` (the proxy loss sum_i ||(w_i - deq_i) /
    U_ii||², 0-d) and ``scales`` (d_in, 1).  The one-matrix case of
    :func:`ldlq_quantize_batched`, bit for bit."""
    out = ldlq_quantize_batched(w[None], h[None], damp=damp, block=block,
                                scale_mult=scale_mult)
    return {k: v[0] for k, v in out.items()}


def ldlq_quantize_batched(ws: torch.Tensor, hs: torch.Tensor, *,
                          damp: float = 0.01, block: int = 128,
                          scale_mult: float = 0.5, check: bool = True) -> dict:
    """ws: (N, d_in, d_out); hs: (N, d_in, d_in): N independent solves
    (the counterpart of the reference's vmapped ``ldlq_quantize_batched``).
    Returns the outputs of :func:`ldlq_quantize` with a leading N axis;
    ``check`` as in ``core.gptq.gptq_quantize_batched`` (without it,
    ``info`` (N,) is returned too)."""
    n, d_in, d_out = ws.shape
    if d_out % 8:
        raise ValueError(f"d_out {d_out} is not a multiple of 8")
    if hs.shape != (n, d_in, d_in):
        raise ValueError(f"hs must be ({n}, {d_in}, {d_in}), got "
                         f"{tuple(hs.shape)}")
    block = min(block, d_in)
    if d_in % block:
        raise ValueError(f"d_in {d_in} is not a multiple of block {block}")
    u, info = factor_stack(hs, damp, check, FACTOR_DTYPE)
    w0 = ws.float()
    scales = row_scales(w0, scale_mult)
    wc = w0.clone()
    deqs = []
    err_total = torch.zeros((n,), dtype=torch.float32, device=ws.device)
    for b0 in range(0, d_in, block):
        b1 = b0 + block
        deq, errb = ldlq_block(wc[:, b0:b1], u[:, b0:b1, b0:b1],
                               scales[:, b0:b1, 0])
        if b1 < d_in:  # deferred compensation of every later row
            wc[:, b1:] -= torch.bmm(u[:, b0:b1, b1:].transpose(1, 2), errb)
        err_total += (errb * errb).sum((1, 2))
        deqs.append(deq)
    out = {"w_deq": torch.cat(deqs, 1).to(ws.dtype), "err": err_total,
           "scales": scales}
    if not check:
        out["info"] = info
    return out
