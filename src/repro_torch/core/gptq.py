"""GPTQ / OBC solver: one weight, or a stack of weights of one shape.

The reference restructures the per-row recursion into 128-row blocks: rows
of a block are quantized one at a time with their error compensated inside
the block, and the compensation of all later rows is deferred to one dense
matmul per block.  Here the in-block loop is one ``solve_block`` launch per
block for the whole stack (``kernels/gptq_block``: the CUDA kernel on the
card, its plain version on the CPU), and the deferred compensation a
batched product, which the reference also leaves to the compiler
(``torch.bmm`` here; TF32 stays off).

Math (paper Eq. 2): quantize row i, then spread
    err = (w_i - quant(w_i)) / U_ii
over the later rows through the upper-Cholesky factor U of H⁻¹
(H⁻¹ = Uᵀ U).  RSQ enters only through H = 2 X R² Xᵀ (``hessian.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core.quantizer import QuantSpec
from repro_torch.kernels.gptq_block.ops import solve_block
from repro_torch.kernels.gptq_block.ref import solver_params


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
    solves round identically; the port factors each matrix of a stack on
    its own, so a triangular solve does the job."""
    eye = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
    return torch.linalg.solve_triangular(u, eye, upper=True)


def hinv_cholesky_ex(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(U, info): upper-triangular U with H⁻¹ = Uᵀ U, and info 0 where H
    was positive definite.  Factor the index-reversed H as L̃ L̃ᵀ, so
    H = Ũ Ũᵀ with Ũ = J L̃ J upper-triangular, and U = Ũ⁻¹.  Nothing here
    waits for the device: ``check_factors`` reads info back."""
    lr, info = torch.linalg.cholesky_ex(h.flip(0, 1))
    return _inv_upper(lr.flip(0, 1)), info


def hinv_cholesky(h: torch.Tensor) -> torch.Tensor:
    """:func:`hinv_cholesky_ex`'s U, raising as ``torch.linalg.cholesky``
    does where H is not positive definite."""
    u, info = hinv_cholesky_ex(h)
    check_factors(info)
    return u


def check_factors(info: torch.Tensor) -> None:
    """Raise as ``torch.linalg.cholesky`` does where a factorization of
    ``factor_stack`` failed (one read-back of ``info``)."""
    if bool((info != 0).any()):
        raise torch.linalg.LinAlgError(
            f"a damped Hessian is not positive definite (cholesky_ex info "
            f"{info.flatten().tolist()})")


def factor_stack(hs: torch.Tensor, damp: float, check: bool = True,
                 dtype: torch.dtype = torch.float32
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(U (N, d, d) fp32, info (N,)) of each prepared H of a stack,
    factored on its own (so U rounds as in a single solve).  ``dtype``:
    the precision of the factorization and the triangular inverse (the
    prepared H is fp32; U is rounded to fp32 once).  ``check`` reads info
    back and raises on a failed factorization; without it the caller
    checks later (``check_factors``), and nothing waits for the device."""
    us, infos = zip(*(hinv_cholesky_ex(prepare_hessian(h, damp).to(dtype))
                      for h in hs))
    info = torch.stack(infos)
    if check:
        check_factors(info)
    return torch.stack(us).float(), info


def gptq_quantize(w: torch.Tensor, h: torch.Tensor, spec: QuantSpec, *,
                  damp: float = 0.01, block: int = 128) -> dict:
    """w: (d_in, d_out); h: (d_in, d_in) (token scaling already inside).

    Returns ``w_deq`` (w's dtype), ``q`` int32 codes, ``scale``/``zero``
    (n_groups, d_out) and ``err``, the proxy loss
    sum_i ||(w_i - q_i) / U_ii||² (0-d tensor).  The one-matrix case of
    :func:`gptq_quantize_batched`, bit for bit."""
    out = gptq_quantize_batched(w[None], h[None], spec, damp=damp,
                                block=block)
    return {k: v[0] for k, v in out.items()}


def gptq_quantize_batched(ws: torch.Tensor, hs: torch.Tensor,
                          spec: QuantSpec, *, damp: float = 0.01,
                          block: int = 128, check: bool = True) -> dict:
    """ws: (N, d_in, d_out); hs: (N, d_in, d_in): N independent solves
    (the counterpart of the reference's vmapped ``gptq_quantize_batched``).

    Returns the outputs of :func:`gptq_quantize` with a leading N axis
    (``err`` (N,)).  Each matrix's H is prepared and factored on its own, so
    U rounds as in a single solve; every block of rows is one
    ``solve_block`` call for all N.  With ``check=False`` a failed
    factorization does not raise here: ``info`` (N,) is returned for the
    caller to check (``check_factors``)."""
    n, d_in, d_out = ws.shape
    if hs.shape != (n, d_in, d_in):
        raise ValueError(f"hs must be ({n}, {d_in}, {d_in}), got "
                         f"{tuple(hs.shape)}")
    block = min(block, d_in)
    if d_in % block:
        raise ValueError(f"d_in {d_in} is not a multiple of block {block}")
    gs = d_in if spec.group_size == -1 else spec.group_size
    if not ((gs <= block and block % gs == 0) or spec.group_size == -1):
        raise ValueError(f"group {gs} does not tile block {block}")
    rows_per_group = min(gs, block)

    u, info = factor_stack(hs, damp, check)
    wc = ws.float().clone()
    # one global group, from the original weight
    fixed = solver_params(wc, spec) if gs > block else None
    qs, deqs, scales, zeros = [], [], [], []
    err_total = torch.zeros((n,), dtype=torch.float32, device=ws.device)
    for b0 in range(0, d_in, block):
        b1 = b0 + block
        q, deq, errb, s, z = solve_block(wc[:, b0:b1], u[:, b0:b1, b0:b1],
                                         spec, rows_per_group, fixed)
        if b1 < d_in:  # deferred compensation of every later row
            wc[:, b1:] -= torch.bmm(u[:, b0:b1, b1:].transpose(1, 2), errb)
        err_total += (errb * errb).sum((1, 2))
        qs.append(q)
        deqs.append(deq)
        if fixed is None or not scales:
            scales.append(s)
            zeros.append(z)
    out = {"w_deq": torch.cat(deqs, 1).to(ws.dtype), "q": torch.cat(qs, 1),
           "scale": torch.cat(scales, 1), "zero": torch.cat(zeros, 1),
           "err": err_total}
    if not check:
        out["info"] = info
    return out
