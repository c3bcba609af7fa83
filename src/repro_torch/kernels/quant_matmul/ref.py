"""Plain PyTorch versions: unpack + dequantize + matmul in fp32."""
from __future__ import annotations

import torch

from repro_torch.core.quantizer import unpack_codes
from repro_torch.device import matmul


def _dequant(w_packed: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
             *, bits: int, group_size: int, k: int) -> torch.Tensor:
    """(..., ceil(k/vpw), n) words -> (..., k, n) fp32 weight; the
    per-group (scale, zero) apply through a (..., g, group_size, n) view
    of the codes.  Leading axes (heads) carry through."""
    n = w_packed.shape[-1]
    g = scale.shape[-2]
    if g * group_size != k:
        raise ValueError(f"{g} groups of {group_size} != d_in {k}")
    lead = w_packed.shape[:-2]
    codes = unpack_codes(w_packed, bits, k).float()
    wg = codes.reshape(*lead, g, group_size, n) - zero.float()[..., None, :]
    return (wg * scale.float()[..., None, :]).reshape(*lead, k, n)


def quant_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor,
                     scale: torch.Tensor, zero: torch.Tensor, *, bits: int,
                     group_size: int, d_in: int | None = None) -> torch.Tensor:
    """x: (m, k) -> (m, n) in x.dtype; with head-batched weights (H,
    ceil(k/vpw), n), x: (H, m, k) -> (H, m, n)."""
    k = d_in if d_in is not None else x.shape[-1]
    w = _dequant(w_packed, scale, zero, bits=bits, group_size=group_size, k=k)
    return matmul(x.float(), w).to(x.dtype)


def quant_matmul_t_ref(x: torch.Tensor, w_packed: torch.Tensor,
                       scale: torch.Tensor, zero: torch.Tensor, *, bits: int,
                       group_size: int, d_in: int) -> torch.Tensor:
    """Transposed (latent-layout) product y = x @ dequant(W)ᵀ: the packed
    axis (d_in) is the output and the contraction runs over the weight's
    columns.  x: (..., m, d); w_packed: (..., ceil(d_in/vpw), d); returns
    (..., m, d_in) in x.dtype."""
    w = _dequant(w_packed, scale, zero, bits=bits, group_size=group_size,
                 k=d_in)
    return matmul(x.float(), w.transpose(-1, -2)).to(x.dtype)
