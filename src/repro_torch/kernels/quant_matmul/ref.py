"""Plain PyTorch version: unpack + dequantize + matmul in fp32."""
from __future__ import annotations

import torch

from repro_torch.core.quantizer import unpack_codes
from repro_torch.device import matmul


def quant_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor,
                     scale: torch.Tensor, zero: torch.Tensor, *, bits: int,
                     group_size: int, d_in: int | None = None) -> torch.Tensor:
    """x: (m, k) -> (m, n) in x.dtype; the per-group (scale, zero) are
    applied through a (g, group_size, n) view of the codes."""
    k = d_in if d_in is not None else x.shape[-1]
    n = w_packed.shape[-1]
    g = scale.shape[-2]
    if g * group_size != k:
        raise ValueError(f"{g} groups of {group_size} != d_in {k}")
    codes = unpack_codes(w_packed, bits, k).float()
    wg = codes.reshape(g, group_size, n) - zero.float()[:, None]
    w = (wg * scale.float()[:, None]).reshape(k, n)
    return matmul(x.float(), w).to(x.dtype)
