"""Public wrapper for the weighted-gram Hessian kernel.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes the
plain version (``ref``), a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gram.ref import weighted_gram_ref


def weighted_gram(x: torch.Tensor, r: torch.Tensor | None = None, *,
                  out: torch.Tensor | None = None,
                  alpha: float = 1.0) -> torch.Tensor:
    """``out + alpha · (X·r)ᵀ(X·r)`` with fp32 accumulation.

    x: (n, d) fp32 or bf16; r: (n,) or None (all ones); out: (d, d) fp32
    accumulator, updated in place and returned (a fresh zero matrix when
    None)."""
    if x.ndim != 2:
        raise ValueError(f"x must be (n, d), got {tuple(x.shape)}")
    n, d = x.shape
    if out is None:
        out = torch.zeros((d, d), dtype=torch.float32, device=x.device)
    if out.shape != (d, d) or out.dtype != torch.float32:
        raise ValueError(f"out must be ({d}, {d}) float32")
    if r is not None and r.shape != (n,):
        raise ValueError(f"r must be ({n},), got {tuple(r.shape)}")
    if x.device.type == "cpu":
        return out.add_(weighted_gram_ref(x, r), alpha=alpha)
    if x.device.type != "cuda":
        raise ValueError(f"weighted_gram runs on cpu or cuda, not {x.device}")
    from repro_torch.kernels.gram.kernel import gram_cuda

    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weighted_gram kernel takes fp32/bf16, not {x.dtype}")
    if not (out.is_contiguous() and out.device == x.device):
        raise ValueError("out must be a contiguous tensor on x's device")
    x = x.contiguous()
    if r is not None:
        r = r.to(device=x.device, dtype=torch.float32).contiguous()
    gram_cuda(x, r, out, alpha)
    weighted_gram.launches += 1
    return out


weighted_gram.launches = 0
