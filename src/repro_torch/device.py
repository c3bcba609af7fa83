"""Device selection shared by the entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  Asking for
``cuda`` on a machine without a card raises: nothing carries on quietly on
the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is "
            "False; pass --device cpu (CLIs) or device='cpu' to run the "
            "plain-PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def generator(seed: int, device: torch.device | str = "cpu") -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(seed)
    return g


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` whose rows do not depend on how many rows share the call.

    The CPU's BLAS multiplies a lone row (``gemv``) with its sums in another
    order than it gives the same row inside a product of two or more rows
    (``gemm``), so a request decoded alone and the same request decoded in
    a batch would differ in the last bit.  On the CPU a lone row is padded
    to two; on the card this is ``a @ b``."""
    if a.device.type == "cpu" and a.ndim >= 2 and a.shape[-2] == 1:
        return (torch.cat([a, a], dim=-2) @ b)[..., :1, :]
    return a @ b
