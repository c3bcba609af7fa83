"""Public wrappers: the fast Walsh-Hadamard transform for any width.

d = 2^k · m is handled as H_{2^k} ⊗ Q_m (Q_m a caller-supplied orthogonal
factor, e.g. from ``core.rotation.random_orthogonal``): reshape to (..., 2^k,
m), one dense fp32 product over the m axis, then the transform of the 2^k
axis.  Dispatch is by the tensor's device and nothing else: a CPU tensor
takes the plain version (``ref``), a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.hadamard.ref import fwht_ref, kron_transform

DTYPES = (torch.float32, torch.bfloat16)


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal Walsh-Hadamard transform over the last dim (a power of
    two), computed in fp32, returned in x's dtype; ``fwht(fwht(x)) == x``.

    The reference's ``rows_blk`` argument is a TPU tiling of the rows that
    changes no result; the port has none.  On the card d may be at most
    2^15 (``kernel.MAX_D``): a wider row raises."""
    d = x.shape[-1]
    if d < 1 or d & (d - 1):
        raise ValueError(f"fwht: d={d} must be a power of two")
    if x.device.type == "cpu":
        return fwht_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"fwht runs on cpu or cuda, not {x.device}")
    from repro_torch.kernels.hadamard.kernel import MAX_D, fwht_cuda

    if x.dtype not in DTYPES:
        raise TypeError(f"fwht kernel takes fp32/bf16, not {x.dtype}")
    if d > MAX_D:
        raise ValueError(f"fwht kernel: d={d} exceeds {MAX_D}; a row is "
                         f"transformed by one block in fp32 shared memory "
                         f"({MAX_D * 4 // 1024} KB at d={MAX_D})")
    x2 = x.reshape(-1, d).contiguous()
    if x2.shape[0] == 0:
        return x.clone()
    if x2.data_ptr() % 16:  # the kernel moves rows in 16-byte vectors
        x2 = x2.clone()
    out = fwht_cuda(x2)
    fwht.launches += 1
    return out.reshape(x.shape)


def hadamard_transform(x: torch.Tensor,
                       q_m: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ (H_{2^k} ⊗ Q_m) over the last dim, d = 2^k · m, as
    ``core.rotation`` composes it: Q_m (m, m), required when m > 1, is
    applied in fp32 by a plain product (the reference also computes it
    outside its kernel), the 2^k axis by :func:`fwht`, and the result is
    cast back to x's dtype (``ref.kron_transform``)."""
    return kron_transform(x, q_m, fwht)


fwht.launches = 0
