"""Plain PyTorch versions of the fast Walsh-Hadamard transform."""
from __future__ import annotations

import math

import torch

# the port's normalised fp32 Hadamard matrix (Sylvester order) and the
# 2^k · m split of a width, as the rotation uses them
from repro_torch.core.rotation import (  # noqa: F401
    hadamard_matrix, pow2_factor)


def inv_sqrt(d: int) -> float:
    """The orthonormal factor 1/sqrt(d), as the kernel and this version
    apply it (one fp32 multiply at the end)."""
    return 1.0 / math.sqrt(d)


def fwht_ref(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal Walsh-Hadamard transform along the last dim (a power of
    two): log2 d butterfly stages ``[a + b, a - b]`` in fp32, then times
    1/sqrt(d), cast back to x's dtype.  Equals ``x @ hadamard_matrix(d)``
    up to fp32 rounding."""
    d = x.shape[-1]
    if d < 1 or d & (d - 1):
        raise ValueError(f"d={d} must be a power of two")
    y = x.float().reshape(-1, d)
    n = y.shape[0]
    h = 1
    while h < d:
        pairs = y.reshape(n, d // (2 * h), 2, h)
        a, b = pairs[:, :, 0], pairs[:, :, 1]
        y = torch.stack([a + b, a - b], dim=2).reshape(n, d)
        h *= 2
    return (y * inv_sqrt(d)).reshape(x.shape).to(x.dtype)


def kron_transform(x: torch.Tensor, q_m: torch.Tensor | None,
                   transform) -> torch.Tensor:
    """y = x @ (H_{2^k} ⊗ Q_m) over the last dim, d = 2^k · m, as
    ``core.rotation`` composes it (the Kronecker factors act on x reshaped
    to (..., 2^k, m)): Q_m (m, m), required when m > 1, in fp32 by a plain
    product, then ``transform`` (an orthonormal FWHT of rows) over the 2^k
    axis; cast back to x's dtype."""
    d = x.shape[-1]
    k2, m = pow2_factor(d)
    if m == 1:
        return transform(x)
    if q_m is None or tuple(q_m.shape) != (m, m):
        raise ValueError(f"hadamard_transform: d={d} = {k2}·{m} needs a "
                         f"({m}, {m}) q_m, got "
                         f"{None if q_m is None else tuple(q_m.shape)}")
    lead = x.shape[:-1]
    xr = x.float().reshape(*lead, k2, m)
    xr = torch.einsum("...km,mn->...kn", xr,
                      q_m.to(device=x.device, dtype=torch.float32))
    xr = xr.transpose(-1, -2).reshape(-1, k2)  # (..., m, 2^k) rows
    xr = transform(xr).reshape(*lead, m, k2)
    return xr.transpose(-1, -2).reshape(*lead, d).to(x.dtype)


def hadamard_transform_ref(x: torch.Tensor,
                           q_m: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`kron_transform` with the plain butterfly."""
    return kron_transform(x, q_m, fwht_ref)
