"""Step 3 input: weighted second-order statistics H = 2 · Xᵀ R² X.

``accumulate`` adds one calibration batch to a weight's Hessian through the
``gram`` kernel wrapper, which fuses r into its load: on a CUDA tensor that
is always the kernel, on a CPU tensor its plain version.  The accumulator
is updated in place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gram.ops import weighted_gram


def accumulate(h: torch.Tensor | None, x: torch.Tensor,
               r: torch.Tensor | None = None) -> torch.Tensor:
    """h: (d, d) fp32 or None; x: (N, d) tokens by features; r: (N,) token
    importances (None = uniform).  Returns h + 2·XᵀR²X (h updated in
    place)."""
    if x.ndim != 2:
        raise ValueError(f"accumulate takes (N, d) inputs, got {tuple(x.shape)}")
    return weighted_gram(x, r, out=h, alpha=2.0)


def reduce_shards(h: torch.Tensor) -> torch.Tensor:
    """Collapse a streaming (S, ...) partial-sum accumulator."""
    return h.sum(0)
