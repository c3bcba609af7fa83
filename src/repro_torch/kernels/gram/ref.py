"""Plain PyTorch version of the weighted gram: (X·r)ᵀ(X·r) in fp32."""
from __future__ import annotations

import torch


def weighted_gram_ref(x: torch.Tensor, r: torch.Tensor | None = None
                      ) -> torch.Tensor:
    xf = x.float()
    if r is not None:
        xf = xf * r.reshape(-1, 1).float()
    return xf.T @ xf
