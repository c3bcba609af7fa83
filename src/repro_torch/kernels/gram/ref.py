"""Plain PyTorch version of the weighted gram: (X·r)ᵀ(X·r) in fp32, for
one (n, d) x or a batch (E, n, d) of them."""
from __future__ import annotations

import torch


def weighted_gram_ref(x: torch.Tensor, r: torch.Tensor | None = None
                      ) -> torch.Tensor:
    xf = x.float()
    if r is not None:
        xf = xf * r[..., None].float()
    return xf.transpose(-2, -1) @ xf
