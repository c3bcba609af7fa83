"""Dataset expansion (paper Sec. 4.4): augment each calibration sample with
M-1 circular shifts by k·T/M so every token visits the "important"
positions (initial/final) that position-biased strategies favor."""
from __future__ import annotations

import torch


def expand_dataset(tokens: torch.Tensor, m: int = 8) -> torch.Tensor:
    """tokens: (N, T) -> (N * M, T); shift k inserts the last k·T/M tokens at
    the beginning (circular roll); sample i's M shifts are rows i·M .. i·M +
    M - 1."""
    if m <= 1:
        return tokens
    n, t = tokens.shape
    rolled = [torch.roll(tokens, (k * t) // m, dims=1) for k in range(m)]
    return torch.stack(rolled, dim=1).reshape(n * m, t)
