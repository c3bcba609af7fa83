"""Step 2 of RSQ: Scale — token-importance strategies (paper Sec. 4.3).

Every strategy maps a layer's input Z (B, T, d) (plus the attention column
sums) to importances R (B, T).  Dynamic strategies are normalized into
[r_min, r_max] per sample (paper Eq. 4).  ``attn_con`` — the paper's
choice — is the per-token attention column mass, computed by the
``attn_colsum`` kernel; attention-free layers fall back to ``act_norm``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class ImportanceInputs:
    z_in: torch.Tensor  # (B, T, d) layer input features
    attn_colsum: Optional[torch.Tensor] = None  # (B, T) attention column mass


def normalize_scores(r: torch.Tensor, r_min: float, r_max: float
                     ) -> torch.Tensor:
    """Paper Eq. 4: per-sample linear map into [r_min, r_max]."""
    lo = r.amin(-1, keepdim=True)
    hi = r.amax(-1, keepdim=True)
    return r_min + (r - lo) / torch.clamp_min(hi - lo, 1e-12) * (r_max - r_min)


def uniform(inp: ImportanceInputs, **kw) -> torch.Tensor:
    b, t, _ = inp.z_in.shape
    return torch.ones((b, t), device=inp.z_in.device)


def act_norm(inp: ImportanceInputs, *, r_min: float = 0.005,
             r_max: float = 1.0, **kw) -> torch.Tensor:
    raw = torch.linalg.vector_norm(inp.z_in.float(), dim=-1)
    return normalize_scores(raw, r_min, r_max)


def attn_con(inp: ImportanceInputs, *, r_min: float = 0.01,
             r_max: float = 1.0, **kw) -> torch.Tensor:
    if inp.attn_colsum is None:  # attention-free layer -> ActNorm fallback
        return act_norm(inp, r_min=r_min, r_max=r_max)
    return normalize_scores(inp.attn_colsum.float(), r_min, r_max)


STRATEGIES: dict[str, Callable] = {
    "uniform": uniform,
    "act_norm": act_norm,
    "attn_con": attn_con,
}


def get_strategy(name: str) -> Callable:
    if name not in STRATEGIES:
        raise KeyError(f"unknown importance strategy {name!r}; "
                       f"known: {sorted(STRATEGIES)}")
    return STRATEGIES[name]
