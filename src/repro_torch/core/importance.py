"""Step 2 of RSQ: Scale — token-importance strategies (paper Sec. 4.3).

Every strategy maps a layer's input Z (B, T, d) (plus, as it needs them,
the layer's output, the token ids with their corpus counts, or the
attention column sums) to importances R (B, T).  Dynamic strategies are
normalized into [r_min, r_max] per sample (paper Eq. 4); the heuristics
First-N and First&Last-N emit {0, 1} masks.  ``attn_con`` — the paper's
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
    z_out: Optional[torch.Tensor] = None  # (B, T, d) layer output (ActDiff)
    tokens: Optional[torch.Tensor] = None  # (B, T) token ids (TokenFreq)
    attn_colsum: Optional[torch.Tensor] = None  # (B, T) attention column mass
    token_counts: Optional[torch.Tensor] = None  # (vocab,) corpus counts


def normalize_scores(r: torch.Tensor, r_min: float, r_max: float
                     ) -> torch.Tensor:
    """Paper Eq. 4: per-sample linear map into [r_min, r_max]."""
    lo = r.amin(-1, keepdim=True)
    hi = r.amax(-1, keepdim=True)
    return r_min + (r - lo) / torch.clamp_min(hi - lo, 1e-12) * (r_max - r_min)


def uniform(inp: ImportanceInputs, **kw) -> torch.Tensor:
    b, t, _ = inp.z_in.shape
    return torch.ones((b, t), device=inp.z_in.device)


def first_n(inp: ImportanceInputs, *, n: int = 1024, **kw) -> torch.Tensor:
    b, t, _ = inp.z_in.shape
    mask = (torch.arange(t, device=inp.z_in.device) < n).float()
    return mask.expand(b, t)


def first_last_n(inp: ImportanceInputs, *, n: int = 1024,
                 **kw) -> torch.Tensor:
    b, t, _ = inp.z_in.shape
    idx = torch.arange(t, device=inp.z_in.device)
    mask = (idx < n // 2) | (idx >= t - n // 2)
    return mask.float().expand(b, t)


def token_freq(inp: ImportanceInputs, *, r_min: float = 0.01,
               r_max: float = 1.0, **kw) -> torch.Tensor:
    """Rarer tokens weigh more: the negated corpus count of each token."""
    if inp.tokens is None or inp.token_counts is None:
        raise ValueError("token_freq needs tokens and token_counts")
    raw = -inp.token_counts[inp.tokens].float()
    return normalize_scores(raw, r_min, r_max)


def act_norm(inp: ImportanceInputs, *, r_min: float = 0.005,
             r_max: float = 1.0, **kw) -> torch.Tensor:
    raw = torch.linalg.vector_norm(inp.z_in.float(), dim=-1)
    return normalize_scores(raw, r_min, r_max)


def act_diff(inp: ImportanceInputs, *, r_min: float = 0.01,
             r_max: float = 1.0, **kw) -> torch.Tensor:
    """Tokens the layer changes least weigh more: -||z_out - z_in||."""
    if inp.z_out is None:
        raise ValueError("act_diff needs z_out")
    diff = (inp.z_out - inp.z_in).float()
    return normalize_scores(-torch.linalg.vector_norm(diff, dim=-1),
                            r_min, r_max)


def token_sim(inp: ImportanceInputs, *, r_min: float = 0.005,
              r_max: float = 1.0, chunk: int = 512, **kw) -> torch.Tensor:
    """Sum of each token's L2 distances to all tokens of its sample, in
    chunks of ``chunk`` query tokens (the last one ragged), so the pairwise
    distances never take more than (B, chunk, T)."""
    z = inp.z_in.float()
    sq = (z * z).sum(-1)  # (B, T)
    raw = torch.empty_like(sq)
    for c0 in range(0, z.shape[1], chunk):
        z_c, sq_c = z[:, c0:c0 + chunk], sq[:, c0:c0 + chunk]
        d2 = (sq_c[:, :, None] + sq[:, None, :]
              - 2.0 * torch.einsum("bcd,btd->bct", z_c, z))
        raw[:, c0:c0 + chunk] = torch.sqrt(torch.clamp_min(d2, 0.0)).sum(-1)
    return normalize_scores(raw, r_min, r_max)


def attn_con(inp: ImportanceInputs, *, r_min: float = 0.01,
             r_max: float = 1.0, **kw) -> torch.Tensor:
    if inp.attn_colsum is None:  # attention-free layer -> ActNorm fallback
        return act_norm(inp, r_min=r_min, r_max=r_max)
    return normalize_scores(inp.attn_colsum.float(), r_min, r_max)


STRATEGIES: dict[str, Callable] = {
    "uniform": uniform,
    "first_n": first_n,
    "first_last_n": first_last_n,
    "token_freq": token_freq,
    "act_norm": act_norm,
    "act_diff": act_diff,
    "token_sim": token_sim,
    "attn_con": attn_con,
}


def get_strategy(name: str) -> Callable:
    if name not in STRATEGIES:
        raise KeyError(f"unknown importance strategy {name!r}; "
                       f"known: {sorted(STRATEGIES)}")
    return STRATEGIES[name]
