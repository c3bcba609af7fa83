"""Plain PyTorch version of AttnCon: the kernel's two passes, blocked.

Pass 1 keeps each query's running max and denominator over key blocks;
pass 2 sums exp(s - m_i) / l_i down each key column over query blocks.
Scores are never held for more than one (blk x T) slab per head."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attn_colsum_ref(q: torch.Tensor, k: torch.Tensor, *,
                    causal: bool = True, blk: int = 256) -> torch.Tensor:
    """q: (B, T, H, Dh), k: (B, T, KV, Dh) -> (B, T) fp32 scores
    sum_{h, i} softmax(q kᵀ / sqrt(Dh))[h, i, j]; query head h reads key
    head h // (H // KV).  ``causal`` masks the keys after each query (a
    decoder); without it every query sees every key (an encoder)."""
    b, t, h, dh = q.shape
    n_rep = h // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)  # (B, H, T, Dh)
    kf = k.float().repeat_interleave(n_rep, dim=2).permute(0, 2, 1, 3)
    scale = dh ** -0.5
    pos = torch.arange(t, device=q.device)

    m = torch.full((b, h, t), NEG_INF, device=q.device)
    l = torch.zeros((b, h, t), device=q.device)
    for j0 in range(0, t, blk):
        kp = pos[j0:j0 + blk]
        s = (qf @ kf[:, :, j0:j0 + blk].transpose(-1, -2)) * scale
        if causal:
            s = s.masked_fill(pos[:, None] < kp[None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(-1)
        m = m_new

    col = torch.zeros((b, h, t), device=q.device)
    inv_l = 1.0 / torch.clamp_min(l, 1e-30)
    for i0 in range(0, t, blk):
        qp = pos[i0:i0 + blk]
        s = (qf[:, :, i0:i0 + blk] @ kf.transpose(-1, -2)) * scale
        p = torch.exp(s - m[:, :, i0:i0 + blk, None]) * inv_l[:, :, i0:i0 + blk, None]
        if causal:
            p = p.masked_fill(qp[:, None] < pos[None, :], 0.0)
        col += p.sum(-2)
    return col.sum(1)
