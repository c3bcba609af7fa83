"""GQA attention: chunked (flash-style) prefill attention, fp decode
attention and the GQA projections.

``flash_attention`` scans KV chunks with a running (max, denominator,
accumulator) triple and never forms the (T, T) score matrix, as the
reference does in jnp; it is plain PyTorch here because the reference's
version is not a Pallas kernel either.  The AttnCon column sums come from
the ``attn_colsum`` kernel (``models.lm.capture_block``), not from here.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import apply_rope, dense_init, linear

NEG_INF = -1e30


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, T, KV, Dh) -> (B, T, KV*n_rep, Dh); query head h reads KV head
    h // n_rep (``repeat_interleave``, not ``tile``)."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kv_chunk: int = 512) -> torch.Tensor:
    """Causal self-attention.  q: (B, T, H, Dh); k: (B, T, KV, Dh);
    v: (B, T, KV, Dv).  Returns (B, T, H, Dv) in q's dtype (fp32 softmax
    math)."""
    b, tq, h, dh = q.shape
    tk, kv_heads = k.shape[1], k.shape[2]
    n_rep = h // kv_heads
    kv_chunk = min(kv_chunk, tk)
    qf = q.float() * (dh ** -0.5)
    q_pos = torch.arange(tq, device=q.device)
    m = torch.full((b, tq, h), NEG_INF, device=q.device)
    l = torch.zeros((b, tq, h), device=q.device)
    acc = torch.zeros((b, tq, h, v.shape[-1]), device=q.device)
    for off in range(0, tk, kv_chunk):
        k_r = _repeat_kv(k[:, off:off + kv_chunk], n_rep).float()
        v_r = _repeat_kv(v[:, off:off + kv_chunk], n_rep).float()
        s = torch.einsum("bthd,bchd->bthc", qf, k_r)
        kv_pos = off + torch.arange(k_r.shape[1], device=q.device)
        mask = q_pos[:, None] >= kv_pos[None, :]
        s = torch.where(mask[None, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bthc,bchd->bthd", p, v_r)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """Single-token attention against a (B, S, KV, Dh) cache; positions
    > pos are masked.  q: (B, 1, H, Dh) -> (B, 1, H, Dv).  The query is
    grouped as (KV, G) and contracted against the un-repeated cache."""
    b, _, h, dh = q.shape
    s_len, kv_heads = k_cache.shape[1], k_cache.shape[2]
    g = h // kv_heads
    qf = (q.float() * (dh ** -0.5)).reshape(b, kv_heads, g, dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    valid = torch.arange(s_len, device=q.device) <= pos
    scores = torch.where(valid, scores, NEG_INF)
    mx = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - mx)
    denom = p.sum(-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    out = out / torch.clamp_min(denom, 1e-30)
    return out.reshape(b, 1, h, v_cache.shape[-1]).to(q.dtype)


# ------------------------------------------------------------------ GQA block


def init_gqa(gen, cfg, dtype, device) -> dict:
    d, h, kvh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, d, h * dh, dtype, device),
        "wk": dense_init(gen, d, kvh * dh, dtype, device),
        "wv": dense_init(gen, d, kvh * dh, dtype, device),
        "wo": dense_init(gen, h * dh, d, dtype, device),
    }


def gqa_qkv(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    b, t, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear(x, p["wq"]).reshape(b, t, h, dh)
    k = linear(x, p["wk"]).reshape(b, t, kvh, dh)
    v = linear(x, p["wv"]).reshape(b, t, kvh, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v
