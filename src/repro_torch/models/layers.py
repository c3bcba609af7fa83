"""Shared primitives: RMSNorm, RoPE, the ``linear`` projection dispatcher,
SwiGLU FFN, embedding, chunked cross-entropy, inits.

Conventions (as in the reference): weights are ``(in, out)`` and the
forward is ``y = linear(x, W)``; norm and softmax math runs in fp32 whatever
the activation dtype.  ``linear`` is the one seam between the model and the
weight representation: an fp tensor multiplies as ``x @ w``, a
``PackedWeight`` goes through the packed ``quant_matmul`` kernel without the
fp weight ever existing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import matmul
from repro_torch.kernels.quant_matmul.ops import is_packed, quant_matmul


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for an fp weight; ``quant_matmul`` for a ``PackedWeight``
    ((B, T, D) activations flatten to 2-D around the kernel).  An fp32
    weight under lower-precision activations (weights dequantized at load
    time) multiplies in fp32 and returns x's dtype, as the kernel does.

    An expert stack (E, d_in, d_out) takes x as (E, C, d_in) capacity
    buffers and keeps the expert axis (the reference's
    ``einsum('ecd,edf->ecf')``): a batched product for an fp stack, one
    head-batched ``quant_matmul`` launch for all E of a packed one."""
    if not is_packed(w):
        if w.dtype != x.dtype:
            return matmul(x.to(w.dtype), w).to(x.dtype)
        return matmul(x, w)
    if w.w_packed.ndim == 3:
        return quant_matmul(x, w)
    lead = x.shape[:-1]
    y = quant_matmul(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*lead, y.shape[-1])


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=gen, device=device,
                    dtype=torch.float32) * d_in ** -0.5
    return w.to(dtype)


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * g.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim // 2,) inverse frequencies."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Rotary embedding, half-split (not interleaved) as in the reference.
    x: (..., T, H, Dh); positions: broadcastable to (..., T)."""
    dh = x.shape[-1]
    inv_freq = rope_frequencies(dh, theta, x.device)
    angles = positions.float()[..., None] * inv_freq  # (..., T, Dh/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    xf = x.float()
    x1, x2 = xf[..., : dh // 2], xf[..., dh // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- FFN


def init_dense_ffn(gen, d_model: int, d_ff: int, dtype, device) -> dict:
    return {
        "wi": dense_init(gen, d_model, d_ff, dtype, device),  # gate
        "wu": dense_init(gen, d_model, d_ff, dtype, device),  # up
        "wd": dense_init(gen, d_ff, d_model, dtype, device),
    }


def apply_dense_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    return linear(F.silu(linear(x, p["wi"])) * linear(x, p["wu"]), p["wd"])


def capture_dense_ffn(p: dict, x: torch.Tensor):
    """Forward returning per-weight inputs for RSQ Hessian accumulation."""
    h = F.silu(linear(x, p["wi"])) * linear(x, p["wu"])
    y = linear(h, p["wd"])
    return y, {"wi": x, "wu": x, "wd": h}


def init_embedding(gen, vocab: int, d_model: int, dtype, device):
    e = torch.randn((vocab, d_model), generator=gen, device=device,
                    dtype=torch.float32) * 0.02
    return e.to(dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def cross_entropy_chunked(x: torch.Tensor, head_w, labels: torch.Tensor,
                          chunk: int = 512) -> torch.Tensor:
    """Mean token cross-entropy without materializing (B, T, V) logits:
    one T-chunk of fp32 logits at a time.  x: (B, T, D); labels: (B, T)."""
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for t0 in range(0, x.shape[1], chunk):
        logits = linear(x[:, t0:t0 + chunk], head_w).float()
        y = labels[:, t0:t0 + chunk]
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y[..., None])[..., 0]
        total = total + (lse - gold).sum()
    return total / labels.numel()
