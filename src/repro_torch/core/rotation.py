"""Step 1 of RSQ: Rotate — randomized-Hadamard orthogonal transform of the
residual stream (QuaRot / SliceGPT computational invariance).

Convention (as in the reference): the stream is rotated ``x -> x @ Q``;
weights that consume the stream become ``Qᵀ W``, weights that produce it
become ``W Q``, and the embedding table becomes ``E Q``.  RMSNorm commutes
with Q only when its scale is 1, so the norms' γ are folded into the
consuming weights first.  Non-power-of-two dims use H_{2^k} ⊗ Q_m with a
random orthogonal Q_m.

``rotate_model`` takes an explicit Q so callers can hand it the reference's
own rotation (``jax.random`` draws cannot be reproduced by torch); without
one it draws Q from a ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig

_MIXER_IN = ("wq", "wk", "wv")
_MIXER_OUT = ("wo",)
_FFN_IN = ("wi", "wu")
_FFN_OUT = ("wd",)


def hadamard_matrix(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Orthonormal Hadamard matrix (Sylvester order); n a power of two."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"{n} is not a power of two")
    h = torch.ones((1, 1), dtype=dtype, device=device)
    while h.shape[0] < n:
        h = torch.cat([torch.cat([h, h], 1), torch.cat([h, -h], 1)], 0)
    return h / math.sqrt(n)


def _pow2_factor(n: int) -> tuple[int, int]:
    k = 1
    while n % (2 * k) == 0:
        k *= 2
    return k, n // k


def random_orthogonal(gen: torch.Generator, n: int, dtype=torch.float32
                      ) -> torch.Tensor:
    a = torch.randn((n, n), generator=gen, device=gen.device)
    q, r = torch.linalg.qr(a)
    return (q * torch.sign(torch.diagonal(r))[None, :]).to(dtype)


def random_hadamard(gen: torch.Generator, n: int, dtype=torch.float32
                    ) -> torch.Tensor:
    """Q = diag(s) · (H_{2^k} ⊗ Q_m) with a random ±1 diagonal s."""
    k2, m = _pow2_factor(n)
    h = hadamard_matrix(k2, dtype, gen.device)
    if m > 1:
        h = torch.kron(h, random_orthogonal(gen, m, dtype))
    s = torch.randint(0, 2, (n,), generator=gen, device=gen.device) * 2 - 1
    return s.to(dtype)[:, None] * h


def _scale_in(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """W' = diag(g) @ W for a stream-consuming weight (d_in, d_out)."""
    return (w.float() * g.float()[:, None]).to(w.dtype)


def fuse_norms_block(p: dict, cfg: ModelConfig) -> dict:
    """Fold the block's RMSNorm γ into its consuming weights (new dict)."""
    mixer, ffn = dict(p["mixer"]), dict(p["ffn"])
    for name in _MIXER_IN:
        mixer[name] = _scale_in(mixer[name], p["mixer_norm"])
    for name in _FFN_IN:
        ffn[name] = _scale_in(ffn[name], p["ffn_norm"])
    return {**p, "mixer": mixer, "ffn": ffn,
            "mixer_norm": torch.ones_like(p["mixer_norm"]),
            "ffn_norm": torch.ones_like(p["ffn_norm"])}


def rotate_block(p: dict, cfg: ModelConfig, q: torch.Tensor) -> dict:
    """Apply the stream rotation to one block (norms must be fused first)."""
    qf = q.float()

    def rot_in(w):  # (d_model, d_out) -> Qᵀ W
        return (qf.T @ w.float()).to(w.dtype)

    def rot_out(w):  # (d_in, d_model) -> W Q
        return (w.float() @ qf).to(w.dtype)

    mixer, ffn = dict(p["mixer"]), dict(p["ffn"])
    for name in _MIXER_IN:
        mixer[name] = rot_in(mixer[name])
    for name in _MIXER_OUT:
        mixer[name] = rot_out(mixer[name])
    for name in _FFN_IN:
        ffn[name] = rot_in(ffn[name])
    for name in _FFN_OUT:
        ffn[name] = rot_out(ffn[name])
    return {**p, "mixer": mixer, "ffn": ffn}


def rotate_model(params: dict, cfg: ModelConfig, q: torch.Tensor | None = None,
                 *, gen: torch.Generator | None = None) -> tuple[dict, dict]:
    """Fuse norms then rotate the whole model. Returns (params, {"q": Q}).

    ``q``: the (d_model, d_model) rotation; when None it is drawn with
    ``random_hadamard(gen, d_model)``."""
    if q is None:
        if gen is None:
            raise ValueError("rotate_model needs a rotation q or a generator")
        q = random_hadamard(gen, cfg.d_model)
    q = q.to(device=params["embed"].device, dtype=torch.float32)
    layers = [rotate_block(fuse_norms_block(b, cfg), cfg, q)
              for b in params["layers"]]
    head = _scale_in(params["head"], params["final_norm"])
    out = dict(params)
    out.update(
        layers=layers,
        final_norm=torch.ones_like(params["final_norm"]),
        embed=(params["embed"].float() @ q).to(params["embed"].dtype),
        head=(q.T @ head.float()).to(head.dtype))
    return out, {"q": q}
