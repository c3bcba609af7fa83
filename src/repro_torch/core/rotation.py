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

# stream-consuming and stream-producing mixer weights (GQA, MLA, Mamba;
# qkv biases and Mamba's gated ``norm`` act after the stream side and stay)
_MIXER_IN = ("wq", "wk", "wv", "wq_a", "wkv_a", "wzx", "wbc", "wdt")
_MIXER_OUT = ("wo", "out_proj")
# MLA's internal norms and the up-projections that consume them
_MLA_NORMS = (("q_norm", "wq_b"), ("kv_norm", "wkv_b"))
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


def pow2_factor(n: int) -> tuple[int, int]:
    k = 1
    while n % (2 * k) == 0:
        k *= 2
    return k, n // k


def random_orthogonal(gen: torch.Generator, n: int, dtype=torch.float32
                      ) -> torch.Tensor:
    a = torch.randn((n, n), generator=gen, device=gen.device)
    q, r = torch.linalg.qr(a)
    # QR hands back a column-major Q, which torch.kron cannot take
    return (q * torch.sign(torch.diagonal(r))[None, :]).to(dtype).contiguous()


def random_hadamard(gen: torch.Generator, n: int, dtype=torch.float32
                    ) -> torch.Tensor:
    """Q = diag(s) · (H_{2^k} ⊗ Q_m) with a random ±1 diagonal s."""
    k2, m = pow2_factor(n)
    h = hadamard_matrix(k2, dtype, gen.device)
    if m > 1:
        h = torch.kron(h, random_orthogonal(gen, m, dtype))
    s = torch.randint(0, 2, (n,), generator=gen, device=gen.device) * 2 - 1
    return s.to(dtype)[:, None] * h


def _scale_in(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """W' = diag(g) @ W for a stream-consuming weight (d_in, d_out)."""
    return (w.float() * g.float()[:, None]).to(w.dtype)


def _scale_stack_in(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """diag(g) @ W_e for every expert e of an (E, d_in, d_out) stack."""
    return (w.float() * g.float()[None, :, None]).to(w.dtype)


def _each_expert(fn, w: torch.Tensor) -> torch.Tensor:
    """``fn`` on every matrix of an (E, ·, ·) stack, one at a time: the
    2-D product's rounding, and no fp32 copy of the whole stack."""
    out = torch.empty_like(w)
    for e in range(w.shape[0]):
        out[e] = fn(w[e])
    return out


def fuse_norms_block(p: dict, cfg: ModelConfig) -> dict:
    """Fold the block's RMSNorm γ into its consuming weights (new dict);
    MLA's q_norm and kv_norm fold into wq_b and wkv_b, a Mamba block's
    mixer norm into wzx, wbc and wdt.  The FFN norm of a block that has an
    FFN (every block but mamba2's; a jamba Mamba block's too) folds into
    its wi / wu, or for routed experts into the router, each expert's wi /
    wu and, where there is one, the shared FFN's wi / wu."""
    mixer = dict(p["mixer"])
    for name in _MIXER_IN:
        if name in mixer:
            mixer[name] = _scale_in(mixer[name], p["mixer_norm"])
    for norm, name in _MLA_NORMS:
        if norm in mixer:
            mixer[name] = _scale_in(mixer[name], mixer[norm])
            mixer[norm] = torch.ones_like(mixer[norm])
    out = {**p, "mixer": mixer,
           "mixer_norm": torch.ones_like(p["mixer_norm"])}
    if "ffn" not in p:
        return out
    ffn, gf = dict(p["ffn"]), p["ffn_norm"]
    for name in _FFN_IN:
        if name in ffn:
            ffn[name] = _scale_in(ffn[name], gf)
    if "router" in ffn:
        ffn["router"] = _scale_in(ffn["router"], gf)
        ffn["experts"] = dict(ffn["experts"])
        for name in _FFN_IN:
            ffn["experts"][name] = _scale_stack_in(ffn["experts"][name], gf)
        if "shared" in ffn:
            ffn["shared"] = {k: (_scale_in(v, gf) if k in _FFN_IN else v)
                             for k, v in ffn["shared"].items()}
    return {**out, "ffn": ffn, "ffn_norm": torch.ones_like(p["ffn_norm"])}


def _rotate_ffn(ffn: dict, rot_in, rot_out) -> dict:
    """A dense FFN's wi / wu become Qᵀ W and its wd W Q."""
    ffn = dict(ffn)
    for name in _FFN_IN:
        ffn[name] = rot_in(ffn[name])
    for name in _FFN_OUT:
        ffn[name] = rot_out(ffn[name])
    return ffn


def rotate_block(p: dict, cfg: ModelConfig, q: torch.Tensor) -> dict:
    """Apply the stream rotation to one block (norms must be fused first):
    its mixer's stream-side weights (attention or Mamba), then its FFN, if
    it has one.  A routed-expert FFN: the router is Qᵀ W, every expert's
    wi / wu Qᵀ W_e and its wd W_e Q, the shared FFN (where there is one)
    as a dense one."""
    qf = q.float()

    def rot_in(w):  # (d_model, d_out) -> Qᵀ W
        return (qf.T @ w.float()).to(w.dtype)

    def rot_out(w):  # (d_in, d_model) -> W Q
        return (w.float() @ qf).to(w.dtype)

    mixer = dict(p["mixer"])
    for name in _MIXER_IN:
        if name in mixer:
            mixer[name] = rot_in(mixer[name])
    for name in _MIXER_OUT:
        if name in mixer:
            mixer[name] = rot_out(mixer[name])
    if "ffn" not in p:
        return {**p, "mixer": mixer}
    ffn = p["ffn"]
    if "router" not in ffn:
        return {**p, "mixer": mixer, "ffn": _rotate_ffn(ffn, rot_in, rot_out)}
    ex = ffn["experts"]
    ffn = dict(ffn, router=rot_in(ffn["router"]), experts={
        "wi": _each_expert(rot_in, ex["wi"]),
        "wu": _each_expert(rot_in, ex["wu"]),
        "wd": _each_expert(rot_out, ex["wd"])})
    if "shared" in ffn:
        ffn["shared"] = _rotate_ffn(ffn["shared"], rot_in, rot_out)
    return {**p, "mixer": mixer, "ffn": ffn}


def rotation_matrix(params: dict, cfg: ModelConfig,
                    q: torch.Tensor | None = None,
                    gen: torch.Generator | None = None) -> torch.Tensor:
    """The fp32 (d_model, d_model) Q on the model's device: ``q`` itself,
    or when None a ``random_hadamard(gen, d_model)`` draw."""
    if q is None:
        if gen is None:
            raise ValueError("rotate_model needs a rotation q or a generator")
        q = random_hadamard(gen, cfg.d_model)
    return q.to(device=params["embed"].device, dtype=torch.float32)


def rotate_layer(p: dict, cfg: ModelConfig, q: torch.Tensor) -> dict:
    """One decoder block as ``rotate_model`` leaves it: norms fused, then
    rotated by the fp32 ``q``."""
    return rotate_block(fuse_norms_block(p, cfg), cfg, q)


def rotate_ends(params: dict, q: torch.Tensor) -> dict:
    """Every leaf of ``params`` but its layers as ``rotate_model`` leaves
    it (the table E·Q, the head with the final norm's γ folded in, then
    Qᵀ·head; the final norm ones), in a new dict without ``layers``."""
    head = params["head"] if "head" in params else params["embed"].T
    head = _scale_in(head, params["final_norm"])
    out = {k: v for k, v in params.items() if k != "layers"}
    out.update(
        final_norm=torch.ones_like(params["final_norm"]),
        embed=(params["embed"].float() @ q).to(params["embed"].dtype),
        head=(q.T @ head.float()).to(head.dtype))
    return out


def rotate_model(params: dict, cfg: ModelConfig, q: torch.Tensor | None = None,
                 *, gen: torch.Generator | None = None) -> tuple[dict, dict]:
    """Fuse norms then rotate the whole model. Returns (params, {"q": Q}).

    ``q``: the (d_model, d_model) rotation; when None it is drawn with
    ``random_hadamard(gen, d_model)``.  A tied model comes out untied, as
    the reference's: the head Qᵀ·diag(γ)·Eᵀ beside the table E·Q (the
    final norm's γ cannot fold into the table, which also feeds the
    stream)."""
    q = rotation_matrix(params, cfg, q, gen)
    out = rotate_ends(params, q)
    out["layers"] = [rotate_layer(b, cfg, q) for b in params["layers"]]
    return out, {"q": q}
