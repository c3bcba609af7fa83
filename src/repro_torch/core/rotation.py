"""Step 1 of RSQ: Rotate — randomized-Hadamard orthogonal transform of the
residual stream (QuaRot / SliceGPT computational invariance).

Convention (as in the reference): the stream is rotated ``x -> x @ Q``;
weights that consume the stream become ``Qᵀ W``, weights that produce it
become ``W Q``, and the embedding table becomes ``E Q``.  RMSNorm commutes
with Q only when its scale is 1, so the norms' γ are folded into the
consuming weights first.  Non-power-of-two dims use H_{2^k} ⊗ Q_m with a
random orthogonal Q_m.

An encoder-decoder has two streams and two rotations, as the reference:
Q for the decoder's and Q_enc for the encoder's.  The encoder's final norm
feeds every decoder block's cross-attention K/V, so its γ folds into their
``cross/wk`` / ``cross/wv``, which then take Q_encᵀ; ``frame_proj`` = Q_enc
takes the stub frontend's frames into the encoder's basis.  A vision
model's media are an external stub: its cross-attention mixers' ``wk`` /
``wv`` stay unrotated.

One departure from the reference, on purpose: the reference folds a
cross-attention *mixer's* ``mixer_norm`` γ into every one of its stream
inputs, ``wk`` and ``wv`` included (its ``rotation.py:68``, ``:78-80``),
but those read the media, not the normed stream, so at γ ≠ 1 its rotated
model computes another function.  Here that γ folds into ``wq`` alone,
which keeps the block's output; at γ = 1 (every init) the two agree.

``rotate_model`` takes an explicit Q (and Q_enc) so callers can hand it the
reference's own rotations (``jax.random`` draws cannot be reproduced by
torch); without one it draws from a ``torch.Generator``, Q first.
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


def fuse_norms_block(p: dict, cfg: ModelConfig, *, cross: bool = False,
                     media_norm: torch.Tensor | None = None) -> dict:
    """Fold the block's RMSNorm γ into its consuming weights (new dict);
    MLA's q_norm and kv_norm fold into wq_b and wkv_b, a Mamba block's
    mixer norm into wzx, wbc and wdt, a cross-attention mixer's
    (``cross``) into its wq alone (see the module's note).  An enc-dec
    decoder block's ``cross_norm`` folds into ``cross/wq``, and
    ``media_norm`` (the encoder's final norm) into ``cross/wk`` and
    ``cross/wv``.  The FFN norm of a block that has an
    FFN (every block but mamba2's; a jamba Mamba block's too) folds into
    its wi / wu, or for routed experts into the router, each expert's wi /
    wu and, where there is one, the shared FFN's wi / wu."""
    mixer = dict(p["mixer"])
    for name in ("wq",) if cross else _MIXER_IN:
        if name in mixer:
            mixer[name] = _scale_in(mixer[name], p["mixer_norm"])
    for norm, name in _MLA_NORMS:
        if norm in mixer:
            mixer[name] = _scale_in(mixer[name], mixer[norm])
            mixer[norm] = torch.ones_like(mixer[norm])
    out = {**p, "mixer": mixer,
           "mixer_norm": torch.ones_like(p["mixer_norm"])}
    if "cross" in p:
        sub = dict(p["cross"], wq=_scale_in(p["cross"]["wq"],
                                            p["cross_norm"]))
        if media_norm is not None:
            for name in ("wk", "wv"):
                sub[name] = _scale_in(sub[name], media_norm)
        out.update(cross=sub, cross_norm=torch.ones_like(p["cross_norm"]))
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


def rotate_block(p: dict, cfg: ModelConfig, q: torch.Tensor, *,
                 cross: bool = False,
                 q_media: torch.Tensor | None = None) -> dict:
    """Apply the stream rotation to one block (norms must be fused first):
    its mixer's stream-side weights (attention or Mamba), then its FFN, if
    it has one.  A cross-attention mixer (``cross``) and an enc-dec
    decoder block's ``cross`` sub-layer: wq is Qᵀ W and wo W Q; their wk /
    wv read the media, and take ``q_media``ᵀ (the encoder's Q_enc), or
    stay as they are without one (a vision model's media).  A
    routed-expert FFN: the router is Qᵀ W, every expert's
    wi / wu Qᵀ W_e and its wd W_e Q, the shared FFN (where there is one)
    as a dense one."""
    qf = q.float()

    def rot_in(w):  # (d_model, d_out) -> Qᵀ W
        return (qf.T @ w.float()).to(w.dtype)

    def rot_out(w):  # (d_in, d_model) -> W Q
        return (w.float() @ qf).to(w.dtype)

    def rot_cross(c: dict) -> dict:
        c = dict(c, wq=rot_in(c["wq"]), wo=rot_out(c["wo"]))
        if q_media is not None:
            for name in ("wk", "wv"):
                c[name] = (q_media.float().T @ c[name].float()).to(
                    c[name].dtype)
        return c

    if cross:
        mixer = rot_cross(p["mixer"])
    else:
        mixer = dict(p["mixer"])
        for name in _MIXER_IN:
            if name in mixer:
                mixer[name] = rot_in(mixer[name])
        for name in _MIXER_OUT:
            if name in mixer:
                mixer[name] = rot_out(mixer[name])
    p = {**p, "mixer": mixer}
    if "cross" in p:
        p["cross"] = rot_cross(p["cross"])
    if "ffn" not in p:
        return p
    ffn = p["ffn"]
    if "router" not in ffn:
        return {**p, "ffn": _rotate_ffn(ffn, rot_in, rot_out)}
    ex = ffn["experts"]
    ffn = dict(ffn, router=rot_in(ffn["router"]), experts={
        "wi": _each_expert(rot_in, ex["wi"]),
        "wu": _each_expert(rot_in, ex["wu"]),
        "wd": _each_expert(rot_out, ex["wd"])})
    if "shared" in ffn:
        ffn["shared"] = _rotate_ffn(ffn["shared"], rot_in, rot_out)
    return {**p, "ffn": ffn}


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


def rotate_layer(p: dict, cfg: ModelConfig, q: torch.Tensor, *,
                 cross: bool = False, q_media: torch.Tensor | None = None,
                 media_norm: torch.Tensor | None = None) -> dict:
    """One block as ``rotate_model`` leaves it: norms fused, then rotated
    by the fp32 ``q`` (a decoder block by Q, an encoder block by Q_enc);
    ``cross`` marks a cross-attention mixer, and an enc-dec decoder block
    takes the encoder's final norm γ (``media_norm``) and Q_enc
    (``q_media``) on its cross-attention K/V side."""
    return rotate_block(fuse_norms_block(p, cfg, cross=cross,
                                         media_norm=media_norm),
                        cfg, q, cross=cross, q_media=q_media)


def rotate_ends(params: dict, q: torch.Tensor,
                q_enc: torch.Tensor | None = None) -> dict:
    """Every leaf of ``params`` but its layers as ``rotate_model`` leaves
    it (the table E·Q, the head with the final norm's γ folded in, then
    Qᵀ·head; the final norm ones; an encoder's final norm ones, its γ
    folded into the decoder's cross-attention, and ``frame_proj`` Q_enc in
    the table's dtype), in a new dict without ``layers`` (nor the
    encoder's)."""
    head = params["head"] if "head" in params else params["embed"].T
    head = _scale_in(head, params["final_norm"])
    out = {k: v for k, v in params.items() if k != "layers"}
    out.update(
        final_norm=torch.ones_like(params["final_norm"]),
        embed=(params["embed"].float() @ q).to(params["embed"].dtype),
        head=(q.T @ head.float()).to(head.dtype))
    if "encoder" in params:
        out["encoder"] = {"final_norm": torch.ones_like(
            params["encoder"]["final_norm"])}
        out["frame_proj"] = q_enc.to(params["embed"].dtype)
    return out


def rotate_model(params: dict, cfg: ModelConfig, q: torch.Tensor | None = None,
                 *, q_enc: torch.Tensor | None = None,
                 gen: torch.Generator | None = None) -> tuple[dict, dict]:
    """Fuse norms then rotate the whole model.  Returns (params,
    {"q": Q, "q_enc": Q_enc or None}).

    ``q``: the (d_model, d_model) rotation; when None it is drawn with
    ``random_hadamard(gen, d_model)``; an encoder-decoder's ``q_enc`` for
    the encoder's stream likewise, after Q.  A tied model comes out
    untied, as the reference's: the head Qᵀ·diag(γ)·Eᵀ beside the table
    E·Q (the final norm's γ cannot fold into the table, which also feeds
    the stream)."""
    q = rotation_matrix(params, cfg, q, gen)
    encoder = params.get("encoder")
    # only an encoder's stream has a rotation of its own: a vision model's
    # media stay as they are
    q_enc = (None if encoder is None
             else rotation_matrix(params, cfg, q_enc, gen))
    out = rotate_ends(params, q, q_enc)
    kinds = cfg.layer_kinds()
    out["layers"] = [
        rotate_layer(b, cfg, q, cross=kind == "cross", q_media=q_enc,
                     media_norm=None if encoder is None
                     else encoder["final_norm"])
        for b, kind in zip(params["layers"], kinds)]
    if encoder is not None:
        out["encoder"]["layers"] = [rotate_layer(b, cfg, q_enc)
                                    for b in encoder["layers"]]
    return out, {"q": q, "q_enc": q_enc}
