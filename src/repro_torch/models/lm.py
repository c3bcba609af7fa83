"""Dense decoder LM: the GQA-attention + SwiGLU block stack of the
reference's ``models/lm.py``, for the port's first slice.

Parameters are a plain dict, laid out like the reference's with the layer
stack unrolled into a list (the reference stacks layers on a leading axis
for ``lax.scan``; ``convert.params_from_jax`` unstacks it)::

    {"embed": (V, D), "head": (D, V), "final_norm": (D,),
     "layers": [{"mixer_norm", "mixer": {"wq", "wk", "wv", "wo"},
                 "ffn_norm", "ffn": {"wi", "wu", "wd"}}, ...]}

Any projection weight may be a ``PackedWeight`` (keep-packed serving); the
forward is the same code either way (``layers.linear``).  The fp KV cache
is a list of per-layer ``{"k", "v"}`` tensors of shape (B, S, KV, Dh),
updated in place by ``decode_step``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.attn_colsum.ops import attn_colsum
from repro_torch.models import attention as att
from repro_torch.models.layers import (apply_dense_ffn, capture_dense_ffn,
                                       cross_entropy_chunked, dense_init,
                                       embed_lookup, init_dense_ffn,
                                       init_embedding, linear, rms_norm)


def _positions(x: torch.Tensor, positions) -> torch.Tensor:
    if positions is None:
        return torch.arange(x.shape[1], device=x.device)
    return positions


def init_block(gen, cfg: ModelConfig, dtype, device) -> dict:
    d = cfg.d_model
    return {
        "mixer_norm": torch.ones((d,), dtype=dtype, device=device),
        "mixer": att.init_gqa(gen, cfg, dtype, device),
        "ffn_norm": torch.ones((d,), dtype=dtype, device=device),
        "ffn": init_dense_ffn(gen, d, cfg.d_ff, dtype, device),
    }


def apply_block(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                positions=None):
    """Full-sequence forward (prefill / calibration).
    Returns (x, cache) with the block's fp KV ``{"k", "v"}``."""
    positions = _positions(x, positions)
    b, t, _ = x.shape
    h = rms_norm(x, p["mixer_norm"], cfg.norm_eps)
    q, k, v = att.gqa_qkv(p["mixer"], cfg, h, positions)
    out = att.flash_attention(q, k, v, kv_chunk=min(512, t))
    x = x + linear(out.reshape(b, t, -1), p["mixer"]["wo"])
    hf = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    x = x + apply_dense_ffn(p["ffn"], hf)
    return x, {"k": k, "v": v}


def decode_block(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
                 pos: int) -> torch.Tensor:
    """One-token step. x: (B, 1, D); writes this token's K/V into the cache
    at ``pos`` (in place) and attends over positions <= pos."""
    b = x.shape[0]
    h = rms_norm(x, p["mixer_norm"], cfg.norm_eps)
    positions = torch.full((1,), pos, device=x.device)
    q, k, v = att.gqa_qkv(p["mixer"], cfg, h, positions)
    cache["k"][:, pos] = k[:, 0]
    cache["v"][:, pos] = v[:, 0]
    out = att.decode_attention(q, cache["k"], cache["v"], pos)
    x = x + linear(out.reshape(b, 1, -1), p["mixer"]["wo"])
    hf = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    return x + apply_dense_ffn(p["ffn"], hf)


def capture_block(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                  positions=None):
    """Calibration forward of one block for the RSQ pipeline.

    Returns (y, caps, domains, colsum): ``caps`` maps each weight path to
    its input (B, T, d_in), ``domains`` to "stream" or "hidden", and
    ``colsum`` is the (B, T) AttnCon score from the ``attn_colsum`` kernel
    (the reference takes it from ``flash_attention(colsum=True)``)."""
    positions = _positions(x, positions)
    b, t, _ = x.shape
    h = rms_norm(x, p["mixer_norm"], cfg.norm_eps)
    q, k, v = att.gqa_qkv(p["mixer"], cfg, h, positions)
    out = att.flash_attention(q, k, v, kv_chunk=min(512, t))
    colsum = attn_colsum(q, k)
    attn_out = out.reshape(b, t, -1)
    x = x + linear(attn_out, p["mixer"]["wo"])
    caps = {"mixer/wq": h, "mixer/wk": h, "mixer/wv": h,
            "mixer/wo": attn_out}
    dom = {path: "stream" for path in caps}
    hf = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    y, f_caps = capture_dense_ffn(p["ffn"], hf)
    for name, inp in f_caps.items():
        caps[f"ffn/{name}"] = inp
        dom[f"ffn/{name}"] = "hidden" if name == "wd" else "stream"
    return x + y, caps, dom, colsum


class Model:
    """Dense GQA decoder for one ``ModelConfig`` on one device."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        if (cfg.family != "dense" or cfg.attn_kind != "gqa" or cfg.qkv_bias
                or cfg.kv_bits != 0):
            raise NotImplementedError(
                f"{cfg.name}: the port serves dense GQA decoders without qkv "
                f"bias and with an fp KV cache (kv_bits=0)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator) -> dict:
        """Random parameters drawn from ``gen`` (which must live on the
        model's device)."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        return {
            "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dt, dev),
            "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
            "head": dense_init(gen, cfg.d_model, cfg.vocab_size, dt, dev),
            "layers": [init_block(gen, cfg, dt, dev)
                       for _ in range(cfg.n_layers)],
        }

    # --------------------------------------------------------------- forward
    def embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        return embed_lookup(params["embed"], tokens).to(self.dtype)

    def hidden_states(self, params: dict, tokens: torch.Tensor
                      ) -> torch.Tensor:
        """(B, T) tokens -> (B, T, D) final hidden states (post final norm)."""
        x = self.embed(params, tokens)
        positions = torch.arange(tokens.shape[1], device=x.device)
        for p_blk in params["layers"]:
            x, _ = apply_block(p_blk, self.cfg, x, positions=positions)
        return rms_norm(x, params["final_norm"], self.cfg.norm_eps)

    def head_logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """(..., D) -> (..., V) fp32 logits."""
        return linear(x, params["head"]).float()

    def logits(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        return self.head_logits(params, self.hidden_states(params, tokens))

    def loss(self, params: dict, tokens: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        x = self.hidden_states(params, tokens)
        return cross_entropy_chunked(x, params["head"], labels)

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, cache_len: int) -> list[dict]:
        cfg = self.cfg
        shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
        return [{"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                 "v": torch.zeros(shape, dtype=self.dtype, device=self.device)}
                for _ in range(cfg.n_layers)]

    def prefill(self, params: dict, tokens: torch.Tensor, *,
                cache_len: Optional[int] = None):
        """Returns (last-token logits (B, V) fp32, cache of length
        ``cache_len`` (default T))."""
        b, t = tokens.shape
        cache = self.init_cache(b, cache_len or t)
        x = self.embed(params, tokens)
        positions = torch.arange(t, device=x.device)
        for p_blk, c in zip(params["layers"], cache):
            x, kv = apply_block(p_blk, self.cfg, x, positions=positions)
            c["k"][:, :t] = kv["k"]
            c["v"][:, :t] = kv["v"]
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self.head_logits(params, x[:, -1]), cache

    def decode_step(self, params: dict, cache: list[dict],
                    token: torch.Tensor, pos: int) -> torch.Tensor:
        """token: (B, 1); pos: its position.  Updates ``cache`` in place and
        returns the (B, V) fp32 logits."""
        x = self.embed(params, token)
        for p_blk, c in zip(params["layers"], cache):
            x = decode_block(p_blk, self.cfg, x, c, pos)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self.head_logits(params, x[:, 0])

