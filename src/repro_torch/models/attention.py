"""Attention: chunked (flash-style) prefill attention, fp decode
attention, the quantized KV cache (codecs, flat and paged appends) with
attention on its codes, the GQA projections, the MLA block (absorbed
latent attention, flat and paged) and cross-attention on media or encoder
rows.

``flash_attention`` scans KV chunks with a running (max, denominator,
accumulator) triple and never forms the (T, T) score matrix, as the
reference does in jnp; it is plain PyTorch here because the reference's
version is not a Pallas kernel either, and so is cross-attention.  The
AttnCon column sums come from the ``attn_colsum`` kernel
(``models.lm.capture_block``), not from here.

The quantized cache never leaves codes + scales on the serving path: prefill
encodes, decode appends one encoded token, and attention reads the codes
through ``kernels.flash_decode``.  ``kv_dequantize`` and ``kv_log_decode``
materialize a cache in fp and exist for tests only.  Unlike the reference,
appends write into the cache tensors in place, at a position given as an
int or as a device tensor (a captured decode loop's, ``runtime.graphs``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.device import matmul
from repro_torch.kernels.flash_decode.ops import (flash_decode,
                                                  mla_flash_decode,
                                                  paged_flash_decode,
                                                  paged_flash_extend,
                                                  paged_mla_flash_decode,
                                                  paged_mla_flash_extend)
from repro_torch.kernels.flash_decode.ref import kv_unpack
from repro_torch.kernels.quant_matmul.ops import (is_packed,
                                                  mla_latent_weights,
                                                  quant_matmul,
                                                  quant_matmul_t)
from repro_torch.models.layers import apply_rope, dense_init, linear, rms_norm

NEG_INF = -1e30


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, T, KV, Dh) -> (B, T, KV*n_rep, Dh); query head h reads KV head
    h // n_rep (``repeat_interleave``, not ``tile``)."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_chunk: int = 512,
                    q_offset: int = 0) -> torch.Tensor:
    """Chunked attention.  q: (B, Tq, H, Dh) at positions ``q_offset +
    arange(Tq)``; k: (B, Tk, KV, Dh); v: (B, Tk, KV, Dv).  Returns
    (B, Tq, H, Dv) in q's dtype (fp32 softmax math).  ``causal`` masks the
    keys after each query; without it every query sees every key (an
    encoder's self-attention, cross-attention on media or encoder rows).
    A ragged Tk ends in a shorter last chunk: the reference pads K and V
    to a chunk multiple and masks the padding, whose exps are exactly 0,
    so the sums are the same.  A chunk of queries with its offset walks
    the same KV chunks as the whole prompt does, so its rows are bitwise
    the whole prompt's (exact chunked prefill)."""
    b, tq, h, dh = q.shape
    tk, kv_heads = k.shape[1], k.shape[2]
    n_rep = h // kv_heads
    kv_chunk = min(kv_chunk, tk)
    qf = (q.float() * (dh ** -0.5)).transpose(1, 2)       # (B, H, Tq, Dh)
    q_pos = q_offset + torch.arange(tq, device=q.device)
    m = torch.full((b, h, tq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, tq, 1), device=q.device)
    acc = torch.zeros((b, h, tq, v.shape[-1]), device=q.device)
    for off in range(0, tk, kv_chunk):
        k_r = _repeat_kv(k[:, off:off + kv_chunk], n_rep).float()
        v_r = _repeat_kv(v[:, off:off + kv_chunk], n_rep).float()
        s = matmul(qf, k_r.permute(0, 2, 3, 1))           # (B, H, Tq, c)
        if causal:
            kv_pos = off + torch.arange(k_r.shape[1], device=q.device)
            s = torch.where(q_pos[:, None] >= kv_pos[None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + matmul(p, v_r.transpose(1, 2))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.transpose(1, 2).to(q.dtype)


def position_index(pos, device) -> torch.Tensor:
    """A flat cache's decode position as a (1,) int64 tensor on ``device``:
    an int is filled there (no host-to-device copy), a 0-d or (1,) int
    tensor is reshaped.  The decode step takes either; a captured decode
    loop passes a tensor, which a graph replay may change."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).to(device=device, dtype=torch.int64)
    return torch.full((1,), pos, dtype=torch.int64, device=device)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos) -> torch.Tensor:
    """Single-token attention against a (B, S, KV, Dh) cache; positions
    > pos (an int or a (1,) tensor) are masked.  q: (B, 1, H, Dh) ->
    (B, 1, H, Dv).  The query is grouped as (KV, G) and contracted
    against the un-repeated cache."""
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


# ------------------------------------------------------- quantized KV cache


def kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, KV, Dh) -> int8 codes + per-(token, head) bf16 scales.  The
    code divides by the fp32 scale; the stored scale is its bf16 rounding
    (both as the reference)."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0].to(torch.bfloat16)


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Full-tensor fp materialization of an int8 cache: tests only."""
    return (q.to(torch.bfloat16) * scale[..., None].to(torch.bfloat16)
            ).to(dtype)


# 2-bit log codes: value = scale * LEVELS[code]; 16 codes per uint32 word
# (held in int32) along the feature axis; one bf16 scale per (chunk, head).
KV_LOG_LEVELS = (-1.0, -0.25, 0.25, 1.0)


def kv_pack(codes: torch.Tensor) -> torch.Tensor:
    """(..., D) 2-bit codes -> (..., ceil(D/16)) int32 words holding the
    uint32 bits (code j at bits [2j, 2j+2); a ragged D is zero-padded)."""
    d = codes.shape[-1]
    c = codes.to(torch.int64)
    pad = (-d) % 16
    if pad:
        c = torch.cat([c, c.new_zeros(c.shape[:-1] + (pad,))], dim=-1)
    c = c.reshape(*c.shape[:-1], -1, 16)
    shifts = torch.arange(16, dtype=torch.int64, device=codes.device) * 2
    words = (c << shifts).sum(-1) & 0xFFFFFFFF
    # reinterpret [0, 2^32) as the int32 with the same bit pattern
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def kv_log_scales(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """Per-(chunk, head) scales: amax of |x| over each ``chunk``-token group
    and the feature axis.  x: (B, T, ..., D) -> (B, ceil(T/chunk), ...)
    bf16; a ragged T is zero-padded (padded rows never decode)."""
    xf = x.float().abs()
    b, t = x.shape[:2]
    pad = (-t) % chunk
    if pad:
        xf = torch.cat([xf, xf.new_zeros((b, pad) + xf.shape[2:])], dim=1)
    xf = xf.reshape(b, -1, chunk, *x.shape[2:])
    amax = xf.amax(dim=-1).amax(dim=2)
    return torch.clamp_min(amax, 1e-8).to(torch.bfloat16)


def _kv_log_codes(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Encode fp32 values against a per-(token, head) scale (shape
    ``xf.shape[:-1]``): |x| / scale > 0.5 picks the outer level, the sign
    the half; values past the scale clip to the outer level."""
    s = torch.clamp_min(scale.float(), 1e-8)[..., None]
    magcode = (xf.abs() / s > 0.5).to(torch.int32)
    return torch.where(xf >= 0, 2 + magcode, 1 - magcode)


def kv_log_encode(x: torch.Tensor, scales: torch.Tensor,
                  chunk: int) -> torch.Tensor:
    """x: (B, T, ..., D) + per-chunk scales -> (B, T, ..., ceil(D/16))
    packed words."""
    t = x.shape[1]
    s_tok = scales.repeat_interleave(chunk, dim=1)[:, :t]
    return kv_pack(_kv_log_codes(x.float(), s_tok))


def kv_log_decode(packed: torch.Tensor, scales: torch.Tensor, *, d: int,
                  chunk: int, dtype=torch.float32) -> torch.Tensor:
    """Full-tensor fp materialization of a 2-bit cache: tests only."""
    c = kv_unpack(packed, d).long()
    t = packed.shape[1]
    s_tok = scales.float().repeat_interleave(chunk, dim=1)[:, :t]
    lut = torch.tensor(KV_LOG_LEVELS, dtype=torch.float32,
                       device=packed.device)
    return (lut[c] * s_tok[..., None]).to(dtype)


# --------------------------------------------------------------- KV codecs
#
# One object per cache representation owns its layout (``round_len``,
# ``code_cols``/``code_dtype``, ``scale_rows``/``scale_dtype``,
# ``page_tokens``), its prompt encoding (``encode``) and its one-token
# encoding (``encode_token``, with the kv2 chunk-leader rule) so the flat
# cache, the paged pools and the kernels never drift apart.


@dataclasses.dataclass(frozen=True)
class FpCodec:
    """KV cache held in the activation dtype: no codes, no scales."""

    kv_bits: int = 0
    chunk: int = 1
    align: int = 1
    quantized: bool = False

    def round_len(self, s: int) -> int:
        return s

    def scale_rows(self, s: int) -> int:
        return 0


@dataclasses.dataclass(frozen=True)
class Kv8Codec:
    """int8 codes + per-(token, head) bf16 scales (``kv_quantize``)."""

    align: int  # cfg.kv_chunk: tile and page alignment although chunk = 1
    kv_bits: int = 8
    chunk: int = 1
    quantized: bool = True
    code_dtype = torch.int8
    scale_dtype = torch.bfloat16

    def round_len(self, s: int) -> int:
        return -(-s // self.align) * self.align

    def scale_rows(self, s: int) -> int:
        return s // self.chunk

    def code_cols(self, d: int) -> int:
        return d

    @property
    def page_tokens(self) -> int:
        return self.align

    def encode(self, x):
        return kv_quantize(x)

    def encode_token(self, x, pos, cur_scale):
        """One token (B, 1, ..., D) -> (codes, scale row); the position and
        the current scale do not matter at per-token granularity."""
        del pos, cur_scale
        return kv_quantize(x)

    def append(self, codes, scales, x, pos) -> None:
        """Write one token's codes and scale at ``pos`` (an int, or a 0-d
        or (1,) int tensor) of a flat cache."""
        i = position_index(pos, codes.device)
        q, sc = self.encode_token(x, i, None)
        codes.index_copy_(1, i, q)
        scales.index_copy_(1, i, sc)


@dataclasses.dataclass(frozen=True)
class Kv2Codec:
    """Packed 2-bit log codes + per-(chunk, head) bf16 scales.

    Chunk-leader rule: the token at a chunk boundary stamps the chunk's
    scale from its own amax; later tokens of the chunk reuse it (their
    overflow clips to the outer level).  Revisiting the scale would
    re-code earlier tokens: a rewrite of the cache per step."""

    align: int  # cfg.kv_chunk == scale-group size == page size
    kv_bits: int = 2
    quantized: bool = True
    code_dtype = torch.int32
    scale_dtype = torch.bfloat16

    @property
    def chunk(self) -> int:
        return self.align

    def round_len(self, s: int) -> int:
        return -(-s // self.align) * self.align

    def scale_rows(self, s: int) -> int:
        return s // self.chunk

    def code_cols(self, d: int) -> int:
        return -(-d // 16)

    @property
    def page_tokens(self) -> int:
        return self.align

    def encode(self, x):
        scales = kv_log_scales(x, self.chunk)
        return kv_log_encode(x, scales, self.chunk), scales

    def encode_token(self, x, pos, cur_scale):
        """One token (B, 1, ..., D) against the current scale of its chunk
        (B, 1, ...); ``pos`` is a (1,) int tensor (flat cache, shared by the
        batch) or a (B,) one (paged cache).  The stamp is chosen on the
        device, so the position may change between replays of a graph."""
        xf = x.float()
        lead = torch.clamp_min(xf.abs().amax(-1), 1e-8).to(cur_scale.dtype)
        stamp = (pos % self.chunk == 0).reshape(
            (-1,) + (1,) * (cur_scale.ndim - 1))
        sc = torch.where(stamp, lead, cur_scale)
        return kv_pack(_kv_log_codes(xf, sc)), sc

    def append(self, codes, scales, x, pos) -> None:
        """Write one token's codes at ``pos`` (an int, or a 0-d or (1,) int
        tensor) of a flat cache, and its chunk's scale row: stamped at a
        chunk boundary, else kept."""
        i = position_index(pos, codes.device)
        ci = i // self.chunk
        tok, sc = self.encode_token(x, i, scales.index_select(1, ci))
        codes.index_copy_(1, i, tok)
        scales.index_copy_(1, ci, sc)


@functools.lru_cache(maxsize=None)
def kv_codec(kv_bits: int = 0, kv_chunk: int = 64):
    """The codec of a (kv_bits, kv_chunk) cache config, one per config."""
    if kv_bits == 0:
        return FpCodec()
    if kv_bits == 8:
        return Kv8Codec(align=kv_chunk)
    if kv_bits == 2:
        return Kv2Codec(align=kv_chunk)
    raise ValueError(
        f"kv_bits={kv_bits} is not supported — use 0 (KV cache in the "
        "activation dtype), 8 (int8 codes + per-token-head scales) or 2 "
        "(packed log codes + per-chunk scales)")


def _query_groups(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(B, 1, H, Dh) -> (B, KV, G, Dh) fp32 with the attention scale."""
    b, _, h, dh = q.shape
    return (q.float() * (dh ** -0.5)).reshape(b, kv_heads, h // kv_heads, dh)


def decode_attention_quantized(q, k_codes, k_scales, v_codes, v_scales, pos,
                               *, kv_bits: int, chunk: int,
                               tile: int) -> torch.Tensor:
    """Single-token attention on a flat quantized cache.  q: (B, 1, H, Dh);
    codes/scales as the codec stores them; ``tile`` is the page size, so
    this equals :func:`paged_decode_attention_quantized` bitwise.  The
    cache stays codes all the way into the kernel's tiles."""
    b, _, h, dh = q.shape
    qf = _query_groups(q, k_codes.shape[2])
    out = flash_decode(qf, k_codes, k_scales, v_codes, v_scales, pos,
                       kv_bits=kv_bits, chunk=chunk, dv=dh, tile=tile)
    return out.reshape(b, 1, h, dh).to(q.dtype)


def paged_decode_attention_quantized(q, k_pool, ks_pool, v_pool, vs_pool,
                                     page_tbl, pos, *, kv_bits: int,
                                     chunk: int) -> torch.Tensor:
    """Single-token GQA attention on block-paged quantized pools.

    q: (B, 1, H, Dh), one engine slot per row; pools: (n_pages, page, KV,
    w) codes and (n_pages, page // chunk, KV) scales; page_tbl: (B,
    n_tiles) int (trash page 0 in unused entries); pos: (B,) int."""
    b, _, h, dh = q.shape
    qf = _query_groups(q, k_pool.shape[2])
    out = paged_flash_decode(page_tbl, pos, qf, k_pool, ks_pool, v_pool,
                             vs_pool, kv_bits=kv_bits, chunk=chunk, dv=dh,
                             page=k_pool.shape[1])
    return out.reshape(b, 1, h, dh).to(q.dtype)


def kv_paged_append(codec, c_pool, s_pool, x, page_ids, pos, active) -> None:
    """Encode one new token per slot and write it into paged pools, in
    place.

    x: (B, 1, ..., D); page_ids: (B,) the page holding each slot's current
    tile; pos: (B,) global positions; active: (B,) bool.  Inactive slots
    write into the reserved trash page 0, so the fixed-shape write needs no
    mask and never touches a live page.  The encoding is the codec's
    ``encode_token``, as the flat cache's append, so paged and flat caches
    hold the same codes for the same token stream."""
    page = c_pool.shape[1]
    row = pos % page
    srow = row // codec.chunk
    pid = torch.where(active, page_ids, torch.zeros_like(page_ids))
    cur = s_pool[pid, srow][:, None]          # (B, 1, ...) current scales
    tok, sc = codec.encode_token(x, pos, cur)
    c_pool[pid, row] = tok[:, 0]
    s_pool[pid, srow] = sc[:, 0]


def paged_extend_attention_quantized(q, k_new, v_new, k_pool, ks_pool,
                                     v_pool, vs_pool, tbl, *,
                                     kv_bits: int, chunk: int):
    """One prompt chunk's GQA attention against its request's quantized
    pages plus the chunk's own fp keys and values (the "paged" chunked
    prefill: past rows are read back as codes, so this is lossy against
    the whole-prompt prefill).  q: (1, L, H, Dh); k_new/v_new: (1, L, KV,
    Dh); tbl: (n_past,) pages of the earlier chunks (page-aligned chunks:
    the chunk starts at n_past * page)."""
    out = paged_flash_extend(tbl, q, k_new, v_new, k_pool, ks_pool, v_pool,
                             vs_pool, kv_bits=kv_bits, chunk=chunk,
                             dh=q.shape[-1], dv=v_new.shape[-1],
                             page=k_pool.shape[1])
    return out.to(q.dtype)


# ------------------------------------------------------------------ GQA block


def init_gqa(gen, cfg, dtype, device) -> dict:
    """wq / wk / wv / wo, and with ``cfg.qkv_bias`` the zero biases ``bq``
    / ``bk`` / ``bv`` (qwen1.5), as the reference draws them."""
    d, h, kvh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, h * dh, dtype, device),
        "wk": dense_init(gen, d, kvh * dh, dtype, device),
        "wv": dense_init(gen, d, kvh * dh, dtype, device),
        "wo": dense_init(gen, h * dh, d, dtype, device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", h * dh), ("bk", kvh * dh), ("bv", kvh * dh)):
            p[name] = torch.zeros((n,), dtype=dtype, device=device)
    return p


def _biased(x: torch.Tensor, p: dict, w: str, b: str) -> torch.Tensor:
    """``linear(x, p[w])`` plus the bias ``p[b]`` where the block has one,
    added after the projection and before RoPE."""
    y = linear(x, p[w])
    return y + p[b] if b in p else y


def gqa_qkv(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    b, t, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _biased(x, p, "wq", "bq").reshape(b, t, h, dh)
    k = _biased(x, p, "wk", "bk").reshape(b, t, kvh, dh)
    v = _biased(x, p, "wv", "bv").reshape(b, t, kvh, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# ------------------------------------------------------------------ MLA block
#
# Multi-head latent attention (DeepSeek): keys and values are expanded per
# head from a shared kv_lora_rank-wide latent c_kv through ``wkv_b``, plus
# one rope key shared by every head.  Prefill and calibration attend on the
# expanded per-head q, k, v (``mla_qkv``); decode and the paged prefill
# absorb ``wkv_b`` into the queries and attend in latent space, so the cache
# holds only c_kv (kvr) and the rope key (dr) per token.


def init_mla(gen, cfg, dtype, device) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    p = {}
    if qr:
        p["wq_a"] = dense_init(gen, d, qr, dtype, device)
        p["q_norm"] = torch.ones((qr,), dtype=dtype, device=device)
        p["wq_b"] = dense_init(gen, qr, h * (dn + dr), dtype, device)
    else:
        p["wq"] = dense_init(gen, d, h * (dn + dr), dtype, device)
    p["wkv_a"] = dense_init(gen, d, kvr + dr, dtype, device)
    p["kv_norm"] = torch.ones((kvr,), dtype=dtype, device=device)
    p["wkv_b"] = dense_init(gen, kvr, h * (dn + dv), dtype, device)
    p["wo"] = dense_init(gen, h * dv, d, dtype, device)
    return p


def _mla_query(p: dict, cfg, x: torch.Tensor):
    """(q, ql): per-head queries (B, T, H, dn + dr) before rope, and the
    normed q_lora activation (wq_b's input; None without q_lora)."""
    b, t, _ = x.shape
    if "wq_a" in p:
        ql = rms_norm(linear(x, p["wq_a"]), p["q_norm"], cfg.norm_eps)
        return linear(ql, p["wq_b"]).reshape(b, t, cfg.n_heads, -1), ql
    return linear(x, p["wq"]).reshape(b, t, cfg.n_heads, -1), None


def mla_latent(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    """The cache rows of x: (c_kv (B, T, kvr), k_rope (B, T, dr))."""
    kvr = cfg.kv_lora_rank
    kv = linear(x, p["wkv_a"])                                # (B, T, kvr+dr)
    c_kv = rms_norm(kv[..., :kvr], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, kvr:], positions, cfg.rope_theta)
    return c_kv, k_rope[..., 0, :]


def mla_qkv_inputs(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    """:func:`mla_qkv` plus the normed q_lora activation ``ql`` (wq_b's
    input, None without q_lora), which calibration captures."""
    b, t, _ = x.shape
    h, dn, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    q, ql = _mla_query(p, cfg, x)
    q = torch.cat([q[..., :dn], apply_rope(q[..., dn:], positions,
                                            cfg.rope_theta)], dim=-1)
    c_kv, k_rope = mla_latent(p, cfg, x, positions)
    kvb = linear(c_kv, p["wkv_b"]).reshape(b, t, h, dn + dv)
    k = torch.cat([kvb[..., :dn],
                   k_rope[:, :, None].expand(b, t, h, k_rope.shape[-1])],
                  dim=-1)
    return q, k, kvb[..., dn:], c_kv, k_rope, ql


def mla_qkv(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    """Expanded per-head q (B, T, H, dn+dr), k (B, T, H, dn+dr), v (B, T,
    H, dv), plus the latent cache rows c_kv and k_rope."""
    return mla_qkv_inputs(p, cfg, x, positions)[:5]


def apply_mla(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor, *,
              kv_chunk: int = 512) -> torch.Tensor:
    b, t, _ = x.shape
    q, k, v, _, _ = mla_qkv(p, cfg, x, positions)
    out = flash_attention(q, k, v, kv_chunk=min(kv_chunk, t))
    return linear(out.reshape(b, t, -1), p["wo"])


def _mla_q_and_expand(p: dict, cfg, x: torch.Tensor, positions):
    """Absorbed-MLA queries shared by the flat, paged and extend paths:
    (q_lat (B, T, H, kvr) fp32, q_rope (B, T, H, dr), expand_v).

    ``q_lat`` is q_nope absorbed through each head's W_k, ``expand_v`` maps
    a latent context (B, T, H, kvr) through each head's W_v to (B, T, H,
    dv).  A packed ``wkv_b`` stays packed: its per-head views
    (``mla_latent_weights``) go through ``quant_matmul_t`` (absorb) and
    ``quant_matmul`` (expand), each one launch for all heads.  An fp
    ``wkv_b`` contracts per head through ``device.matmul``."""
    b, t, _ = x.shape
    h, dn, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    q, _ = _mla_query(p, cfg, x)
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    # (B, T, H, ·) <-> (H, B*T, ·): the head-batched operand layout
    def to_heads(a):
        return a.float().reshape(b * t, h, a.shape[-1]).transpose(0, 1)

    def from_heads(a):
        return a.transpose(0, 1).reshape(b, t, h, a.shape[-1])

    if is_packed(p["wkv_b"]):
        pw_k, pw_v = mla_latent_weights(p["wkv_b"], h, dn, dv)
        q_lat = from_heads(quant_matmul_t(to_heads(q[..., :dn]), pw_k))

        def expand_v(cl):
            return from_heads(quant_matmul(to_heads(cl).contiguous(), pw_v))
    else:
        w = p["wkv_b"].float().reshape(kvr, h, dn + dv)
        w_k = w[..., :dn].permute(1, 2, 0)                   # (H, dn, kvr)
        w_v = w[..., dn:].transpose(0, 1)                    # (H, kvr, dv)
        q_lat = from_heads(matmul(to_heads(q[..., :dn]), w_k))

        def expand_v(cl):
            return from_heads(matmul(to_heads(cl), w_v))
    return q_lat, q_rope, expand_v


def _mla_scaled(cfg, q_lat, q_rope):
    """Absorbed queries with the attention scale (dn + dr)^-0.5 folded in,
    fp32."""
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    return q_lat.float() * scale, q_rope.float() * scale


def mla_decode(p: dict, cfg, x: torch.Tensor, c_cache, rope_cache, pos,
               *, c_scale=None, r_scale=None, kv_bits: int = 0,
               chunk: int = 1, tile: int = 64) -> torch.Tensor:
    """Latent-space ("absorbed") MLA decode of one token.  x: (B, 1, D);
    c_cache (B, S, kvr) and rope_cache (B, S, dr) in the activation dtype,
    or their codes with ``c_scale``/``r_scale`` for ``kv_bits`` 8 or 2,
    attended on the codes through ``mla_flash_decode`` (``tile`` = the page
    size, so this equals :func:`mla_decode_paged` bitwise).  Positions >
    pos (an int or a (1,) tensor) are masked."""
    b = x.shape[0]
    h, dv = cfg.n_heads, cfg.v_head_dim
    positions = position_index(pos, x.device)
    q_lat, q_rope, expand_v = _mla_q_and_expand(p, cfg, x, positions)
    if kv_bits in (8, 2):
        ql, qr = _mla_scaled(cfg, q_lat, q_rope)
        ctx_lat = mla_flash_decode(
            ql[:, 0], qr[:, 0], c_cache, c_scale, rope_cache, r_scale,
            positions, kv_bits=kv_bits, chunk=chunk, dl=cfg.kv_lora_rank,
            dr=cfg.qk_rope_dim, tile=tile)[:, None]        # (B, 1, H, kvr)
    else:
        scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
        cf, rf = c_cache.float(), rope_cache.float()
        scores = (matmul(q_lat[:, 0], cf.transpose(1, 2))
                  + matmul(q_rope[:, 0].float(), rf.transpose(1, 2))) * scale
        valid = torch.arange(c_cache.shape[1], device=x.device) <= positions
        prob = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
        ctx_lat = matmul(prob, cf)[:, None]                  # (B, 1, H, kvr)
    return linear(expand_v(ctx_lat).reshape(b, 1, h * dv).to(x.dtype),
                  p["wo"])


def mla_decode_paged(p: dict, cfg, x: torch.Tensor, pools: dict,
                     page_tbl: torch.Tensor, pos: torch.Tensor, *,
                     kv_bits: int, chunk: int) -> torch.Tensor:
    """Absorbed MLA decode of every engine slot against block-paged latent
    pools {"c", "cs", "r", "rs"}: (n_pages, page, w) codes and (n_pages,
    page // chunk) scales.  x: (B, 1, D); page_tbl: (B, n_tiles); pos:
    (B,).  The query math is :func:`mla_decode`'s at per-slot positions,
    so a slot's output is the flat step's."""
    b = x.shape[0]
    h, dv = cfg.n_heads, cfg.v_head_dim
    q_lat, q_rope, expand_v = _mla_q_and_expand(p, cfg, x, pos[:, None])
    ql, qr = _mla_scaled(cfg, q_lat, q_rope)
    ctx_lat = paged_mla_flash_decode(
        page_tbl, pos, ql[:, 0], qr[:, 0], pools["c"], pools["cs"],
        pools["r"], pools["rs"], kv_bits=kv_bits, chunk=chunk,
        dl=cfg.kv_lora_rank, dr=cfg.qk_rope_dim,
        page=pools["c"].shape[1])[:, None]
    return linear(expand_v(ctx_lat).reshape(b, 1, h * dv).to(x.dtype),
                  p["wo"])


def mla_extend_paged(p: dict, cfg, x: torch.Tensor, c_new: torch.Tensor,
                     r_new: torch.Tensor, pools: dict, tbl: torch.Tensor,
                     positions: torch.Tensor, *, kv_bits: int,
                     chunk: int) -> torch.Tensor:
    """One prompt chunk's absorbed MLA attention against its request's
    quantized latent pages plus the chunk's own fp latents (the "paged"
    chunked prefill).  x: (1, L, D); c_new/r_new: (1, L, kvr|dr) this
    chunk's cache rows; tbl: (n_past,) pages of the earlier chunks."""
    b, t, _ = x.shape
    h, dv = cfg.n_heads, cfg.v_head_dim
    q_lat, q_rope, expand_v = _mla_q_and_expand(p, cfg, x, positions)
    ql, qr = _mla_scaled(cfg, q_lat, q_rope)
    ctx_lat = paged_mla_flash_extend(
        tbl, ql[0], qr[0], c_new[0].float(), r_new[0].float(), pools["c"],
        pools["cs"], pools["r"], pools["rs"], kv_bits=kv_bits, chunk=chunk,
        dl=cfg.kv_lora_rank, dr=cfg.qk_rope_dim,
        page=pools["c"].shape[1])[None]                     # (1, L, H, kvr)
    return linear(expand_v(ctx_lat).reshape(b, t, h * dv).to(x.dtype),
                  p["wo"])


# ------------------------------------------------------------ cross-attention
#
# Queries from the decoder stream, keys and values from media rows (a
# vision model's patch embeddings) or from the encoder's output (enc-dec),
# both d_model wide; no biases, no RoPE, no mask.  Prefill computes the K/V
# of the media once (``cross_kv``) and the cache keeps them in the
# activation dtype, never quantized; each decode step attends on them.


def init_cross_attn(gen, cfg, dtype, device) -> dict:
    d, h, kvh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": dense_init(gen, d, h * dh, dtype, device),
            "wk": dense_init(gen, d, kvh * dh, dtype, device),
            "wv": dense_init(gen, d, kvh * dh, dtype, device),
            "wo": dense_init(gen, h * dh, d, dtype, device)}


def cross_kv(p: dict, cfg, media: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """media: (B, Tm, D) -> K, V (B, Tm, KV, Dh)."""
    b, tm, _ = media.shape
    kvh, dh = cfg.n_kv_heads, cfg.head_dim
    return (linear(media, p["wk"]).reshape(b, tm, kvh, dh),
            linear(media, p["wv"]).reshape(b, tm, kvh, dh))


def cross_attention(p: dict, cfg, x: torch.Tensor, kv) -> torch.Tensor:
    """The attention output (B, T, H·Dh) of x's queries on ``kv``, before
    ``wo`` (the input ``wo`` is calibrated on)."""
    b, t, _ = x.shape
    q = linear(x, p["wq"]).reshape(b, t, cfg.n_heads, cfg.head_dim)
    k, v = kv
    out = flash_attention(q, k, v, causal=False,
                          kv_chunk=min(512, k.shape[1]))
    return out.reshape(b, t, -1)


def apply_cross_attn(p: dict, cfg, x: torch.Tensor, kv) -> torch.Tensor:
    """x: (B, T, D) attending on ``kv = cross_kv(p, cfg, media)`` (the
    cache's, in decode) -> (B, T, D)."""
    return linear(cross_attention(p, cfg, x, kv), p["wo"])
