"""Decoder LM: the block stack of the reference's ``models/lm.py``, with
GQA attention (llama3, qwen1.5 with qkv bias, command-r), MLA (deepseek)
or the Mamba-2 mixer (``models.ssm``; mamba2, whose blocks have no FFN) as
the mixer, or both GQA and Mamba-2 blocks in one stack (jamba's hybrid,
each block with a dense or a routed-expert FFN), or GQA and
cross-attention mixers (llama-3.2-vision: every ``cross_attn_period``-th
block attends on media rows instead of the stream), or an encoder-decoder
(whisper: non-causal encoder blocks over frame embeddings, and decoder
blocks with a cross-attention sub-layer on the encoder's output).

Parameters are a plain dict, laid out like the reference's with the layer
stack unrolled into a list (the reference stacks layer groups of
``scan_period`` blocks ``{"b0", ..., "b{P-1}"}`` on a leading axis for
``lax.scan``, after a list of ``first_dense_layers`` unstacked ``prefix``
layers; ``convert.params_from_jax`` maps both, and :func:`layer_loc` gives
a layer's place among them)::

    {"embed": (V, D), "head": (D, V), "final_norm": (D,),
     "layers": [{"mixer_norm", "mixer": {...}, "ffn_norm",
                 "ffn": {"wi", "wu", "wd"}}, ...]}

and, for an encoder-decoder, ``"encoder": {"layers": [block, ...],
"final_norm": (D,)}`` (the reference's stacked ``encoder.groups.b0``
unrolled) beside them, each decoder block with ``"cross_norm"`` and
``"cross": {"wq", "wk", "wv", "wo"}``, and after rotation ``"frame_proj"``
(D, D), the encoder rotation that the stub frontend's output projection
would absorb.  A vision model's cross-attention mixer is ``{"wq", "wk",
"wv", "wo"}`` (no biases); nothing in the params tells it from GQA, so
the block functions take its :class:`BlockMeta` (``Model.metas``).

with mixer ``{"wq", "wk", "wv", "wo"}`` (GQA; plus ``{"bq", "bk", "bv"}``
with ``qkv_bias``), ``{"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm",
"wkv_b", "wo"}`` (MLA) or ``models.ssm.init_mamba``'s leaves (a Mamba
block of mamba2 has no ``ffn_norm`` and no ``ffn``; one of jamba has
both).  A model with ``tie_embeddings``
draws no ``head``: its logits contract the (V, D) table over D
(:meth:`Model.head_logits`), and an explicit ``head`` (rotation unties
it) takes precedence.  A routed-expert layer
(``cfg.ffn_kinds()`` "moe": deepseek's layers after its dense prefix,
jamba's odd positions) has the FFN ``{"router", "experts": {"wi", "wu",
"wd"}, "shared": {"wi", "wu", "wd"}}`` of ``models.moe`` (no ``shared``
without shared experts), expert weights stacked (E, d_in, d_out).  Any
projection weight may be a ``PackedWeight`` (keep-packed serving); the
forward is the same code either way (``layers.linear``).  The KV cache is
a list of per-layer dicts, updated in place by ``decode_step``.  GQA:
``{"k", "v"}`` of shape (B, S, KV, Dh) in the activation dtype
(``kv_bits = 0``), or codes and scales ``{"k", "ks", "v", "vs"}`` as the
layer's codec lays them out (``kv_bits`` 8 or 2; S rounded up to a
``kv_chunk`` multiple).  MLA: the
latent rows ``{"c", "r"}`` (B, S, kvr|dr), or ``{"c", "cs", "r", "rs"}``
with codes (B, S, w) and scales (B, S / chunk), no head axis.  The paged
pools of the serving engine (``serving.paged``) hold the same per-layer
entries with a page axis in place of the batch and sequence axes.  A
Mamba block's cache entry is its recurrent state, ``{"conv": (B, W-1,
d_inner + 2·state)`` in the activation dtype, ``"ssm": (B, nh, hd,
state)`` fp32``}``, advanced in place by each decode step and never
quantized (a hybrid's cache holds both kinds of entry, layer by layer);
it is not paged (the engine and the chunked prefill refuse Mamba blocks,
as the reference's do).  A cross-attention layer's entry holds the K and V
of the media (or of the encoder's output) ``{"xk", "xv"}`` (B, Tm, KV, Dh)
in the activation dtype, computed once by the prefill and never
quantized, beside an enc-dec decoder block's self-attention K/V; the
engine and the chunked prefill refuse them too.  Media (``media=``, a
vision model's (B, Tm, D) patch embeddings) and frames (``frames=``, an
encoder's (B, Tf, D) input) are cast to the model's dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import matmul, resolve_device
from repro_torch.kernels.attn_colsum.ops import attn_colsum
from repro_torch.models import attention as att
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.layers import (apply_dense_ffn, capture_dense_ffn,
                                       cross_entropy_chunked, dense_init,
                                       embed_lookup, init_dense_ffn,
                                       init_embedding, linear, rms_norm)


def _positions(x: torch.Tensor, positions) -> torch.Tensor:
    if positions is None:
        return torch.arange(x.shape[1], device=x.device)
    return positions


def _is_mla(cfg: ModelConfig) -> bool:
    return cfg.attn_kind == "mla"


def layer_loc(cfg: ModelConfig, li: int) -> list:
    """The reference's location of decoder layer ``li`` (packed artifact
    entries): ``["prefix", li]`` for the first ``first_dense_layers``
    layers, ``["groups", g, o]`` for the stacked ones after them, block
    ``o`` of layer group ``g`` (``scan_period`` blocks a group)."""
    if li < cfg.first_dense_layers:
        return ["prefix", li]
    return ["groups", *divmod(li - cfg.first_dense_layers, cfg.scan_period)]


def check_groups(cfg: ModelConfig) -> None:
    """Refuse a body (the layers after the prefix) that is not a whole
    number of layer groups: the reference stacks ``scan_period`` blocks a
    group and has no place for a partial one."""
    body, period = cfg.n_layers - cfg.first_dense_layers, cfg.scan_period
    if body % period:
        raise ValueError(
            f"{cfg.name}: {body} layers after the {cfg.first_dense_layers} "
            f"prefix layers are not a multiple of its scan period {period} "
            f"(a layer group holds {period} blocks); cut the depth to a "
            f"multiple of {period}")


@dataclasses.dataclass(frozen=True)
class BlockMeta:
    """What a block's params do not say: ``cross``, a cross-attention
    mixer (its leaves are GQA's without biases); ``causal``, False for an
    encoder block's self-attention."""
    cross: bool = False
    causal: bool = True


DECODER = BlockMeta()
CROSS = BlockMeta(cross=True)
ENCODER = BlockMeta(causal=False)


def block_metas(cfg: ModelConfig) -> list[BlockMeta]:
    """Each decoder layer's meta, from ``cfg.layer_kinds()``."""
    return [CROSS if kind == "cross" else DECODER
            for kind in cfg.layer_kinds()]


def init_block(gen, cfg: ModelConfig, dtype, device, ffn: str = "dense",
               mixer: str = "attn", has_cross: bool = False) -> dict:
    """One block's params; ``mixer`` and ``ffn`` are the layer's
    ``cfg.layer_kinds()`` ("attn", "mamba" or "cross") and
    ``cfg.ffn_kinds()`` ("dense", "moe" or "none") entries; ``has_cross``
    adds an enc-dec decoder block's cross-attention sub-layer."""
    d = cfg.d_model
    if mixer == "mamba":
        init_mixer = ssm.init_mamba
    elif mixer == "cross":
        init_mixer = att.init_cross_attn
    else:
        init_mixer = att.init_mla if _is_mla(cfg) else att.init_gqa
    p = {"mixer_norm": torch.ones((d,), dtype=dtype, device=device),
         "mixer": init_mixer(gen, cfg, dtype, device)}
    if has_cross:
        p["cross_norm"] = torch.ones((d,), dtype=dtype, device=device)
        p["cross"] = att.init_cross_attn(gen, cfg, dtype, device)
    if ffn != "none":
        p["ffn_norm"] = torch.ones((d,), dtype=dtype, device=device)
        p["ffn"] = (moe.init_moe(gen, cfg, dtype, device) if ffn == "moe"
                    else init_dense_ffn(gen, d, cfg.d_ff, dtype, device))
    return p


def _is_moe(p: dict) -> bool:
    return "experts" in p["ffn"]


def _is_mamba(p: dict) -> bool:
    return "wzx" in p["mixer"]


def _refuse_unpaged(p: dict, what: str, state: str) -> None:
    """The paged paths' refusal of a Mamba block or of a block with
    cross-attention, in the reference's words."""
    kind = "mamba" if _is_mamba(p) else "cross" if "cross" in p else None
    if kind:
        raise NotImplementedError(
            f"{what} supports attn/mla mixers, got {kind!r} — ssm/cross "
            f"state is {state}, not per-page; serve such models through "
            f"the flat generate() path")


def _cross_kv(p: dict, cfg: ModelConfig, media):
    """The K/V of a block's cross-attention sub-layer on ``media`` (None
    for a block without one)."""
    return att.cross_kv(p["cross"], cfg, media) if "cross" in p else None


def _qkv(p: dict, cfg: ModelConfig, h: torch.Tensor, positions):
    """Prefill-side (q, k, v, fp cache entry) of the block's mixer: GQA's
    post-rope K/V, or MLA's expanded per-head q, k, v and its latent rows
    ``{"c", "r"}``."""
    if _is_mla(cfg):
        q, k, v, c_kv, k_rope = att.mla_qkv(p["mixer"], cfg, h, positions)
        return q, k, v, {"c": c_kv, "r": k_rope}
    q, k, v = att.gqa_qkv(p["mixer"], cfg, h, positions)
    return q, k, v, {"k": k, "v": v}


def apply_block(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                positions=None, aux: Optional[list] = None, media=None,
                meta: BlockMeta = DECODER):
    """Full-sequence forward (prefill / calibration).
    Returns (x, cache) with the block's fp cache entry (``{"k", "v"}`` or
    MLA's ``{"c", "r"}``; a cross-attention mixer's ``{"xk", "xv"}``, and
    an enc-dec decoder block's self-attention K/V with them).  ``aux``,
    where given, receives a routed-expert FFN's load-balance loss;
    ``media`` (B, Tm, D) is what cross-attention attends on."""
    positions = _positions(x, positions)
    t = x.shape[1]
    h = rms_norm(x, p["mixer_norm"], cfg.norm_eps)
    if _is_mamba(p):
        mix, (conv, state) = ssm.apply_mamba(p["mixer"], cfg, h,
                                             return_state=True)
        return _ffn_out(p, cfg, x, mix, aux), {"conv": conv, "ssm": state}
    if meta.cross:
        k, v = att.cross_kv(p["mixer"], cfg, media)
        mix = att.apply_cross_attn(p["mixer"], cfg, h, (k, v))
        return _ffn_out(p, cfg, x, mix, aux), {"xk": k, "xv": v}
    q, k, v, cache = _qkv(p, cfg, h, positions)
    out = att.flash_attention(q, k, v, causal=meta.causal,
                              kv_chunk=min(512, t))
    xkv = _cross_kv(p, cfg, media)
    if xkv is not None:
        cache.update(xk=xkv[0], xv=xkv[1])
    return _mix_out(p, cfg, x, out, aux, xkv), cache


def _ffn_out(p: dict, cfg: ModelConfig, x: torch.Tensor,
             mix: torch.Tensor, aux: Optional[list] = None,
             xkv=None) -> torch.Tensor:
    """Residual of the mixer's output, an enc-dec decoder block's
    cross-attention sub-layer on ``xkv`` (its K/V of the encoder's
    output), and the FFN half of a block (dense or routed experts;
    mamba2's blocks have none); a routed-expert FFN's load-balance loss
    goes to ``aux`` where it is given."""
    x = x + mix
    if "cross" in p:
        hc = rms_norm(x, p["cross_norm"], cfg.norm_eps)
        x = x + att.apply_cross_attn(p["cross"], cfg, hc, xkv)
    if "ffn" not in p:
        return x
    hf = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if _is_moe(p):
        y, a = moe.apply_moe(p["ffn"], cfg, hf)
        if aux is not None:
            aux.append(a)
        return x + y
    return x + apply_dense_ffn(p["ffn"], hf)


def _mix_out(p: dict, cfg: ModelConfig, x: torch.Tensor,
             out: torch.Tensor, aux: Optional[list] = None,
             xkv=None) -> torch.Tensor:
    """Attention output projection, residual and the rest of a block."""
    b, t = out.shape[:2]
    return _ffn_out(p, cfg, x, linear(out.reshape(b, t, -1),
                                      p["mixer"]["wo"]), aux, xkv)


def decode_block(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
                 pos, meta: BlockMeta = DECODER) -> torch.Tensor:
    """One-token step. x: (B, 1, D); writes this token's K/V (or its codes
    and scales) into the cache at ``pos`` (in place) and attends over
    positions <= pos, on the codes directly for a quantized cache.
    ``pos``: an int, or a 0-d or (1,) int tensor on the device (the same
    bits either way; a captured loop's position changes at replay).
    Cross-attention attends on the cache's ``xk`` / ``xv``, which a step
    does not change."""
    codec = att.kv_codec(cfg.kv_bits, cfg.kv_chunk)
    h = rms_norm(x, p["mixer_norm"], cfg.norm_eps)
    if _is_mamba(p):  # no position: the state carries the sequence
        return _ffn_out(p, cfg, x, ssm.mamba_decode(
            p["mixer"], cfg, h, cache["conv"], cache["ssm"]))
    xkv = (cache["xk"], cache["xv"]) if "xk" in cache else None
    if meta.cross:
        return _ffn_out(p, cfg, x, att.apply_cross_attn(p["mixer"], cfg, h,
                                                        xkv))
    positions = att.position_index(pos, x.device)
    if _is_mla(cfg):
        c_kv, k_rope = att.mla_latent(p["mixer"], cfg, h, positions)
        if codec.quantized:
            codec.append(cache["c"], cache["cs"], c_kv, positions)
            codec.append(cache["r"], cache["rs"], k_rope, positions)
        else:
            cache["c"].index_copy_(1, positions, c_kv)
            cache["r"].index_copy_(1, positions, k_rope)
        mix = att.mla_decode(
            p["mixer"], cfg, h, cache["c"], cache["r"], positions,
            c_scale=cache.get("cs"), r_scale=cache.get("rs"),
            kv_bits=codec.kv_bits, chunk=codec.chunk,
            tile=codec.page_tokens if codec.quantized else 1)
        return _ffn_out(p, cfg, x, mix)
    q, k, v = att.gqa_qkv(p["mixer"], cfg, h, positions)
    if codec.quantized:
        codec.append(cache["k"], cache["ks"], k, positions)
        codec.append(cache["v"], cache["vs"], v, positions)
        out = att.decode_attention_quantized(
            q, cache["k"], cache["ks"], cache["v"], cache["vs"], positions,
            kv_bits=codec.kv_bits, chunk=codec.chunk,
            tile=codec.page_tokens)
    else:
        cache["k"].index_copy_(1, positions, k)
        cache["v"].index_copy_(1, positions, v)
        out = att.decode_attention(q, cache["k"], cache["v"], positions)
    return _mix_out(p, cfg, x, out, xkv=xkv)


def paged_decode_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       pools: dict, page_tbl: torch.Tensor, pos: torch.Tensor,
                       active: torch.Tensor) -> torch.Tensor:
    """One-token step of every engine slot against this layer's paged pools
    (written in place).  x: (B, 1, D); page_tbl: (B, n_tiles); pos: (B,)
    per-slot positions; active: (B,) bool.  Per-slot rope positions and
    the per-slot mask of the paged kernel are the only differences from
    :func:`decode_block`: a slot's output is the flat step's at the same
    position."""
    _refuse_unpaged(p, "paged decode", "per-slot")
    codec = att.kv_codec(cfg.kv_bits, cfg.kv_chunk)
    b = x.shape[0]
    h = rms_norm(x, p["mixer_norm"], cfg.norm_eps)
    tile = torch.clamp(pos // codec.page_tokens, max=page_tbl.shape[1] - 1)
    pid = page_tbl[torch.arange(b, device=x.device), tile.long()].long()
    pos_l = pos.long()
    if _is_mla(cfg):
        c_kv, k_rope = att.mla_latent(p["mixer"], cfg, h, pos[:, None])
        att.kv_paged_append(codec, pools["c"], pools["cs"], c_kv, pid, pos_l,
                            active)
        att.kv_paged_append(codec, pools["r"], pools["rs"], k_rope, pid,
                            pos_l, active)
        mix = att.mla_decode_paged(p["mixer"], cfg, h, pools, page_tbl, pos,
                                   kv_bits=codec.kv_bits, chunk=codec.chunk)
        return _ffn_out(p, cfg, x, mix)
    q, k, v = att.gqa_qkv(p["mixer"], cfg, h, pos[:, None])
    att.kv_paged_append(codec, pools["k"], pools["ks"], k, pid, pos_l, active)
    att.kv_paged_append(codec, pools["v"], pools["vs"], v, pid, pos_l, active)
    out = att.paged_decode_attention_quantized(
        q, pools["k"], pools["ks"], pools["v"], pools["vs"], page_tbl, pos,
        kv_bits=codec.kv_bits, chunk=codec.chunk)
    return _mix_out(p, cfg, x, out)


def pad_cache_entry(c: dict, codec, s: int) -> dict:
    """Zero-pad one layer's cache entries along the sequence axis to ``s``
    rows (codes) and ``codec.scale_rows(s)`` rows (scales).  Codes are
    padded after encoding the real rows (a zero kv2 row would encode to
    code 2, not 0); the zero rows are what the kernels mask out.  A Mamba
    block's state (``conv``, ``ssm``) is not sequence-indexed and passes
    through."""
    out = {}
    for key, a in c.items():
        if key in _KEPT:
            out[key] = a
            continue
        tgt = s if key in _SCALE_OF else codec.scale_rows(s)
        pad = a.new_zeros((a.shape[0], tgt - a.shape[1]) + a.shape[2:])
        out[key] = torch.cat([a, pad], dim=1)
    return out


# each sequence-indexed cache entry and the entry of its scales
_SCALE_OF = {"k": "ks", "v": "vs", "c": "cs", "r": "rs"}
# kept as they are whatever the KV codec: a Mamba block's recurrent state,
# and cross-attention's K/V of the media (or of the encoder's output)
_KEPT = ("conv", "ssm", "xk", "xv")


def _encode_cache(codec, entry: dict) -> dict:
    """{"k", "v"} or {"c", "r"} fp rows -> codes and scales,
    {"k", "ks", "v", "vs"} or {"c", "cs", "r", "rs"}; a Mamba state and
    cross-attention's K/V pass through."""
    out = {}
    for key, a in entry.items():
        if key in _KEPT:
            out[key] = a
        else:
            out[key], out[_SCALE_OF[key]] = codec.encode(a)
    return out


def ingest_block(p: dict, cfg: ModelConfig, x: torch.Tensor, buf: dict,
                 start: int, positions: torch.Tensor, t_total: int):
    """One prompt chunk through one block against fp prefix buffers (exact
    chunked prefill).

    x: (1, L, D) chunk rows; buf: this layer's fp K/V buffers of the whole
    prompt's length ``t_total`` (GQA: post-rope K/V; MLA: the expanded
    per-head K/V, flash_attention's operands; written in place); start:
    page-aligned
    chunk offset.  flash_attention runs with ``q_offset=start`` and
    ``kv_chunk=min(512, t_total)``: the same KV chunks in the same order
    under the same mask as the whole-prompt prefill, and every other op is
    row-wise, so hidden rows, codes and logits are the whole prompt's.
    Returns (x, chunk_cache) with the chunk rows' codes."""
    _refuse_unpaged(p, "chunked prefill", "sequential")
    codec = att.kv_codec(cfg.kv_bits, cfg.kv_chunk)
    h = rms_norm(x, p["mixer_norm"], cfg.norm_eps)
    t = h.shape[1]
    q, k, v, cache = _qkv(p, cfg, h, positions)
    buf["k"][:, start:start + t] = k
    buf["v"][:, start:start + t] = v
    out = att.flash_attention(q, buf["k"], buf["v"],
                              kv_chunk=min(512, t_total), q_offset=start)
    return _mix_out(p, cfg, x, out), _encode_cache(codec, cache)


def paged_extend_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       pools: dict, tbl: torch.Tensor,
                       positions: torch.Tensor):
    """One prompt chunk through one block against the request's quantized
    pages (the "paged" chunked prefill): earlier chunks are read back as
    codes through the extend kernel, the chunk's own rows attend in fp.
    No fp prefix buffer, but lossy against the whole-prompt prefill.
    tbl: (n_past,) pages of the already-ingested chunks.  Returns
    (x, chunk_cache)."""
    _refuse_unpaged(p, "chunked prefill", "sequential")
    codec = att.kv_codec(cfg.kv_bits, cfg.kv_chunk)
    h = rms_norm(x, p["mixer_norm"], cfg.norm_eps)
    if _is_mla(cfg):
        c_kv, k_rope = att.mla_latent(p["mixer"], cfg, h, positions)
        mix = att.mla_extend_paged(p["mixer"], cfg, h, c_kv, k_rope, pools,
                                   tbl, positions, kv_bits=codec.kv_bits,
                                   chunk=codec.chunk)
        return _ffn_out(p, cfg, x, mix), _encode_cache(
            codec, {"c": c_kv, "r": k_rope})
    q, k, v = att.gqa_qkv(p["mixer"], cfg, h, positions)
    out = att.paged_extend_attention_quantized(
        q, k, v, pools["k"], pools["ks"], pools["v"], pools["vs"], tbl,
        kv_bits=codec.kv_bits, chunk=codec.chunk)
    return _mix_out(p, cfg, x, out), _encode_cache(codec, {"k": k, "v": v})


def capture_block(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                  positions=None, media=None, meta: BlockMeta = DECODER):
    """Calibration forward of one block for the RSQ pipeline.

    Returns (y, caps, domains, colsum): ``caps`` maps each weight path to
    its input (B, T, d_in), or (E, C, d_in) capacity buffers for a routed
    expert stack (domain "expert", with the slot -> token map (E·C,) in
    ``caps["ffn/__moe_slot_token"]``, T for an empty slot; a MoE layer's
    shared FFN sees (B·T, d_in)), ``domains`` to "stream", "hidden",
    "media" or "expert", and
    ``colsum`` is the (B, T) AttnCon score from the ``attn_colsum`` kernel
    (the reference takes it from ``flash_attention(colsum=True)``; MLA's
    from the expanded per-head q and k, H = KV heads of dn + dr; an
    encoder block's from the full, non-causal map).  A Mamba
    block's four projections are all "stream" and its ``colsum`` is None:
    AttnCon falls back to ActNorm there, as in the reference; its FFN,
    where it has one (jamba), is captured as an attention block's.  A
    cross-attention mixer's ``wk`` / ``wv`` (and an enc-dec decoder
    block's ``cross/wk`` / ``cross/wv``) read the media rows (B, Tm, D),
    domain "media", which take no token importance; a cross mixer's
    ``colsum`` is None (ActNorm again)."""
    positions = _positions(x, positions)
    b, t, _ = x.shape
    h = rms_norm(x, p["mixer_norm"], cfg.norm_eps)
    if _is_mamba(p):
        mix, m_caps = ssm.capture_mamba(p["mixer"], cfg, h)
        caps = {f"mixer/{name}": inp for name, inp in m_caps.items()}
        return _capture_ffn(p, cfg, x + mix, caps,
                            {path: "stream" for path in caps}, None)
    if meta.cross:
        caps, dom, mix = _capture_cross(p["mixer"], cfg, h, media, "mixer")
        return _capture_ffn(p, cfg, x + mix, caps, dom, None)
    if _is_mla(cfg):
        q, k, v, c_kv, _, ql = att.mla_qkv_inputs(p["mixer"], cfg, h,
                                                  positions)
        caps = ({"mixer/wq_a": h, "mixer/wq_b": ql} if ql is not None
                else {"mixer/wq": h})
        caps.update({"mixer/wkv_a": h, "mixer/wkv_b": c_kv})
    else:
        q, k, v = att.gqa_qkv(p["mixer"], cfg, h, positions)
        caps = {"mixer/wq": h, "mixer/wk": h, "mixer/wv": h}
    out = att.flash_attention(q, k, v, causal=meta.causal,
                              kv_chunk=min(512, t))
    colsum = attn_colsum(q, k, causal=meta.causal)
    attn_out = out.reshape(b, t, -1)
    caps["mixer/wo"] = attn_out
    dom = {path: "stream" for path in caps}
    x = x + linear(attn_out, p["mixer"]["wo"])
    if "cross" in p:
        hc = rms_norm(x, p["cross_norm"], cfg.norm_eps)
        c_caps, c_dom, mix = _capture_cross(p["cross"], cfg, hc, media,
                                            "cross")
        caps.update(c_caps)
        dom.update(c_dom)
        x = x + mix
    return _capture_ffn(p, cfg, x, caps, dom, colsum)


def _capture_cross(pc: dict, cfg: ModelConfig, h: torch.Tensor, media,
                   name: str) -> tuple[dict, dict, torch.Tensor]:
    """Cross-attention ``pc`` (at ``name``: "mixer" or "cross") of the
    normed stream ``h`` on ``media``: its weights' inputs, their domains
    and its output (B, T, D)."""
    out = att.cross_attention(pc, cfg, h, att.cross_kv(pc, cfg, media))
    caps = {f"{name}/wq": h, f"{name}/wk": media, f"{name}/wv": media,
            f"{name}/wo": out}
    dom = {f"{name}/wq": "stream", f"{name}/wk": "media",
           f"{name}/wv": "media", f"{name}/wo": "stream"}
    return caps, dom, linear(out, pc["wo"])


def _capture_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor, caps: dict,
                 dom: dict, colsum):
    """The FFN half of :func:`capture_block` after the mixer's residual
    ``x``: adds the FFN's inputs to ``caps`` and ``dom`` (in place) and
    returns capture_block's (y, caps, domains, colsum); a block without an
    FFN returns ``x``."""
    if "ffn" not in p:
        return x, caps, dom, colsum
    hf = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if not _is_moe(p):
        y, f_caps = capture_dense_ffn(p["ffn"], hf)
        for name, inp in f_caps.items():
            caps[f"ffn/{name}"] = inp
            dom[f"ffn/{name}"] = "hidden" if name == "wd" else "stream"
        return x + y, caps, dom, colsum
    y, _, m_caps = moe.capture_moe(p["ffn"], cfg, hf)
    for name, inp in m_caps.items():
        if name == "__slot_token":
            caps["ffn/__moe_slot_token"] = inp
            continue
        caps[f"ffn/{name}"] = inp
        dom[f"ffn/{name}"] = ("expert" if name.startswith("experts/") else
                              "hidden" if name.endswith("wd") else "stream")
    return x + y, caps, dom, colsum


class Model:
    """Decoder of GQA blocks with dense FFNs (qkv bias and tied embeddings
    allowed), of MLA blocks with dense or routed-expert FFNs, of Mamba-2
    blocks, of GQA and Mamba-2 blocks with dense or routed-expert FFNs
    (the hybrid), of GQA and cross-attention blocks with dense FFNs (a
    vision model), or an encoder-decoder of GQA blocks with dense FFNs
    (whisper), for one ``ModelConfig`` on one device."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        kinds, ffns = set(cfg.layer_kinds()), set(cfg.ffn_kinds())
        if cfg.family == "ssm":
            ok = kinds == {"mamba"} and ffns == {"none"}
        elif cfg.family == "hybrid":
            ok = cfg.attn_kind == "gqa" and kinds <= {"attn", "mamba"} \
                and ffns <= {"dense", "moe"}
        elif cfg.family in ("vlm", "encdec"):
            ok = cfg.attn_kind == "gqa" and kinds <= {"attn", "cross"} \
                and ffns == {"dense"}
        elif cfg.attn_kind == "mla":
            ok = kinds == {"attn"} and ffns <= {"dense", "moe"}
        else:
            ok = cfg.family == "dense" and cfg.attn_kind == "gqa"
        if not ok:
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}): the port serves dense GQA "
                f"decoders, MLA decoders with dense or routed-expert FFNs, "
                f"Mamba-2 decoders, GQA / Mamba-2 hybrids, and GQA decoders "
                f"with dense FFNs and cross-attention (vision, enc-dec); "
                f"layers {sorted(kinds)} with FFNs {sorted(ffns)} are later "
                f"slices")
        check_groups(cfg)
        self.cfg = cfg
        self.metas = block_metas(cfg)
        self.encdec = cfg.family == "encdec"
        self.codec = att.kv_codec(cfg.kv_bits, cfg.kv_chunk)  # checks bits
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        # launch.serve.generate's captured decode loops over this model, by
        # (params, batch, prompt length, n_gen, sampled): each holds its
        # static cache and the params it was captured on, and goes with
        # the model
        self.graphs: dict = {}

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator) -> dict:
        """Random parameters drawn from ``gen`` (which must live on the
        model's device)."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        params = {
            "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dt, dev),
            "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev)}
        if not cfg.tie_embeddings:
            params["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt,
                                        dev)
        params["layers"] = [
            init_block(gen, cfg, dt, dev, ffn, mixer, has_cross=self.encdec)
            for mixer, ffn in zip(cfg.layer_kinds(), cfg.ffn_kinds())]
        if self.encdec:
            params["encoder"] = {
                "layers": [init_block(gen, cfg, dt, dev)
                           for _ in range(cfg.n_encoder_layers)],
                "final_norm": torch.ones((cfg.d_model,), dtype=dt,
                                         device=dev)}
        return params

    # --------------------------------------------------------------- forward
    def embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        return embed_lookup(params["embed"], tokens).to(self.dtype)

    def encode(self, params: dict, frames: torch.Tensor) -> torch.Tensor:
        """(B, Tf, D) frame embeddings -> the encoder's output (B, Tf, D),
        after its final norm: the decoder's media.  A rotated model's
        ``frame_proj`` takes the frames into the encoder's rotated basis
        first."""
        x = frames.to(self.dtype)
        if "frame_proj" in params:
            x = x @ params["frame_proj"].to(x.dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        for p_blk in params["encoder"]["layers"]:
            x, _ = apply_block(p_blk, self.cfg, x, positions=positions,
                               meta=ENCODER)
        return rms_norm(x, params["encoder"]["final_norm"],
                        self.cfg.norm_eps)

    def media(self, params: dict, media=None, frames=None):
        """What cross-attention attends on: the encoder's output of
        ``frames`` (enc-dec), ``media`` in the model's dtype (vision), or
        None (a model without cross-attention)."""
        if self.encdec:
            if frames is None:
                raise ValueError(f"{self.cfg.name}: an encoder-decoder "
                                 f"takes frames=(B, Tf, d_model)")
            return self.encode(params, frames)
        if any(m.cross for m in self.metas):
            if media is None:
                raise ValueError(f"{self.cfg.name}: cross-attention layers "
                                 f"take media=(B, Tm, d_model)")
            return media.to(self.dtype)
        return None

    def hidden_states(self, params: dict, tokens: torch.Tensor, *,
                      media=None, frames=None,
                      aux: Optional[list] = None) -> torch.Tensor:
        """(B, T) tokens -> (B, T, D) final hidden states (post final norm);
        ``aux``, where given, receives each routed-expert layer's
        load-balance loss, in layer order."""
        x = self.embed(params, tokens)
        med = self.media(params, media, frames)
        positions = torch.arange(tokens.shape[1], device=x.device)
        for p_blk, meta in zip(params["layers"], self.metas):
            x, _ = apply_block(p_blk, self.cfg, x, positions=positions,
                               aux=aux, media=med, meta=meta)
        return rms_norm(x, params["final_norm"], self.cfg.norm_eps)

    def head_logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """(..., D) -> (..., V) fp32 logits.  A tied model (no ``head``)
        contracts the (V, D) table over D through a transposed view: no
        (D, V) copy, which a captured decode would make at every step."""
        if "head" in params:
            return linear(x, params["head"]).float()
        return matmul(x, params["embed"].to(x.dtype).T).float()

    def logits(self, params: dict, tokens: torch.Tensor, *, media=None,
               frames=None) -> torch.Tensor:
        return self.head_logits(params, self.hidden_states(
            params, tokens, media=media, frames=frames))

    def loss(self, params: dict, tokens: torch.Tensor,
             labels: torch.Tensor, *, media=None,
             frames=None) -> torch.Tensor:
        """The reference's: next-token cross entropy plus 0.01 x the sum of
        the routed-expert layers' load-balance losses (0 without experts)."""
        aux: list = []
        x = self.hidden_states(params, tokens, media=media, frames=frames,
                               aux=aux)
        head = params["head"] if "head" in params else params["embed"].T
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for a in aux:  # summed in layer order, from 0, as the reference
            total = total + a
        return cross_entropy_chunked(x, head, labels) + 0.01 * total

    # --------------------------------------------------------------- serving
    def _cache_len(self, s: int) -> int:
        """Allocated cache length: the codec's ``round_len`` (a quantized
        cache rounds up to a ``kv_chunk`` multiple, which is also the page
        size, so flat and paged capacity share one rule)."""
        return self.codec.round_len(s)

    def init_cache(self, batch: int, cache_len: int,
                   media_len: int = 0) -> list[dict]:
        """A zero cache of ``cache_len`` positions (rounded by the codec);
        cross-attention entries hold ``media_len`` media rows."""
        cfg, codec, dev = self.cfg, self.codec, self.device
        s = self._cache_len(cache_len)
        kvh, dh = cfg.n_kv_heads, cfg.head_dim
        crossed = self.encdec or any(m.cross for m in self.metas)
        if crossed and media_len < 1:
            raise ValueError(f"{cfg.name}: a cache of cross-attention layers "
                             f"needs media_len, the media (or frame) rows")

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def cross_entry() -> dict:
            shape = (batch, media_len, kvh, dh)
            return {"xk": zeros(shape, self.dtype),
                    "xv": zeros(shape, self.dtype)}

        def mla_entry() -> dict:
            kvr, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
            if not codec.quantized:
                return {"c": zeros((batch, s, kvr), self.dtype),
                        "r": zeros((batch, s, dr), self.dtype)}
            scales = (batch, codec.scale_rows(s))
            return {"c": zeros((batch, s, codec.code_cols(kvr)),
                               codec.code_dtype),
                    "cs": zeros(scales, codec.scale_dtype),
                    "r": zeros((batch, s, codec.code_cols(dr)),
                               codec.code_dtype),
                    "rs": zeros(scales, codec.scale_dtype)}

        def entry(kind: str) -> dict:
            if kind == "cross":
                return cross_entry()
            if self.encdec:
                return {**self_entry(kind), **cross_entry()}
            return self_entry(kind)

        def self_entry(kind: str) -> dict:
            if kind == "mamba":
                return {"conv": zeros((batch, cfg.ssm_conv_width - 1,
                                       cfg.d_inner + 2 * cfg.ssm_d_state),
                                      self.dtype),
                        "ssm": zeros((batch, cfg.ssm_n_heads,
                                      cfg.ssm_head_dim, cfg.ssm_d_state),
                                     torch.float32)}
            if _is_mla(cfg):
                return mla_entry()
            if not codec.quantized:
                shape = (batch, s, kvh, dh)
                return {"k": torch.zeros(shape, dtype=self.dtype, device=dev),
                        "v": torch.zeros(shape, dtype=self.dtype, device=dev)}
            codes = (batch, s, kvh, codec.code_cols(dh))
            scales = (batch, codec.scale_rows(s), kvh)
            return {
                "k": torch.zeros(codes, dtype=codec.code_dtype, device=dev),
                "ks": torch.zeros(scales, dtype=codec.scale_dtype, device=dev),
                "v": torch.zeros(codes, dtype=codec.code_dtype, device=dev),
                "vs": torch.zeros(scales, dtype=codec.scale_dtype, device=dev)}

        return [entry(kind) for kind in cfg.layer_kinds()]

    def prefill(self, params: dict, tokens: torch.Tensor, *, media=None,
                frames=None, cache_len: Optional[int] = None,
                logits: bool = True):
        """Returns (last-token logits (B, V) fp32, cache of length
        ``cache_len`` (default T), rounded by the codec).  A quantized cache
        is written already encoded: the prompt's K/V never sit in the cache
        in fp.

        ``logits=False`` returns ``(None, cache)``: the engine's resume of a
        preempted request rebuilds its pages through this same prefill, but
        its token 0 was drawn before the preemption, so the vocab-wide head
        product is skipped.  A Mamba block's entry is its state after the
        prompt; a cross-attention layer's holds the K/V of the media (of
        the encoder's output of ``frames``), in fp whatever the codec.  The
        reference's enc-dec cache also keeps the encoder's output
        (``cache["media"]``); no decode step reads it, and this cache (a
        list of layer entries) does not."""
        b, t = tokens.shape
        s = self._cache_len(cache_len or t)
        x = self.embed(params, tokens)
        med = self.media(params, media, frames)
        positions = torch.arange(t, device=x.device)
        cache = []
        for p_blk, meta in zip(params["layers"], self.metas):
            x, kv = apply_block(p_blk, self.cfg, x, positions=positions,
                                media=med, meta=meta)
            if self.codec.quantized:
                cache.append(pad_cache_entry(
                    _encode_cache(self.codec, kv), self.codec, s))
            else:
                cache.append(pad_cache_entry(kv, self.codec, s))
        if not logits:
            return None, cache
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self.head_logits(params, x[:, -1]), cache

    def decode_step(self, params: dict, cache: list[dict],
                    token: torch.Tensor, pos) -> torch.Tensor:
        """token: (B, 1); pos: its position, an int or a 0-d or (1,) int
        tensor on the device (what a captured loop passes: the same logits
        and cache bytes as the int).  Updates ``cache`` in place and
        returns the (B, V) fp32 logits."""
        pos = att.position_index(pos, self.device)
        x = self.embed(params, token)
        for p_blk, c, meta in zip(params["layers"], cache, self.metas):
            x = decode_block(p_blk, self.cfg, x, c, pos, meta)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self.head_logits(params, x[:, 0])

    def paged_decode_step(self, params: dict, pools: list[dict],
                          page_tbl: torch.Tensor, token: torch.Tensor,
                          pos: torch.Tensor,
                          active: torch.Tensor) -> torch.Tensor:
        """One decode step of every engine slot against the paged pools
        (written in place).  token: (B, 1); page_tbl: (B, n_tiles), one
        table for every layer (a request holds the same pages in each);
        pos/active: (B,) per-slot position and liveness, on the device.
        Returns (B, V) fp32 logits."""
        x = self.embed(params, token)
        for p_blk, c in zip(params["layers"], pools):
            x = paged_decode_block(p_blk, self.cfg, x, c, page_tbl, pos,
                                   active)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self.head_logits(params, x[:, 0])

    # ------------------------------------------------------- chunked prefill
    def init_ingest(self, t_total: int) -> list[dict]:
        """Transient fp prefix buffers (flash_attention's K and V operands
        of every layer: GQA's post-rope K/V, MLA's expanded per-head K of
        dn + dr and V of dv) for the exact chunked prefill of one request
        of prompt length ``t_total``; they live only while the request is
        ingesting."""
        cfg = self.cfg
        kinds = set(cfg.layer_kinds()) | ({"cross"} if self.encdec else set())
        for kind in ("mamba", "cross"):
            if kind in kinds:
                raise NotImplementedError(
                    f"chunked prefill supports attn/mla mixers, got "
                    f"{kind!r}")
        if _is_mla(cfg):
            k_shape = (1, t_total, cfg.n_heads,
                       cfg.qk_nope_dim + cfg.qk_rope_dim)
            v_shape = (1, t_total, cfg.n_heads, cfg.v_head_dim)
        else:
            k_shape = v_shape = (1, t_total, cfg.n_kv_heads, cfg.head_dim)
        return [{"k": torch.zeros(k_shape, dtype=self.dtype,
                                  device=self.device),
                 "v": torch.zeros(v_shape, dtype=self.dtype,
                                  device=self.device)}
                for _ in range(cfg.n_layers)]

    def paged_extend_step(self, params: dict, tokens: torch.Tensor,
                          start: int, state: Optional[list], *,
                          t_total: int, last: bool, pools=None,
                          page_tbl: Optional[torch.Tensor] = None):
        """Ingest one page-aligned prompt chunk of one request.

        tokens: (1, L); start: chunk offset (a page multiple); ``state``:
        the prefix buffers of :meth:`init_ingest` (exact mode, updated in
        place), or None with ``pools`` and ``page_tbl`` (the request's
        already-written pages, (n_past,)) for the paged mode.  Returns
        (logits (1, V) when ``last`` else None, chunk_cache): the chunk's
        codes in prefill-cache layout, padded to a page multiple, ready for
        ``PagedPools.write_prefill``."""
        cfg = self.cfg
        L = tokens.shape[1]
        s_pad = self._cache_len(L)
        x = self.embed(params, tokens)
        positions = start + torch.arange(L, device=x.device)
        caches = []
        for i, p_blk in enumerate(params["layers"]):
            if state is not None:
                x, cc = ingest_block(p_blk, cfg, x, state[i], start,
                                     positions, t_total)
            else:
                x, cc = paged_extend_block(p_blk, cfg, x, pools[i], page_tbl,
                                           positions)
            caches.append(pad_cache_entry(cc, self.codec, s_pad))
        logits = None
        if last:
            x = rms_norm(x, params["final_norm"], cfg.norm_eps)
            logits = self.head_logits(params, x[:, -1])
        return logits, caches
