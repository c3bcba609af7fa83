"""Plain PyTorch versions of the quantized-KV flash-decode kernels.

Each walks the cache tile by tile with the reference's running
``(m, l, acc)`` triple: a tile is dequantized on its own (the cache is
never materialized in fp), scored against the query group and folded in by
:func:`tile_update`.  The flat and the paged versions share one tile loop
(:func:`_decode_tiles`) and differ only in where a tile's rows come from,
so at tile = page they give bitwise the same partials for the same codes.
Masked tiles are exact no-ops of :func:`tile_update`, so tiles past
``pos`` and trash or stale page-table entries never reach the result.
"""
from __future__ import annotations

import torch

from repro_torch.device import matmul

NEG_INF = -1e30


def kv_unpack(words: torch.Tensor, d: int) -> torch.Tensor:
    """(..., ceil(D/16)) int32 words (uint32 bits) -> (..., D) int32 codes
    in 0..3; code j of a word sits at bits [2j, 2j+2)."""
    shifts = torch.arange(16, dtype=torch.int64, device=words.device) * 2
    w64 = words.to(torch.int64) & 0xFFFFFFFF  # uint32 bits, never negative
    c = (w64[..., None] >> shifts) & 3
    return c.reshape(*words.shape[:-1], -1)[..., :d].to(torch.int32)


def dequant_kv(codes: torch.Tensor, scale: torch.Tensor, *, kv_bits: int,
               chunk: int, d: int) -> torch.Tensor:
    """Dequantize a tile.  codes: (..., rows, d) int8 or (..., rows,
    ceil(d/16)) int32 words; scale: (..., rows // chunk) bf16, one per row
    (kv8) or per ``chunk`` rows (kv2).  Returns (..., rows, d) fp32."""
    s = scale.float()
    if chunk > 1:
        s = s.repeat_interleave(chunk, dim=-1)
    s = s[..., None]
    if kv_bits == 8:  # kv_quantize folds the /127 into the stored scale
        return codes.float() * s
    c = kv_unpack(codes, d)
    # log levels scale * [-1, -0.25, +0.25, +1] for codes 0..3
    mag = torch.where((c == 1) | (c == 2), 0.25, 1.0)
    sgn = torch.where(c >= 2, 1.0, -1.0)
    return sgn * mag * s


def tile_update(scores, v, valid, m_prev, l_prev, acc_prev):
    """One tile's streaming-softmax update of ``(m, l, acc)``.

    scores: (..., rows_q, T) raw scores; v: (..., T, Dv) dequantized
    values; valid: a mask broadcastable to ``scores``.  Masked columns get
    an explicit zero probability: in decode the masked region is the tail,
    and exp(NEG_INF - NEG_INF) = 1 there would survive to the output."""
    s = torch.where(valid, scores, NEG_INF)
    m_new = torch.maximum(m_prev, s.amax(-1, keepdim=True))
    p = torch.where(valid, torch.exp(s - m_new), 0.0)
    alpha = torch.exp(m_prev - m_new)
    l_new = alpha * l_prev + p.sum(-1, keepdim=True)
    acc_new = alpha * acc_prev + matmul(p, v)
    return m_new, l_new, acc_new


def _decode_tiles(q, tiles, n_tiles: int, tile: int, pos, *, kv_bits: int,
                  chunk: int, dh: int, dv: int):
    """The tile loop shared by the flat and paged decode versions.

    q: (B, KV, G, Dh); ``tiles(kk)`` -> contiguous (kc, ksc, vc, vsc) of
    shapes (B, KV, T, w), (B, KV, T // chunk); pos: (B,) int last valid
    row of each request.  Returns fp32 (acc, m, l)."""
    b, kv, g, _ = q.shape
    qf = q.float()
    px = pos.reshape(b, 1, 1, 1)
    col = torch.arange(tile, device=q.device)
    acc = torch.zeros((b, kv, g, dv), dtype=torch.float32, device=q.device)
    m = torch.full((b, kv, g, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, kv, g, 1), device=q.device)
    for kk in range(n_tiles):
        kc, ksc, vc, vsc = tiles(kk)
        k = dequant_kv(kc, ksc, kv_bits=kv_bits, chunk=chunk, d=dh)
        v = dequant_kv(vc, vsc, kv_bits=kv_bits, chunk=chunk, d=dv)
        scores = matmul(qf, k.transpose(-1, -2))        # (B, KV, G, T)
        valid = (kk * tile + col) <= px
        m, l, acc = tile_update(scores, v, valid, m, l, acc)
    return acc, m, l


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad the sequence axis (1) to ``rows``; padded rows are always
    position-masked."""
    if x.shape[1] >= rows:
        return x
    pad = x.new_zeros((x.shape[0], rows - x.shape[1]) + x.shape[2:])
    return torch.cat([x, pad], dim=1)


def flash_decode_ref(q, kq, ks, vq, vs, pos, *, kv_bits: int, chunk: int,
                     dh: int, dv: int, tile: int):
    """GQA flash decode over a flat quantized cache -> raw partials.

    q: (B, KV, G, Dh) fp32, attention scale folded in; kq/vq: (B, S, KV,
    Dh) int8 or (B, S, KV, ceil(D/16)) int32 words; ks/vs: (B, ceil(S /
    chunk), KV) bf16; pos: int, 0-d or (B,) — last valid row.  ``tile``
    must hold whole scale chunks; a ragged S is padded and masked.
    Returns fp32 ``(acc, m, l)``: (B, KV, G, Dv), (B, KV, G, 1) x 2."""
    b = q.shape[0]
    n_tiles = -(-kq.shape[1] // tile)
    rows_c = tile // chunk
    kq, vq = _pad_rows(kq, n_tiles * tile), _pad_rows(vq, n_tiles * tile)
    ks = _pad_rows(ks, n_tiles * rows_c)
    vs = _pad_rows(vs, n_tiles * rows_c)
    px = torch.as_tensor(pos, device=q.device).reshape(-1).expand(b)

    def tiles(kk):
        sl, sc = slice(kk * tile, (kk + 1) * tile), \
            slice(kk * rows_c, (kk + 1) * rows_c)
        return (kq[:, sl].transpose(1, 2).contiguous(),
                ks[:, sc].transpose(1, 2).contiguous(),
                vq[:, sl].transpose(1, 2).contiguous(),
                vs[:, sc].transpose(1, 2).contiguous())

    return _decode_tiles(q, tiles, n_tiles, tile, px, kv_bits=kv_bits,
                         chunk=chunk, dh=dh, dv=dv)


def paged_flash_decode_ref(tbl, pos, q, kq, ks, vq, vs, *, kv_bits: int,
                           chunk: int, dh: int, dv: int, page: int):
    """GQA flash decode over block-paged pools -> raw partials.

    tbl: (B, n_tiles) int page table (tile kk of request b is physical
    page ``tbl[b, kk]``); pos: (B,) int per-request last valid row;
    kq/vq: (n_pages, page, KV, w) code pools; ks/vs: (n_pages, page //
    chunk, KV) scale pools.  Pages are gathered codes to codes, one tile
    at a time.  Same return as :func:`flash_decode_ref`."""
    b = q.shape[0]
    px = torch.as_tensor(pos, device=q.device).reshape(b)

    def tiles(kk):
        pid = tbl[:, kk].long()
        return (kq[pid].transpose(1, 2).contiguous(),
                ks[pid].transpose(1, 2).contiguous(),
                vq[pid].transpose(1, 2).contiguous(),
                vs[pid].transpose(1, 2).contiguous())

    return _decode_tiles(q, tiles, tbl.shape[1], page, px, kv_bits=kv_bits,
                         chunk=chunk, dh=dh, dv=dv)


def paged_flash_extend_ref(tbl, q, k_new, v_new, kq, ks, vq, vs, *,
                           kv_bits: int, chunk: int, dh: int, dv: int,
                           page: int):
    """Chunked-prefill GQA attention: an L-token chunk attends to the
    quantized pages of its own request's earlier chunks (``tbl``:
    (n_past,) int, every page full since chunks are page-aligned) and then
    to its own fp keys and values under a causal mask.

    q: (1, L, H, Dh) unscaled; k_new/v_new: (1, L, KV, Dh|Dv).  The
    chunk's offset (n_past * page) shifts queries and keys alike and
    cancels from the mask, so it is not an argument.  Query row i of a KV
    head is chunk token i // G.  Returns (1, L, H, Dv) fp32, normalized."""
    _, L, h, _ = q.shape
    kv = k_new.shape[2]
    g = h // kv
    qf = (q.float() * dh ** -0.5)[0].reshape(L, kv, g, dh)
    qf = qf.permute(1, 0, 2, 3).reshape(kv, L * g, dh)      # rows = (l, g)
    kf = k_new[0].float().permute(1, 0, 2)                  # (KV, L, Dh)
    vf = v_new[0].float().permute(1, 0, 2)                  # (KV, L, Dv)
    acc = torch.zeros((kv, L * g, dv), dtype=torch.float32, device=q.device)
    m = torch.full((kv, L * g, 1), NEG_INF, device=q.device)
    l = torch.zeros((kv, L * g, 1), device=q.device)
    every = torch.ones((), dtype=torch.bool, device=q.device)
    for kk in range(tbl.shape[0]):
        pid = tbl[kk:kk + 1].long()  # a tensor index: no host sync
        k = dequant_kv(kq[pid][0].transpose(0, 1), ks[pid][0].transpose(0, 1),
                       kv_bits=kv_bits, chunk=chunk, d=dh)  # (KV, page, Dh)
        v = dequant_kv(vq[pid][0].transpose(0, 1), vs[pid][0].transpose(0, 1),
                       kv_bits=kv_bits, chunk=chunk, d=dv)
        scores = matmul(qf, k.transpose(-1, -2))            # (KV, L*g, page)
        m, l, acc = tile_update(scores, v, every, m, l, acc)
    row_tok = torch.arange(L * g, device=q.device) // g
    causal = row_tok[:, None] >= torch.arange(L, device=q.device)[None, :]
    scores = matmul(qf, kf.transpose(-1, -2))               # (KV, L*g, L)
    m, l, acc = tile_update(scores, vf, causal, m, l, acc)
    out = acc / torch.clamp_min(l, 1e-30)                   # (KV, L*g, Dv)
    out = out.reshape(kv, L, g, dv).permute(1, 0, 2, 3)     # (L, KV, g, Dv)
    return out.reshape(1, L, h, dv)


# ------------------------------------------------------------------- MLA
#
# MLA's absorbed decode is one-KV-head attention in latent space: scores
# ql·c + qr·r over the latent (c, dl wide) and shared rope (r, dr wide)
# rows, values the latents themselves (v = c).  The cache holds c and r
# as separate codes with their own scales: (B, S, w) codes and (B, S /
# chunk) scales, no head axis.


def _mla_decode_tiles(ql, qr, tiles, n_tiles: int, tile: int, pos, *,
                      kv_bits: int, chunk: int, dl: int, dr: int,
                      dtype=torch.float32):
    """The tile loop shared by the flat and paged MLA decode versions.

    ql: (B, H, dl), qr: (B, H, dr); ``tiles(kk)`` -> (cc, csc, rc, rsc) of
    shapes (B, T, wc), (B, T // chunk), (B, T, wr), (B, T // chunk);
    pos: (B,) int.  Returns ``dtype`` (acc (B, H, dl), m, l (B, H, 1))."""
    b, h, _ = ql.shape
    qlf, qrf = ql.to(dtype), qr.to(dtype)
    px = pos.reshape(b, 1, 1)
    col = torch.arange(tile, device=ql.device)
    acc = torch.zeros((b, h, dl), dtype=dtype, device=ql.device)
    m = torch.full((b, h, 1), NEG_INF, dtype=dtype, device=ql.device)
    l = torch.zeros((b, h, 1), dtype=dtype, device=ql.device)
    for kk in range(n_tiles):
        cc, csc, rc, rsc = tiles(kk)
        c = dequant_kv(cc, csc, kv_bits=kv_bits, chunk=chunk,
                       d=dl).to(dtype)
        r = dequant_kv(rc, rsc, kv_bits=kv_bits, chunk=chunk,
                       d=dr).to(dtype)
        scores = (matmul(qlf, c.transpose(-1, -2))
                  + matmul(qrf, r.transpose(-1, -2)))      # (B, H, T)
        valid = (kk * tile + col) <= px
        m, l, acc = tile_update(scores, c, valid, m, l, acc)
    return acc, m, l


def mla_flash_decode_ref(ql, qr, cq, cs, rq, rs, pos, *, kv_bits: int,
                         chunk: int, dl: int, dr: int, tile: int,
                         dtype=torch.float32):
    """MLA latent decode over a flat quantized cache -> raw partials.

    ql: (B, H, dl), qr: (B, H, dr) fp32 absorbed queries with the attention
    scale folded in; cq/rq: (B, S, w) codes (int8, or int32 words of 2-bit
    codes); cs/rs: (B, ceil(S / chunk)) bf16; pos: int, 0-d or (B,), the
    last valid row.  A ragged S is padded and masked.  Returns ``(acc, m,
    l)``: (B, H, dl), (B, H, 1) x 2, fp32 (the plain version), or float64
    for the same function on the same dequantized inputs with its own
    rounding out of the way."""
    b = ql.shape[0]
    n_tiles = -(-cq.shape[1] // tile)
    rows_c = tile // chunk
    cq, rq = _pad_rows(cq, n_tiles * tile), _pad_rows(rq, n_tiles * tile)
    cs, rs = _pad_rows(cs, n_tiles * rows_c), _pad_rows(rs, n_tiles * rows_c)
    px = torch.as_tensor(pos, device=ql.device).reshape(-1).expand(b)

    def tiles(kk):
        sl, sc = slice(kk * tile, (kk + 1) * tile), \
            slice(kk * rows_c, (kk + 1) * rows_c)
        return (cq[:, sl].contiguous(), cs[:, sc].contiguous(),
                rq[:, sl].contiguous(), rs[:, sc].contiguous())

    return _mla_decode_tiles(ql, qr, tiles, n_tiles, tile, px,
                             kv_bits=kv_bits, chunk=chunk, dl=dl, dr=dr,
                             dtype=dtype)


def paged_mla_flash_decode_ref(tbl, pos, ql, qr, cq, cs, rq, rs, *,
                               kv_bits: int, chunk: int, dl: int, dr: int,
                               page: int):
    """MLA latent decode over block-paged pools -> raw partials.

    tbl: (B, n_tiles) int page table; pos: (B,) int; cq/rq: (n_pages,
    page, w) code pools; cs/rs: (n_pages, page // chunk) scale pools.
    Pages are gathered codes to codes, one tile at a time; the same tile
    loop as :func:`mla_flash_decode_ref`, so at tile = page the two agree
    bitwise."""
    b = ql.shape[0]
    px = torch.as_tensor(pos, device=ql.device).reshape(b)

    def tiles(kk):
        pid = tbl[:, kk].long()
        return cq[pid], cs[pid], rq[pid], rs[pid]

    return _mla_decode_tiles(ql, qr, tiles, tbl.shape[1], page, px,
                             kv_bits=kv_bits, chunk=chunk, dl=dl, dr=dr)


def paged_mla_flash_extend_ref(tbl, ql, qr, c_new, r_new, cq, cs, rq, rs, *,
                               kv_bits: int, chunk: int, dl: int, dr: int,
                               page: int, dtype=torch.float32):
    """Chunked-prefill MLA latent attention: an L-token chunk's absorbed
    queries attend to the quantized latent pages of its request's earlier
    chunks (``tbl``: (n_past,) int, every page full) and then to the
    chunk's own fp latents under a causal mask.

    ql/qr: (L, H, dl|dr) fp32, scale folded in; c_new/r_new: (L, dl|dr)
    fp.  Query row i is chunk token i // H; the chunk's offset cancels from
    the mask, so it is not an argument.  Returns (L, H, dl) normalized, in
    ``dtype``: fp32 (the plain version), or float64 for the same function
    on the same dequantized inputs with its own rounding out of the way."""
    L, h, _ = ql.shape
    qlf = ql.to(dtype).reshape(L * h, dl)
    qrf = qr.to(dtype).reshape(L * h, dr)
    acc = torch.zeros((L * h, dl), dtype=dtype, device=ql.device)
    m = torch.full((L * h, 1), NEG_INF, dtype=dtype, device=ql.device)
    l = torch.zeros((L * h, 1), dtype=dtype, device=ql.device)
    every = torch.ones((), dtype=torch.bool, device=ql.device)
    for kk in range(tbl.shape[0]):
        pid = tbl[kk:kk + 1].long()  # a tensor index: no host sync
        c = dequant_kv(cq[pid][0], cs[pid][0], kv_bits=kv_bits, chunk=chunk,
                       d=dl).to(dtype)                       # (page, dl)
        r = dequant_kv(rq[pid][0], rs[pid][0], kv_bits=kv_bits, chunk=chunk,
                       d=dr).to(dtype)
        scores = matmul(qlf, c.T) + matmul(qrf, r.T)         # (L*H, page)
        m, l, acc = tile_update(scores, c, every, m, l, acc)
    cf, rf = c_new.to(dtype), r_new.to(dtype)
    row_tok = torch.arange(L * h, device=ql.device) // h
    causal = row_tok[:, None] >= torch.arange(L, device=ql.device)[None, :]
    scores = matmul(qlf, cf.T) + matmul(qrf, rf.T)           # (L*H, L)
    m, l, acc = tile_update(scores, cf, causal, m, l, acc)
    return (acc / torch.clamp_min(l, 1e-30)).reshape(L, h, dl)


# ----------------------------------------- the extend kernel's arithmetic
#
# ``fe_extend_kernel`` (csrc/flash_decode.cu) multiplies on the tensor cores
# in TF32 (10 explicit mantissa bits).  It keeps the fp32 result by feeding
# them exact operands (int8 codes, 2-bit levels, bf16 values) or fp32 values
# split into a TF32 hi and lo term, with every scale applied in fp32 after
# the product.  The emulation below repeats that operand handling on the
# CPU for the tests (``tests/test_torch_flash_precision.py``); nothing on the
# serving path calls it.


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value, ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds: add half of the 13 dropped bits to the
    magnitude, then clear them (finite inputs)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 x -> (hi, lo), both TF32, hi + lo within ~2^-22 of x."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def _tc_product(a_terms, b_terms) -> torch.Tensor:
    """Sum of the tensor-core products the kernel issues for operand terms
    (a_hi[, a_lo]) x (b_hi[, b_lo]): every pair but lo x lo."""
    out = None
    for i, a in enumerate(a_terms):
        for j, b in enumerate(b_terms):
            if i and j:
                continue
            y = a @ b
            out = y if out is None else out + y
    return out


def paged_flash_extend_emulated(tbl, q, k_new, v_new, kq, ks, vq, vs, *,
                                kv_bits: int, chunk: int, dh: int, dv: int,
                                page: int, split_p: bool = True,
                                keys: int = 32) -> torch.Tensor:
    """:func:`paged_flash_extend_ref`'s function computed the way the extend
    kernel computes it: ``keys``-key tiles (past keys, then the chunk's own
    under the causal mask), Q.K^T on the codes (scale 1) and on the query
    in its own dtype, fp32 queries and keys split into TF32 hi + lo;
    dh^-0.5 * log2(e) and each key's scale applied to the fp32 score; the
    softmax in the log2 domain; each past key's V scale folded into P, P
    split into TF32 hi + lo (only hi with ``split_p=False``) against exact
    V codes or bf16 values (fp32 values split again); each tile's product
    summed from zero and added as acc * alpha + tile.  Same arguments and
    return as :func:`paged_flash_extend_ref`."""
    _, L, h, _ = q.shape
    kv = k_new.shape[2]
    g = h // kv
    exact = all(x.dtype == torch.bfloat16 for x in (q, k_new, v_new))

    def terms(x):  # a value operand as the kernel feeds it
        return (x.float(),) if exact else tf32_split(x.float())

    n_past = tbl.shape[0]
    pid = tbl.long()

    def past(codes, scales, d):  # (KV, NP, d) codes as values, (KV, NP)
        if not n_past:
            return None, None
        c = codes[pid].reshape((n_past * page,) + codes.shape[2:])
        sc = scales[pid].reshape(n_past * page // chunk, kv).T
        ones = torch.ones_like(sc)
        x = dequant_kv(c.transpose(0, 1), ones, kv_bits=kv_bits,
                       chunk=chunk, d=d)
        return x, sc.float().repeat_interleave(chunk, dim=-1)

    kc, sk = past(kq, ks, dh)
    vc, sv = past(vq, vs, dv)
    qf = q[0].float().reshape(L, kv, g, dh).permute(1, 0, 2, 3)
    qf = qf.reshape(kv, L * g, dh)                          # rows = (l, g)
    kf = k_new[0].float().permute(1, 0, 2)                  # (KV, L, Dh)
    vf = v_new[0].float().permute(1, 0, 2)
    scale2 = (torch.tensor(dh ** -0.5, dtype=torch.float32)
              * torch.tensor(1.4426950408889634, dtype=torch.float32))
    row_tok = torch.arange(L * g) // g
    acc = torch.zeros((kv, L * g, dv))
    m = torch.full((kv, L * g, 1), NEG_INF)
    l = torch.zeros((kv, L * g, 1))
    n_past_keys = n_past * page
    tiles = [(j, True) for j in range(0, n_past_keys, keys)]
    tiles += [(j, False) for j in range(0, L, keys)]
    for j0, is_past in tiles:
        if is_past:
            sl = slice(j0, min(j0 + keys, n_past_keys))
            s = _tc_product(terms(qf), (kc[:, sl].transpose(1, 2),))
            s = s * scale2 * sk[:, None, sl]
            live = torch.ones(s.shape[-1], dtype=torch.bool)[None, None]
            v_terms, v_scale = (vc[:, sl],), sv[:, sl, None]
        else:
            sl = slice(j0, min(j0 + keys, L))
            kt = tuple(x.transpose(1, 2) for x in terms(kf[:, sl]))
            s = _tc_product(terms(qf), kt) * scale2
            live = (row_tok[:, None] >= torch.arange(sl.start,
                                                     sl.stop)[None, :])[None]
            v_terms, v_scale = terms(vf[:, sl]), None
        s = torch.where(live, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(live, torch.exp2(s - m_new), 0.0)
        alpha = torch.exp2(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        pv = p if v_scale is None else p * v_scale.transpose(1, 2)
        p_terms = tf32_split(pv) if split_p else (tf32_round(pv),)
        acc = acc * alpha + _tc_product(p_terms, v_terms)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)                   # (KV, L*g, Dv)
    out = out.reshape(kv, L, g, dv).permute(1, 0, 2, 3)
    return out.reshape(1, L, h, dv)


# ---------------------------- the MLA extend and decode kernel's arithmetic
#
# ``mla_attend_kernel`` (csrc/mla_decode.cu) multiplies on the tensor cores
# in bf16 with fp32 sums.  Its exact operands are the codes (int8, 2-bit
# levels); every fp32 operand (the queries, P, the chunk's own latents) is
# split into three bf16 terms, and a product takes the term pairs (i, j)
# with i + j < 3.  The emulation below repeats that operand handling on the
# CPU for the tests (``tests/test_torch_mla_precision.py``); nothing on the
# serving path calls it.

MLA_TERMS = 3  # bf16 terms of an fp32 operand in mla_attend_kernel
LOG2E = 1.4426950408889634


def bf16_split(x: torch.Tensor, terms: int = MLA_TERMS
               ) -> tuple[torch.Tensor, ...]:
    """fp32 x -> ``terms`` bf16 values (held in fp32): each the bf16 (round
    to nearest even, as ``__floats2bfloat162_rn``) of what the earlier ones
    leave; every remainder is exact in fp32, so three terms are within
    ~2^-24 of x."""
    out, r = [], x.float()
    for _ in range(terms):
        t = r.to(torch.bfloat16).float()
        out.append(t)
        r = r - t
    return tuple(out)


def _pair_product(a_terms, b_terms) -> torch.Tensor:
    """Sum of a_i @ b_j over the term pairs the kernel issues: i + j <
    MLA_TERMS (b exact: one term, every a_i)."""
    out = None
    for i, a in enumerate(a_terms):
        for j, b in enumerate(b_terms):
            if i + j < MLA_TERMS:
                y = a @ b
                out = y if out is None else out + y
    return out


def paged_mla_flash_extend_emulated(tbl, ql, qr, c_new, r_new, cq, cs, rq,
                                    rs, *, kv_bits: int, chunk: int, dl: int,
                                    dr: int, page: int,
                                    p_terms: int = MLA_TERMS,
                                    keys: int = 32) -> torch.Tensor:
    """:func:`paged_mla_flash_extend_ref`'s function computed the way the
    extend kernel computes it: ``keys``-key tiles (past keys, then the
    chunk's own under the causal mask); the queries split into three bf16
    terms against the exact codes (each key's c and r scale applied to the
    fp32 partial scores) or against the own latents' terms; exp(x - m) as
    exp2((x - m) log2(e)); each past key's value scale folded into
    P, P split into ``p_terms`` bf16 terms (three in the kernel); each
    tile's product summed from zero and added as acc * alpha + tile.  Same
    arguments and return as :func:`paged_mla_flash_extend_ref`."""
    L, h, _ = ql.shape
    rows = L * h
    q = torch.cat([ql.float().reshape(rows, dl), qr.float().reshape(rows, dr)],
                  -1)
    q_terms = bf16_split(q)
    log2e = torch.tensor(LOG2E, dtype=torch.float32)
    n_past = tbl.shape[0]
    np_keys = n_past * page
    if n_past:
        pid = tbl.long()

        def past(codes, scales, d):  # codes as values (scale 1), scales
            c = codes[pid].reshape((np_keys,) + codes.shape[2:])
            ones = torch.ones(np_keys // chunk, dtype=scales.dtype)
            vals = dequant_kv(c, ones, kv_bits=kv_bits, chunk=chunk, d=d)
            return vals, scales[pid].reshape(-1).float().repeat_interleave(
                chunk)

        cc, sc = past(cq, cs, dl)                         # (NP, dl), (NP,)
        rc, sr = past(rq, rs, dr)
    own = torch.cat([c_new.float(), r_new.float()], -1)   # (L, dl + dr)
    row_tok = torch.arange(rows) // h
    acc = torch.zeros((rows, dl))
    m = torch.full((rows, 1), NEG_INF)
    l = torch.zeros((rows, 1))
    tiles = [(j, True) for j in range(0, np_keys, keys)]
    tiles += [(j, False) for j in range(0, L, keys)]
    for j0, is_past in tiles:
        if is_past:
            sl = slice(j0, min(j0 + keys, np_keys))
            s_c = _pair_product(tuple(t[:, :dl] for t in q_terms),
                                (cc[sl].T,))
            s_r = _pair_product(tuple(t[:, dl:] for t in q_terms),
                                (rc[sl].T,))
            s = sc[sl] * s_c + sr[sl] * s_r
            live = torch.ones(s.shape[-1], dtype=torch.bool)[None]
            v_terms, v_scale = (cc[sl],), sc[sl]
        else:
            sl = slice(j0, min(j0 + keys, L))
            k_terms = bf16_split(own[sl])
            s = _pair_product(q_terms, tuple(t.T for t in k_terms))
            live = row_tok[:, None] >= torch.arange(sl.start, sl.stop)[None]
            v_terms, v_scale = tuple(t[:, :dl] for t in k_terms), None
        s = torch.where(live, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(live, torch.exp2((s - m_new) * log2e), 0.0)
        alpha = torch.exp2((m - m_new) * log2e)
        l = alpha * l + p.sum(-1, keepdim=True)
        pv = p if v_scale is None else p * v_scale[None]
        acc = acc * alpha + _pair_product(bf16_split(pv, p_terms), v_terms)
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).reshape(L, h, dl)


# The MLA decode (``mla_attend_kernel<true>``) takes the extend's past-tile
# arithmetic over each request's splits and merges the splits in order
# (``mla_merge_kernel``).

MLA_DECODE_SPLITS = 8  # DEC_SPLITS of csrc/mla_decode.cu


def mla_decode_splits(pos: int, max_key: int,
                      keys: int = 32) -> list[tuple[int, int]]:
    """A decode request's splits as the kernel cuts them (``dec_plan``):
    its keys 0 .. lim = min(pos, max_key) in runs of ceil(n / 8) whole
    ``keys``-key tiles for its n live tiles (one tile a run while n <= 8),
    as (first key, end key) pairs; with pos <= max_key a function of pos
    alone."""
    lim = min(pos, max_key)
    n = lim // keys + 1 if lim >= 0 else 0
    run = (-(-n // MLA_DECODE_SPLITS) if n > MLA_DECODE_SPLITS else 1) * keys
    return [(k, min(k + run, lim + 1)) for k in range(0, n * keys, run)]


def mla_flash_decode_emulated(ql, qr, cq, cs, rq, rs, pos, *, kv_bits: int,
                              chunk: int, dl: int, dr: int, tile: int,
                              p_terms: int = MLA_TERMS,
                              keys: int = 32) -> torch.Tensor:
    """:func:`mla_flash_decode_ref`'s function, normalized, computed the way
    the decode kernel computes it: each request's keys in the kernel's
    splits (:func:`mla_decode_splits`), each split walking ``keys``-key
    tiles with :func:`paged_mla_flash_extend_emulated`'s past-tile
    arithmetic (the queries in three bf16 terms against the exact codes,
    each key's c and r scale on the fp32 partial scores; exp2((x - m)
    log2(e)); each key's value scale folded into P, P split into
    ``p_terms`` bf16 terms against the exact codes; acc * alpha + tile),
    then its splits merged in order, each shifted to the largest max by
    exp2((m - max) log2(e)) and the sum normalized once.  Same arguments as
    :func:`mla_flash_decode_ref`; returns (B, H, dl) fp32."""
    b, h, _ = ql.shape
    s = cq.shape[1]
    log2e = torch.tensor(LOG2E, dtype=torch.float32)
    px = torch.as_tensor(pos).reshape(-1).expand(b)
    ones = torch.ones(s)
    out = torch.zeros((b, h, dl))
    for i in range(b):
        q_terms = bf16_split(torch.cat([ql[i].float(), qr[i].float()], -1))
        ql_t = tuple(t[:, :dl] for t in q_terms)
        qr_t = tuple(t[:, dl:] for t in q_terms)
        # codes as values (scale 1), and each row's scales
        cc = dequant_kv(cq[i], ones, kv_bits=kv_bits, chunk=1, d=dl)
        rc = dequant_kv(rq[i], ones, kv_bits=kv_bits, chunk=1, d=dr)
        sc, sr = (x[i].float().repeat_interleave(chunk)[:s] for x in (cs, rs))
        parts = []
        for k0, k1 in mla_decode_splits(int(px[i]), s - 1, keys):
            acc = torch.zeros((h, dl))
            m = torch.full((h, 1), NEG_INF)
            l = torch.zeros((h, 1))
            for j0 in range(k0, k1, keys):
                sl = slice(j0, min(j0 + keys, k1))
                x = (sc[sl] * _pair_product(ql_t, (cc[sl].T,))
                     + sr[sl] * _pair_product(qr_t, (rc[sl].T,)))
                m_new = torch.maximum(m, x.amax(-1, keepdim=True))
                p = torch.exp2((x - m_new) * log2e)
                alpha = torch.exp2((m - m_new) * log2e)
                l = alpha * l + p.sum(-1, keepdim=True)
                acc = acc * alpha + _pair_product(
                    bf16_split(p * sc[sl][None], p_terms), (cc[sl],))
                m = m_new
            parts.append((acc, m, l))
        if not parts:
            continue
        m_max = torch.stack([m for _, m, _ in parts]).amax(0)
        num, den = torch.zeros((h, dl)), torch.zeros((h, 1))
        for acc, m, l in parts:
            w = torch.exp2((m - m_max) * log2e)
            num = num + w * acc
            den = den + w * l
        out[i] = num / torch.clamp_min(den, 1e-30)
    return out
