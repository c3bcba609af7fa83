"""Public wrappers: attention directly on a quantized KV cache.

``flash_decode`` (flat cache) and ``paged_flash_decode`` (block-paged
pools) attend one query token per request; ``paged_flash_extend`` attends
a prompt chunk to its request's quantized past pages plus its own fp keys.
``mla_flash_decode``, ``paged_mla_flash_decode`` and
``paged_mla_flash_extend`` are the same three for MLA's absorbed attention
over a latent cache (one KV head, scores on the latent and rope rows,
values the latents).
The cache stays codes + scales end to end: tiles are dequantized inside the
kernel (on the card) or one tile at a time (plain versions, ``ref``).

Dispatch is by the query's device and nothing else: a CPU tensor takes the
plain version; a CUDA tensor launches the kernel, for any S and any
position (ragged tails are masked), or raises.  Each wrapper counts its
launches in ``.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode.kernel import MAX_D, MAX_G, MLA_MAX_DL
from repro_torch.kernels.flash_decode.ref import (flash_decode_ref,
                                                  mla_flash_decode_ref,
                                                  paged_flash_decode_ref,
                                                  paged_flash_extend_ref,
                                                  paged_mla_flash_decode_ref,
                                                  paged_mla_flash_extend_ref)

TILE = 64  # flat-cache tile; the model passes its page size (= kv_chunk)


def _finalize(acc: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    return acc / torch.clamp_min(l, 1e-30)


def _code_cols(kv_bits: int, d: int) -> int:
    return d if kv_bits == 8 else -(-d // 16)


def _check_cache(name, kq, ks, vq, vs, *, kv_bits, dh, dv, device,
                 max_d=MAX_D):
    """Types, widths and contiguity the kernels take; raises otherwise."""
    code_dtype = torch.int8 if kv_bits == 8 else torch.int32
    if kv_bits not in (8, 2):
        raise ValueError(f"{name}: kv_bits must be 8 or 2, got {kv_bits}")
    for a, tag, d in ((kq, "k codes", dh), (vq, "v codes", dv)):
        if a.dtype != code_dtype or a.shape[-1] != _code_cols(kv_bits, d):
            raise TypeError(f"{name}: {tag} must be {code_dtype} with "
                            f"{_code_cols(kv_bits, d)} columns, got "
                            f"{a.dtype} {tuple(a.shape)}")
    for a, tag in ((ks, "k scales"), (vs, "v scales")):
        if a.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {tag} must be bfloat16, not {a.dtype}")
    for a in (kq, ks, vq, vs):
        if a.device != device or not a.is_contiguous():
            raise ValueError(f"{name}: the cache must be contiguous on "
                             f"{device}")
    if max(dh, dv) > max_d:
        raise ValueError(f"{name}: widths up to {max_d}, got {dh}/{dv}")


def _check_query(name, q, grouped: bool = True):
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    if grouped and (q.ndim != 4 or q.shape[2] > MAX_G):
        raise ValueError(f"{name}: q must be (B, KV, G <= {MAX_G}, Dh), got "
                         f"{tuple(q.shape)}")


def flash_decode(q, kq, ks, vq, vs, pos, *, kv_bits: int, chunk: int,
                 dv: int, tile: int = TILE) -> torch.Tensor:
    """Single-token GQA attention on a flat quantized cache.

    q: (B, KV, G, Dh) fp32 query groups with the attention scale folded in;
    kq/vq: (B, S, KV, w) codes (int8, or int32 words of 2-bit codes);
    ks/vs: (B, ceil(S / chunk), KV) bf16 scales; pos: int or a 0-d / (B,)
    int tensor, the last valid row.  ``tile`` (a multiple of ``chunk``)
    sets the tile walk; the model passes its page size so that this and
    :func:`paged_flash_decode` agree bitwise.  Returns (B, KV, G, Dv)
    fp32."""
    dh = q.shape[-1]
    if tile % chunk:
        raise ValueError(f"tile {tile} must hold whole scale chunks of "
                         f"{chunk}")
    if q.device.type == "cpu":
        acc, _, l = flash_decode_ref(q, kq, ks, vq, vs, pos, kv_bits=kv_bits,
                                     chunk=chunk, dh=dh, dv=dv, tile=tile)
        return _finalize(acc, l)
    _check_query("flash_decode", q)
    _check_cache("flash_decode", kq, ks, vq, vs, kv_bits=kv_bits, dh=dh,
                 dv=dv, device=q.device)
    b, s = kq.shape[0], kq.shape[1]
    if ks.shape[1] * chunk < s or kq.shape[0] != q.shape[0]:
        raise ValueError(f"flash_decode: {ks.shape[1]} scale rows of "
                         f"{chunk} do not cover {s} cache rows")
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=q.device, dtype=torch.int32).reshape(-1)
        if pos.numel() not in (1, b):
            raise ValueError(f"flash_decode: pos must hold 1 or {b} entries")
        pos = pos.expand(b).contiguous()
    else:  # a fill on the device: no host-to-device copy, no sync
        pos = torch.full((b,), int(pos), dtype=torch.int32, device=q.device)
    from repro_torch.kernels.flash_decode.kernel import flash_decode_cuda

    out = flash_decode_cuda(q.float().contiguous(), kq, ks, vq, vs, pos,
                            None, kv_bits=kv_bits, chunk=chunk, dv=dv,
                            tile=tile, n_tiles=-(-s // tile), seq_len=s)
    flash_decode.launches += 1
    return out


def paged_flash_decode(tbl, pos, q, kq, ks, vq, vs, *, kv_bits: int,
                       chunk: int, dv: int, page: int) -> torch.Tensor:
    """Single-token GQA attention over block-paged quantized pools.

    tbl: (B, n_tiles) int per-request page table (unused entries point at
    the trash page 0); pos: (B,) int per-request last valid position;
    q: (B, KV, G, Dh) fp32 scaled; kq/vq: (n_pages, page, KV, w) code
    pools; ks/vs: (n_pages, page // chunk, KV) scale pools.  Returns
    (B, KV, G, Dv) fp32, bitwise :func:`flash_decode` at ``tile = page``
    on the same codes."""
    dh = q.shape[-1]
    if page % chunk or kq.shape[1] != page:
        raise ValueError(f"pools of {kq.shape[1]}-row pages do not hold "
                         f"whole scale chunks of {chunk} at page {page}")
    if q.device.type == "cpu":
        acc, _, l = paged_flash_decode_ref(
            tbl, pos, q, kq, ks, vq, vs, kv_bits=kv_bits, chunk=chunk,
            dh=dh, dv=dv, page=page)
        return _finalize(acc, l)
    _check_query("paged_flash_decode", q)
    _check_cache("paged_flash_decode", kq, ks, vq, vs, kv_bits=kv_bits,
                 dh=dh, dv=dv, device=q.device)
    b = q.shape[0]
    if tbl.ndim != 2 or tbl.shape[0] != b or ks.shape[1] != page // chunk:
        raise ValueError(f"paged_flash_decode: tbl must be (B={b}, n_tiles) "
                         f"and scale pools (n_pages, {page // chunk}, KV)")
    tbl = tbl.to(device=q.device, dtype=torch.int32).contiguous()
    pos = torch.as_tensor(pos, device=q.device).to(torch.int32).reshape(b)
    from repro_torch.kernels.flash_decode.kernel import flash_decode_cuda

    out = flash_decode_cuda(q.float().contiguous(), kq, ks, vq, vs,
                            pos.contiguous(), tbl, kv_bits=kv_bits,
                            chunk=chunk, dv=dv, tile=page,
                            n_tiles=tbl.shape[1], seq_len=0)
    paged_flash_decode.launches += 1
    return out


def paged_flash_extend(tbl, q, k_new, v_new, kq, ks, vq, vs, *,
                       kv_bits: int, chunk: int, dh: int, dv: int,
                       page: int) -> torch.Tensor:
    """Chunked-prefill GQA attention over block-paged quantized pools.

    An L-token chunk attends to its own request's past pages (``tbl``:
    (n_past,) int, every page full: chunks are page-aligned, so the chunk
    starts at n_past * page) and then to its own fp keys and values,
    causally.
    q: (1, L, H, Dh) unscaled; k_new/v_new: (1, L, KV, Dh|Dv).  On the card
    they reach the kernel in their own dtype when all three are bf16, else
    as fp32.  Returns (1, L, H, Dv) fp32.  ``n_past = 0`` attends the chunk
    alone."""
    if page % chunk or kq.shape[1] != page:
        raise ValueError(f"pools of {kq.shape[1]}-row pages do not hold "
                         f"whole scale chunks of {chunk} at page {page}")
    if q.device.type == "cpu":
        return paged_flash_extend_ref(
            tbl, q, k_new, v_new, kq, ks, vq, vs, kv_bits=kv_bits,
            chunk=chunk, dh=dh, dv=dv, page=page)
    _, L, h, _ = q.shape
    kv = k_new.shape[2]
    if q.ndim != 4 or q.shape[0] != 1 or h % kv or h // kv > MAX_G \
            or k_new.shape[:2] != (1, L) or v_new.shape[:3] != (1, L, kv):
        raise ValueError(f"paged_flash_extend: q (1, L, H, Dh) and k/v "
                         f"(1, L, KV, D) expected, got {tuple(q.shape)}, "
                         f"{tuple(k_new.shape)}, {tuple(v_new.shape)}")
    _check_query("paged_flash_extend", q, grouped=False)
    _check_cache("paged_flash_extend", kq, ks, vq, vs, kv_bits=kv_bits,
                 dh=dh, dv=dv, device=q.device)
    # bf16 (the model's dtype) goes to the tensor cores as it is; any other
    # mix is widened to fp32, which the kernel splits into TF32 hi + lo
    xs = (q, k_new, v_new)
    if not all(x.dtype == torch.bfloat16 for x in xs):
        xs = tuple(x.float() for x in xs)
    q, k_new, v_new = (x.contiguous() for x in xs)
    tbl = tbl.to(device=q.device, dtype=torch.int32).reshape(-1).contiguous()
    from repro_torch.kernels.flash_decode.kernel import flash_extend_cuda

    out = flash_extend_cuda(q, k_new, v_new, kq, ks, vq, vs, tbl,
                            kv_bits=kv_bits, chunk=chunk, page=page)
    paged_flash_extend.launches += 1
    return out


# ------------------------------------------------------------------- MLA


def _check_mla(name, ql, qr, cq, cs, rq, rs, *, kv_bits, dl, dr):
    """What the MLA kernels take: fp32 queries (B|L, H, dl|dr) on the card
    and latent codes of the codec's widths; raises otherwise."""
    _check_query(name, ql, grouped=False)
    if ql.ndim != 3 or qr.shape[:2] != ql.shape[:2] or \
            ql.shape[-1] != dl or qr.shape[-1] != dr:
        raise ValueError(f"{name}: ql (·, H, {dl}) and qr (·, H, {dr}) "
                         f"expected, got {tuple(ql.shape)}, "
                         f"{tuple(qr.shape)}")
    _check_cache(name, cq, cs, rq, rs, kv_bits=kv_bits, dh=dl, dv=dr,
                 device=ql.device, max_d=MLA_MAX_DL)


def mla_flash_decode(ql, qr, cq, cs, rq, rs, pos, *, kv_bits: int,
                     chunk: int, dl: int, dr: int,
                     tile: int = TILE) -> torch.Tensor:
    """Single-token MLA latent attention on a flat quantized cache.

    ql: (B, H, dl), qr: (B, H, dr) fp32 absorbed queries with the attention
    scale folded in; cq/rq: (B, S, w) latent and rope codes; cs/rs: (B,
    ceil(S / chunk)) bf16 scales; pos: int or a 0-d / (B,) int tensor, the
    last valid row.  ``tile`` is the page size, so that this and
    :func:`paged_mla_flash_decode` agree bitwise.  Returns (B, H, dl) fp32
    normalized latent context."""
    if tile % chunk:
        raise ValueError(f"tile {tile} must hold whole scale chunks of "
                         f"{chunk}")
    if ql.device.type == "cpu":
        acc, _, l = mla_flash_decode_ref(ql, qr, cq, cs, rq, rs, pos,
                                         kv_bits=kv_bits, chunk=chunk, dl=dl,
                                         dr=dr, tile=tile)
        return _finalize(acc, l)
    _check_mla("mla_flash_decode", ql, qr, cq, cs, rq, rs, kv_bits=kv_bits,
               dl=dl, dr=dr)
    b, s = cq.shape[0], cq.shape[1]
    if b != ql.shape[0] or rq.shape[:2] != (b, s) or \
            cs.shape[1] * chunk < s or rs.shape != cs.shape:
        raise ValueError(f"mla_flash_decode: caches {tuple(cq.shape)} / "
                         f"{tuple(rq.shape)} with {cs.shape[1]} scale rows of "
                         f"{chunk} do not match B {ql.shape[0]}")
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=ql.device, dtype=torch.int32).reshape(-1)
        if pos.numel() not in (1, b):
            raise ValueError(f"mla_flash_decode: pos must hold 1 or {b} "
                             f"entries")
        pos = pos.expand(b).contiguous()
    else:
        pos = torch.full((b,), int(pos), dtype=torch.int32, device=ql.device)
    from repro_torch.kernels.flash_decode.kernel import mla_decode_cuda

    out = mla_decode_cuda(ql.float().contiguous(), qr.float().contiguous(),
                          cq, cs, rq, rs, pos, None, kv_bits=kv_bits,
                          chunk=chunk, tile=tile, n_tiles=-(-s // tile),
                          seq_len=s)
    mla_flash_decode.launches += 1
    return out


def paged_mla_flash_decode(tbl, pos, ql, qr, cq, cs, rq, rs, *,
                           kv_bits: int, chunk: int, dl: int, dr: int,
                           page: int) -> torch.Tensor:
    """Single-token MLA latent attention over block-paged latent pools.

    tbl: (B, n_tiles) int page table (unused entries point at the trash
    page 0); pos: (B,) int; ql/qr: (B, H, dl|dr) fp32 scaled; cq/rq:
    (n_pages, page, w) code pools; cs/rs: (n_pages, page // chunk) scale
    pools.  Returns (B, H, dl) fp32, bitwise :func:`mla_flash_decode` at
    ``tile = page`` on the same codes."""
    if page % chunk or cq.shape[1] != page:
        raise ValueError(f"pools of {cq.shape[1]}-row pages do not hold "
                         f"whole scale chunks of {chunk} at page {page}")
    if ql.device.type == "cpu":
        acc, _, l = paged_mla_flash_decode_ref(
            tbl, pos, ql, qr, cq, cs, rq, rs, kv_bits=kv_bits, chunk=chunk,
            dl=dl, dr=dr, page=page)
        return _finalize(acc, l)
    _check_mla("paged_mla_flash_decode", ql, qr, cq, cs, rq, rs,
               kv_bits=kv_bits, dl=dl, dr=dr)
    b = ql.shape[0]
    if tbl.ndim != 2 or tbl.shape[0] != b or cs.shape[1:] != \
            (page // chunk,) or rs.shape != cs.shape or \
            rq.shape[:2] != cq.shape[:2]:
        raise ValueError(f"paged_mla_flash_decode: tbl must be (B={b}, "
                         f"n_tiles) and scale pools (n_pages, "
                         f"{page // chunk})")
    tbl = tbl.to(device=ql.device, dtype=torch.int32).contiguous()
    pos = torch.as_tensor(pos, device=ql.device).to(torch.int32).reshape(b)
    from repro_torch.kernels.flash_decode.kernel import mla_decode_cuda

    out = mla_decode_cuda(ql.float().contiguous(), qr.float().contiguous(),
                          cq, cs, rq, rs, pos.contiguous(), tbl,
                          kv_bits=kv_bits, chunk=chunk, tile=page,
                          n_tiles=tbl.shape[1], seq_len=0)
    paged_mla_flash_decode.launches += 1
    return out


def paged_mla_flash_extend(tbl, ql, qr, c_new, r_new, cq, cs, rq, rs, *,
                           kv_bits: int, chunk: int, dl: int, dr: int,
                           page: int) -> torch.Tensor:
    """Chunked-prefill MLA latent attention over block-paged latent pools.

    An L-token chunk's absorbed queries (ql/qr: (L, H, dl|dr) fp32, scale
    folded in) attend to their request's past pages (``tbl``: (n_past,)
    int, every page full: the chunk starts at n_past * page) and then to
    the chunk's own fp latents c_new/r_new (L, dl|dr), causally.  Returns
    (L, H, dl) fp32 latent context.  ``n_past = 0`` attends the chunk
    alone."""
    if page % chunk or cq.shape[1] != page:
        raise ValueError(f"pools of {cq.shape[1]}-row pages do not hold "
                         f"whole scale chunks of {chunk} at page {page}")
    if ql.device.type == "cpu":
        return paged_mla_flash_extend_ref(
            tbl, ql, qr, c_new, r_new, cq, cs, rq, rs, kv_bits=kv_bits,
            chunk=chunk, dl=dl, dr=dr, page=page)
    _check_mla("paged_mla_flash_extend", ql, qr, cq, cs, rq, rs,
               kv_bits=kv_bits, dl=dl, dr=dr)
    L = ql.shape[0]
    if c_new.shape != (L, dl) or r_new.shape != (L, dr):
        raise ValueError(f"paged_mla_flash_extend: c_new ({L}, {dl}) and "
                         f"r_new ({L}, {dr}) expected, got "
                         f"{tuple(c_new.shape)}, {tuple(r_new.shape)}")
    tbl = tbl.to(device=ql.device, dtype=torch.int32).reshape(-1).contiguous()
    from repro_torch.kernels.flash_decode.kernel import mla_extend_cuda

    out = mla_extend_cuda(ql.float().contiguous(), qr.float().contiguous(),
                          c_new.float().contiguous(),
                          r_new.float().contiguous(), cq, cs, rq, rs, tbl,
                          kv_bits=kv_bits, chunk=chunk, page=page)
    paged_mla_flash_extend.launches += 1
    return out


flash_decode.launches = 0
paged_flash_decode.launches = 0
paged_flash_extend.launches = 0
mla_flash_decode.launches = 0
paged_mla_flash_decode.launches = 0
paged_mla_flash_extend.launches = 0
