"""ctypes launchers of the CUDA quantized-KV attention kernels
(``csrc/flash_decode.cu``: GQA; ``csrc/mla_decode.cu``: MLA's latent
attention).  Shapes, types and contiguity are checked by ``ops``; these
allocate the outputs and scratch and launch."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

MAX_G = 16  # query heads per KV head
MAX_D = 256  # head dim
MLA_MAX_DL = 512  # MLA latent width (four warps of 128 value columns)


def _decode_fn():
    fn = build.library("flash_decode").fd_decode_launch
    fn.argtypes = [build.P] * 11 + [build.I] * 12 + [build.P]
    fn.restype = build.I
    return fn


@functools.cache
def gqa_tiles_per_split() -> int:
    """Tiles one GQA decode block walks: ``SPLIT_TILES`` of
    ``csrc/flash_decode.cu``, its one owner (a fixed run whatever the cache
    length, so that paged == flat bitwise)."""
    fn = build.library("flash_decode").fd_split_tiles
    fn.argtypes = []
    fn.restype = build.I
    return fn()


def _extend_fn():
    fn = build.library("flash_decode").fe_extend_launch
    fn.argtypes = ([build.P] * 8 + [build.I, build.P] + [build.I] * 9
                   + [build.F, build.P])
    fn.restype = build.I
    return fn


def flash_decode_cuda(q, kq, ks, vq, vs, pos, tbl, *, kv_bits: int,
                      chunk: int, dv: int, tile: int, n_tiles: int,
                      seq_len: int) -> torch.Tensor:
    """(B, KV, G, Dv) fp32 normalized attention on the card.  ``pos``: a
    (B,) int32 tensor, each request's last valid row; ``tbl`` an int32 (B,
    n_tiles) page table, or None for a flat cache of ``seq_len`` rows."""
    b, kv, g, dh = q.shape
    n_split = -(-n_tiles // gqa_tiles_per_split())
    f32 = dict(dtype=torch.float32, device=q.device)
    part_acc = torch.empty((b, kv, n_split, g, dv), **f32)
    part_m = torch.empty((b, kv, n_split, g), **f32)
    part_l = torch.empty((b, kv, n_split, g), **f32)
    out = torch.empty((b, kv, g, dv), **f32)
    err = _decode_fn()(
        q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
        vs.data_ptr(), pos.data_ptr(),
        None if tbl is None else tbl.data_ptr(), part_acc.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), out.data_ptr(), b, kv, g, dh,
        dv, seq_len, ks.shape[1], n_tiles, tile, chunk, kv_bits, n_split,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_decode")
    return out


def flash_extend_cuda(q, k_new, v_new, kq, ks, vq, vs, tbl, *, kv_bits: int,
                      chunk: int, page: int) -> torch.Tensor:
    """(1, L, H, Dv) fp32 normalized chunk attention on the card.  q: (1, L,
    H, Dh) unscaled; k_new/v_new: (1, L, KV, Dh|Dv); all three contiguous,
    all bf16 (exact on the tensor cores) or all fp32 (split into TF32 hi
    and lo terms); tbl: (n_past,) int32."""
    _, L, h, dh = q.shape
    kv, dv = k_new.shape[2], v_new.shape[-1]
    out = torch.empty((1, L, h, dv), dtype=torch.float32, device=q.device)
    n_past = tbl.shape[0]
    err = _extend_fn()(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), kq.data_ptr(),
        ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
        tbl.data_ptr() if n_past else None, n_past, out.data_ptr(), kv,
        h // kv, L, dh, dv, page, chunk, kv_bits,
        int(q.dtype == torch.float32), dh ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_flash_extend")
    return out


def _mla_decode_fn():
    fn = build.library("mla_decode").mla_decode_launch
    fn.argtypes = [build.P] * 12 + [build.I] * 12 + [build.P]
    fn.restype = build.I
    return fn


def _mla_decode_scratch_fn():
    fn = build.library("mla_decode").mla_decode_scratch
    fn.argtypes = [build.I] * 4 + [ctypes.c_longlong] + [build.P] * 2
    fn.restype = build.I
    return fn


def _mla_scratch_fn():
    fn = build.library("mla_decode").mla_extend_scratch
    fn.argtypes = [build.I] * 3 + [build.P] * 2
    fn.restype = build.I
    return fn


def _mla_extend_fn():
    fn = build.library("mla_decode").mla_extend_launch
    fn.argtypes = ([build.P] * 11 + [build.I, build.P] + [build.I] * 9
                   + [build.P])
    fn.restype = build.I
    return fn


def mla_decode_cuda(ql, qr, cq, cs, rq, rs, pos, tbl, *, kv_bits: int,
                    chunk: int, tile: int, n_tiles: int,
                    seq_len: int) -> torch.Tensor:
    """(B, H, dl) fp32 normalized MLA latent attention on the card.  ``pos``
    a (B,) int32 tensor; ``tbl`` an int32 (B, n_tiles) page table, or None
    for a flat cache of ``seq_len`` rows."""
    b, h, dl = ql.shape
    dr = qr.shape[-1]
    # the split rows' scratch, of the sizes the library gives (it plans the
    # splits: mla_decode_scratch lays them out)
    n_acc, n_ml = ctypes.c_longlong(), ctypes.c_longlong()
    keys = seq_len if tbl is None else n_tiles * tile  # a request's rows
    if _mla_decode_scratch_fn()(b, h, dl, dr, keys, ctypes.byref(n_acc),
                                ctypes.byref(n_ml)):
        raise ValueError(f"mla_flash_decode: latent width {dl} and rope "
                         f"width {dr} are wider than the decode kernel "
                         f"takes")
    f32 = dict(dtype=torch.float32, device=ql.device)
    part_acc = torch.empty(n_acc.value, **f32)
    part_m = torch.empty(n_ml.value, **f32)
    part_l = torch.empty(n_ml.value, **f32)
    out = torch.empty((b, h, dl), **f32)
    err = _mla_decode_fn()(
        ql.data_ptr(), qr.data_ptr(), cq.data_ptr(), cs.data_ptr(),
        rq.data_ptr(), rs.data_ptr(), pos.data_ptr(),
        None if tbl is None else tbl.data_ptr(), part_acc.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), out.data_ptr(), b, h, dl, dr,
        seq_len, cs.shape[1], n_tiles, tile, chunk, kv_bits, cq.shape[-1],
        rq.shape[-1], torch.cuda.current_stream(ql.device).cuda_stream)
    build.check(err, "mla_flash_decode")
    return out


def mla_extend_cuda(ql, qr, c_new, r_new, cq, cs, rq, rs, tbl, *,
                    kv_bits: int, chunk: int, page: int) -> torch.Tensor:
    """(L, H, dl) fp32 normalized chunk attention on the card.  ql/qr: (L,
    H, dl|dr) fp32 scaled; c_new/r_new: (L, dl|dr) fp32; tbl: (n_past,)
    int32."""
    L, h, dl = ql.shape
    dr = qr.shape[-1]
    # scratch for the chunk's own latents' bf16 terms and a flag for each
    # key tile whose second / third terms are not all zero, of the sizes
    # the library gives (mla_extend_scratch lays them out)
    n_own, n_nz = ctypes.c_longlong(), ctypes.c_longlong()
    if _mla_scratch_fn()(L, dl, dr, ctypes.byref(n_own), ctypes.byref(n_nz)):
        raise ValueError(f"paged_mla_flash_extend: latent width {dl} and "
                         f"rope width {dr} are wider than the extend kernel "
                         f"takes")
    out = torch.empty((L, h, dl), dtype=torch.float32, device=ql.device)
    own = torch.empty(n_own.value, dtype=torch.bfloat16, device=ql.device)
    own_nz = torch.zeros(n_nz.value, dtype=torch.int32, device=ql.device)
    n_past = tbl.shape[0]
    err = _mla_extend_fn()(
        ql.data_ptr(), qr.data_ptr(), c_new.data_ptr(), r_new.data_ptr(),
        own.data_ptr(), own_nz.data_ptr(), cq.data_ptr(), cs.data_ptr(),
        rq.data_ptr(), rs.data_ptr(),
        tbl.data_ptr() if n_past else None, n_past, out.data_ptr(), h, L, dl,
        dr, page, chunk, kv_bits, cq.shape[-1], rq.shape[-1],
        torch.cuda.current_stream(ql.device).cuda_stream)
    build.check(err, "paged_mla_flash_extend")
    return out
