"""The MLA extend and decode kernels' tensor-core arithmetic, emulated on
the CPU.

``mla_attend_kernel`` (``csrc/mla_decode.cu``) runs Q.K^T and P.V on the
tensor cores in bf16 with fp32 sums and is held to its fp32 plain version
at TOL_KV = 1e-5.  It keeps that by feeding exact operands (int8 codes,
2-bit levels), splitting every fp32 operand (the queries, P, the chunk's own
latents) into three bf16 terms and taking the term pairs (i, j) with
i + j < 3, and applying every scale in fp32 after the product.
``ref.bf16_split`` rounds as ``__floats2bfloat162_rn`` does and
``ref.paged_mla_flash_extend_emulated`` repeats the kernel's operand handling
tile by tile; here it is held within TOL_KV of ``paged_mla_flash_extend_ref``
for both codecs, with and without past pages, at deepseek-v3's H 128, dl
512, dr 64, and the same emulation with P left unsplit (one bf16 term) is
shown to miss TOL_KV, which is why the kernel splits it.  With queries at
x1 (unscaled unit normals: scores of tens, a peaked softmax) the fp32 plain
version is itself more than TOL_KV from the function's float64 value, so
there the kernel is held to the float64 value (``dtype=torch.float64``).
The decode takes the same arithmetic over each request's splits and merges
them in order: ``ref.mla_flash_decode_emulated`` is held to
``mla_flash_decode_ref`` likewise, at a long cache and at the engine's
four positions.  Inputs are drawn with numpy.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_decode.ref import (
    bf16_split, mla_decode_splits, mla_flash_decode_emulated,
    mla_flash_decode_ref, paged_mla_flash_extend_emulated,
    paged_mla_flash_extend_ref)
from repro_torch.models.attention import kv_codec

TOL_KV = 1e-5  # chip_smoke.py and tests/test_torch_cuda.py hold the kernel
H, DL, DR = 128, 512, 64  # deepseek-v3's heads, latent and rope widths


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def _inputs(seed, kv_bits, n_past, L, h=H, page=64, q_scale=None):
    """Random latent pages through the port's codec, a shuffled table of
    ``n_past`` of them, the chunk's scaled queries (unit normals times
    ``q_scale``, by default the model's (dl + dr)^-0.5) and its own
    latents."""
    rng = np.random.default_rng(seed)
    codec = kv_codec(kv_bits, page)
    n_pages = n_past + 1
    c, r = (torch.from_numpy(rng.normal(size=(1, n_pages * page, d))
                             .astype(np.float32)) for d in (DL, DR))
    cq, cs = codec.encode(c)
    rq, rs = codec.encode(r)
    pools = [cq.reshape(n_pages, page, -1), cs.reshape(n_pages, -1),
             rq.reshape(n_pages, page, -1), rs.reshape(n_pages, -1)]
    tbl = torch.from_numpy((rng.permutation(n_pages - 1)[:n_past] + 1)
                           .astype(np.int32))
    scale = (DL + DR) ** -0.5 if q_scale is None else q_scale
    ql, qr = (torch.from_numpy((rng.normal(size=(L, h, d)) * scale)
                               .astype(np.float32)) for d in (DL, DR))
    c_new, r_new = (torch.from_numpy(rng.normal(size=(L, d))
                                     .astype(np.float32)) for d in (DL, DR))
    kw = dict(kv_bits=kv_bits, chunk=codec.chunk, dl=DL, dr=DR, page=page)
    return (tbl, ql, qr, c_new, r_new, *pools), kw


def test_bf16_split_terms():
    """Three bf16 terms (round to nearest even) within 2^-24 of x, each a
    bf16 value; the exact operands (int8 codes, 2-bit levels) are their own
    first term."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=10000)
                         * 10.0 ** np.random.default_rng(1).integers(
                             -6, 6, size=10000)).float()
    terms = bf16_split(x)
    assert len(terms) == 3
    for t in terms:
        assert torch.equal(t.to(torch.bfloat16).float(), t)
    assert bool(((sum(terms) - x).abs() <= x.abs() * 2.0 ** -24).all())
    assert torch.equal(bf16_split(torch.tensor([1 + 2 ** -8]), 1)[0],
                       torch.tensor([1.0]))  # ties to even
    exact = torch.cat([torch.arange(-128, 128, dtype=torch.float32),
                       torch.tensor([-1.0, -0.25, 0.25, 1.0])])
    hi, mid, lo = bf16_split(exact)
    assert torch.equal(hi, exact)
    assert not bool(mid.any()) and not bool(lo.any())


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("n_past,L,page", [(0, 9, 64), (2, 37, 64),
                                           (1, 20, 128)])
def test_emulated_mla_extend_within_tol_kv(kv_bits, n_past, L, page):
    """Past pages (exact codes, scales after the product) and the chunk's
    own keys (both sides split), pages of 64 and 128 (kv2: one scale a
    page), at the model's query scale."""
    args, kw = _inputs(1, kv_bits, n_past, L, page=page)
    want = paged_mla_flash_extend_ref(*args, **kw)
    got = paged_mla_flash_extend_emulated(*args, **kw)
    assert got.shape == want.shape == (L, H, DL)
    assert _rel(got, want) < TOL_KV


@pytest.mark.parametrize("kv_bits", [8, 2])
def test_unsplit_p_misses_tol_kv(kv_bits):
    """P rounded once to bf16 (8 bits) moves the output by ~1e-3 of its
    largest magnitude; its three-term split stays within TOL_KV."""
    args, kw = _inputs(2, kv_bits, 2, 37)
    want = paged_mla_flash_extend_ref(*args, **kw)
    split = _rel(paged_mla_flash_extend_emulated(*args, **kw), want)
    unsplit = _rel(paged_mla_flash_extend_emulated(*args, p_terms=1, **kw),
                   want)
    assert unsplit > TOL_KV
    assert split < TOL_KV


@pytest.mark.parametrize("kv_bits", [8, 2])
def test_unit_queries_hold_to_float64(kv_bits):
    """Queries at x1: the fp32 plain version is more than TOL_KV from the
    float64 value of the same function on the same dequantized inputs,
    while the kernel's arithmetic stays within TOL_KV of it; so the on-card
    test holds the kernel to the float64 value there."""
    args, kw = _inputs(3, kv_bits, 2, 37, h=20, q_scale=1.0)
    exact = paged_mla_flash_extend_ref(*args, dtype=torch.float64, **kw)
    plain = paged_mla_flash_extend_ref(*args, **kw)
    assert exact.dtype == torch.float64
    assert _rel(plain, exact) > TOL_KV
    assert _rel(paged_mla_flash_extend_emulated(*args, **kw), exact) < TOL_KV


# ------------------------------------------------------------ the decode
#
# ``mla_attend_kernel<true>`` (``mla_flash_decode``,
# ``paged_mla_flash_decode``) takes the same arithmetic over each request's
# splits and merges them in order; ``ref.mla_flash_decode_emulated``
# repeats it split by split.

# (positions, S): a multi-split cache whose last page is partial (35 and
# 22 live 32-key tiles: 7 and 8 splits), and the engine's four slots over
# 9 pages
DECODE_CASES = {"long": ((1099, 700), 1100),
                "engine": ((575, 543, 512, 0), 576)}


def _decode_inputs(seed, kv_bits, positions, s, h=H, q_scale=None):
    """A flat latent cache of len(positions) requests and ``s`` rows
    through the port's codec, and scaled queries (unit normals times
    ``q_scale``, by default the model's (dl + dr)^-0.5)."""
    rng = np.random.default_rng(seed)
    codec = kv_codec(kv_bits, 64)
    b = len(positions)
    c, r = (torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32))
            for d in (DL, DR))
    cq, cs = codec.encode(c)
    rq, rs = codec.encode(r)
    scale = (DL + DR) ** -0.5 if q_scale is None else q_scale
    ql, qr = (torch.from_numpy((rng.normal(size=(b, h, d)) * scale)
                               .astype(np.float32)) for d in (DL, DR))
    pos = torch.tensor(positions, dtype=torch.int32)
    kw = dict(kv_bits=kv_bits, chunk=codec.chunk, dl=DL, dr=DR, tile=64)
    return (ql, qr, cq, cs, rq, rs, pos), kw


def _decode_ref(args, kw, dtype=torch.float32):
    acc, _, l = mla_flash_decode_ref(*args, dtype=dtype, **kw)
    return acc / torch.clamp_min(l, 1e-30)


@pytest.mark.parametrize("pos,s,want", [
    (8155, 8191, [(k, k + 1024) for k in range(0, 7168, 1024)]
     + [(7168, 8156)]),
    (575, 575, [(k, k + 96) for k in range(0, 480, 96)] + [(480, 576)]),
    (512, 575, [(k, k + 96) for k in range(0, 480, 96)] + [(480, 513)]),
    (255, 575, [(k, k + 32) for k in range(0, 256, 32)]),
    (0, 575, [(0, 1)]), (70, 63, [(0, 32), (32, 64)]), (-1, 575, [])])
def test_mla_decode_splits(pos, s, want):
    """At most 8 runs of whole 32-key tiles covering keys 0 .. min(pos,
    last key), one tile a run up to 8 live tiles; the same for any last key
    past pos (the batch's table width or cache length)."""
    got = mla_decode_splits(pos, s)
    assert got == want
    if pos <= s:
        assert mla_decode_splits(pos, s + 1000) == got


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_emulated_mla_decode_within_tol_kv(kv_bits, case):
    """The decode's splits and merge at deepseek-v3's widths, at the
    model's query scale: within TOL_KV of the plain version."""
    positions, s = DECODE_CASES[case]
    args, kw = _decode_inputs(4, kv_bits, positions, s)
    want = _decode_ref(args, kw)
    got = mla_flash_decode_emulated(*args, **kw)
    assert got.shape == want.shape == (len(positions), H, DL)
    assert _rel(got, want) < TOL_KV


@pytest.mark.parametrize("kv_bits", [8, 2])
def test_decode_unsplit_p_misses_tol_kv(kv_bits):
    """The decode's P rounded once to bf16 misses TOL_KV; its three-term
    split stays within it."""
    args, kw = _decode_inputs(5, kv_bits, *DECODE_CASES["long"])
    want = _decode_ref(args, kw)
    split = _rel(mla_flash_decode_emulated(*args, **kw), want)
    unsplit = _rel(mla_flash_decode_emulated(*args, p_terms=1, **kw), want)
    assert unsplit > TOL_KV
    assert split < TOL_KV


@pytest.mark.parametrize("kv_bits", [8, 2])
def test_decode_unit_queries_hold_to_float64(kv_bits):
    """Queries at x1 at the engine's shape: the fp32 plain decode is more
    than TOL_KV from the float64 value of the same function, the kernel's
    arithmetic within TOL_KV of it (the on-card x1 test's reference)."""
    args, kw = _decode_inputs(6, kv_bits, *DECODE_CASES["engine"],
                              q_scale=1.0)
    exact = _decode_ref(args, kw, dtype=torch.float64)
    assert exact.dtype == torch.float64
    assert _rel(_decode_ref(args, kw), exact) > TOL_KV
    assert _rel(mla_flash_decode_emulated(*args, **kw), exact) < TOL_KV
