"""The port's quantized-KV attention (plain versions, which the wrappers
take for CPU tensors) against the reference's Pallas kernels in interpret
mode, on the same codes: flat decode, paged decode through a shuffled page
table with a trash entry, and the chunked-prefill extend with and without
past pages.  Shapes include a ragged head dim (40: a partial 2-bit word),
partial trailing tiles and a one-token chunk.

Tolerance: 1e-5 of the largest output magnitude — fp32 throughout; the
port walks 64-row tiles where the reference walks up to 512, and sums the
same dequantized terms in another order.  The port's paged and flat decode
are compared with each other bitwise (tile = page).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.kernel import (flash_decode_pallas,
                                               paged_flash_decode_pallas,
                                               paged_flash_extend_pallas)
from repro.kernels.flash_decode.ops import _s_tile
from repro.models import attention as ref_att
from repro_torch.core.quantizer import words_from_numpy
from repro_torch.kernels.flash_decode.ops import (flash_decode,
                                                  paged_flash_decode,
                                                  paged_flash_extend)

RTOL = 1e-5


def _close(got, want):
    got = got.numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err < RTOL, err


def _to_torch(a):
    """Reference codes / scales -> the port's tensors, bit for bit."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return words_from_numpy(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _cache(seed, b, s, kv, d, kv_bits, chunk=64):
    """Random K/V encoded by the reference codec: jnp (kq, ks, vq, vs)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = jnp.asarray(rng.normal(size=(b, s, kv, d)), jnp.float32)
        out.extend(ref_att.kv_codec(kv_bits, chunk).encode(x))
    return out


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("b,s,kv,g,d,pos", [
    (2, 192, 2, 4, 16, 150), (2, 192, 2, 4, 16, 0), (1, 128, 2, 2, 40, 127),
    (2, 256, 1, 8, 128, 200)])
def test_flash_decode_matches_reference_kernel(kv_bits, b, s, kv, g, d, pos):
    chunk = 1 if kv_bits == 8 else 64
    kq, ks, vq, vs = _cache(0, b, s, kv, d, kv_bits)
    q = jnp.asarray(np.random.default_rng(1).normal(size=(b, kv, g, d)),
                    jnp.float32)
    acc, _, l = flash_decode_pallas(
        q, kq, ks, vq, vs, jnp.full((1, 1), pos, jnp.int32), kv_bits=kv_bits,
        chunk=chunk, dh=d, dv=d, s_blk=_s_tile(s, chunk), interpret=True)
    want = acc / jnp.maximum(l, 1e-30)
    got = flash_decode(_to_torch(q), *map(_to_torch, (kq, ks, vq, vs)), pos,
                       kv_bits=kv_bits, chunk=chunk, dv=d, tile=64)
    _close(got, want)


def test_flash_decode_ragged_length_masks_tail():
    """S = 100 (not a tile multiple) and a per-request position tensor:
    the port pads and masks; rows past pos never reach the output."""
    kq, ks, vq, vs = _cache(2, 2, 100, 2, 16, 8)
    q = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 2, 4, 16)).astype(np.float32))
    pos = torch.tensor([99, 40])
    got = flash_decode(q, *map(_to_torch, (kq, ks, vq, vs)), pos, kv_bits=8,
                       chunk=1, dv=16, tile=64)
    for i, p in enumerate((99, 40)):
        cut = [_to_torch(a)[i:i + 1, :p + 1] for a in (kq, ks, vq, vs)]
        alone = flash_decode(q[i:i + 1], *cut, p, kv_bits=8, chunk=1, dv=16,
                             tile=64)
        np.testing.assert_allclose(got[i:i + 1].numpy(), alone.numpy(),
                                   rtol=0, atol=1e-6)


def _pages(cache, tbl, page, chunk):
    """Scatter a flat (B, S, ...) cache into pools along ``tbl``."""
    kq, ks, vq, vs = cache
    b, n_tiles = tbl.shape
    n_pages = int(tbl.max()) + 1
    pools = []
    for codes, scales in ((kq, ks), (vq, vs)):
        cp = np.zeros((n_pages, page) + codes.shape[2:], np.asarray(codes).dtype)
        sp = np.zeros((n_pages, page // chunk) + scales.shape[2:], np.float32)
        cp[tbl.reshape(-1)] = np.asarray(codes).reshape((b * n_tiles, page)
                                                        + codes.shape[2:])
        sp[tbl.reshape(-1)] = np.asarray(scales, np.float32).reshape(
            (b * n_tiles, page // chunk) + scales.shape[2:])
        pools += [jnp.asarray(cp), jnp.asarray(sp).astype(jnp.bfloat16)]
    return pools


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("d", [16, 40])
def test_paged_flash_decode_matches_reference_and_flat(kv_bits, d):
    page, b, kv, g, s = 64, 3, 2, 4, 256
    chunk = 1 if kv_bits == 8 else 64
    cache = _cache(4, b, s, kv, d, kv_bits)
    n_tiles = s // page
    tbl = (np.random.default_rng(5).permutation(b * n_tiles) + 1).reshape(
        b, n_tiles).astype(np.int32)                    # page 0: trash
    pools = _pages(cache, tbl, page, chunk)
    # a trash entry past every position, with stale codes on the trash page
    tbl = np.concatenate([tbl, np.zeros((b, 1), np.int32)], 1)
    pools[0] = pools[0].at[0].set(pools[0][1])
    pos = np.array([70, 255, 0], np.int32)
    q = jnp.asarray(np.random.default_rng(6).normal(size=(b, kv, g, d)),
                    jnp.float32)
    acc, _, l = paged_flash_decode_pallas(
        jnp.asarray(tbl), jnp.asarray(pos)[:, None], q, *pools,
        kv_bits=kv_bits, chunk=chunk, dh=d, dv=d, page=page, interpret=True)
    want = acc / jnp.maximum(l, 1e-30)
    got = paged_flash_decode(torch.from_numpy(tbl), torch.from_numpy(pos),
                             _to_torch(q), *map(_to_torch, pools),
                             kv_bits=kv_bits, chunk=chunk, dv=d, page=page)
    _close(got, want)
    flat = flash_decode(_to_torch(q), *map(_to_torch, cache),
                        torch.from_numpy(pos), kv_bits=kv_bits, chunk=chunk,
                        dv=d, tile=page)
    assert torch.equal(got, flat)


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("n_past,L,d", [(0, 37, 16), (2, 64, 16),
                                        (3, 1, 40), (1, 70, 40)])
def test_paged_flash_extend_matches_reference_kernel(kv_bits, n_past, L, d):
    page, kv, h = 64, 2, 4
    chunk = 1 if kv_bits == 8 else 64
    n_pages = n_past + 2
    kq, ks, vq, vs = _cache(7, 1, n_pages * page, kv, d, kv_bits)
    pools = [kq.reshape((n_pages, page) + kq.shape[2:]),
             ks.reshape((n_pages, page // chunk) + ks.shape[2:]),
             vq.reshape((n_pages, page) + vq.shape[2:]),
             vs.reshape((n_pages, page // chunk) + vs.shape[2:])]
    tbl = (np.random.default_rng(8).permutation(n_pages - 1)[:n_past]
           + 1).astype(np.int32)
    rng = np.random.default_rng(9)
    q, k_new, v_new = (jnp.asarray(rng.normal(size=shape), jnp.float32)
                       for shape in ((1, L, h, d), (1, L, kv, d),
                                     (1, L, kv, d)))
    kw = dict(kv_bits=kv_bits, chunk=chunk, dh=d, dv=d, page=page)
    want = paged_flash_extend_pallas(jnp.asarray(tbl), q, k_new, v_new,
                                     *pools, n_past * page, interpret=True,
                                     **kw)
    got = paged_flash_extend(torch.from_numpy(tbl), _to_torch(q),
                             _to_torch(k_new), _to_torch(v_new),
                             *map(_to_torch, pools), **kw)
    _close(got, want)
