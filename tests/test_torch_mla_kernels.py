"""The port's MLA kernels' plain versions (what a CPU tensor runs) against
the reference: ``quant_matmul_t`` and the head-batched ``quant_matmul`` on
``mla_latent_weights`` views, the latent flash decode (flat and paged) and
the chunked-prefill extend against the reference's Pallas kernels in
interpret mode, and the latent cache's codec appends.

Tolerances:
  * products and attention: 1e-5 of the largest output magnitude — fp32
    throughout, the same dequantized terms summed in another order (the
    port walks 64-row tiles where the reference walks up to 512);
  * the decode partials (acc, m, l) at the same 64-row tiles: 1e-5 of
    each one's largest magnitude;
  * ``mla_latent_weights`` views, the codec appends and the paged vs flat
    decode: bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantizer import QuantSpec as RefSpec
from repro.core.quantizer import pack_codes as ref_pack
from repro.core.quantizer import quantize_weight_rtn as ref_rtn
from repro.kernels.flash_decode.kernel import (mla_flash_decode_pallas,
                                               paged_mla_flash_decode_pallas,
                                               paged_mla_flash_extend_pallas)
from repro.kernels.quant_matmul import ops as ref_qmm_ops
from repro.kernels.quant_matmul.kernel import quant_matmul_t_pallas
from repro.kernels.quant_matmul.ref import quant_matmul_t_ref as ref_qmm_t
from repro.models import attention as ref_att
from repro_torch.core.quantizer import words_from_numpy, words_to_numpy
from repro_torch.kernels.flash_decode.ops import (mla_flash_decode,
                                                  paged_mla_flash_decode,
                                                  paged_mla_flash_extend)
from repro_torch.kernels.flash_decode.ref import mla_flash_decode_ref
from repro_torch.kernels.quant_matmul.ops import (PackedWeight,
                                                  mla_latent_weights,
                                                  quant_matmul,
                                                  quant_matmul_t)
from repro_torch.models import attention as att

RTOL = 1e-5


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return words_from_numpy(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL):
    got = (got.numpy() if isinstance(got, torch.Tensor) else
           np.asarray(got)).astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err < rtol, err


def _packed(bits, k, n, gs, seed):
    """A packed (k, n) weight from the reference's RTN: (port
    PackedWeight, reference (words, scale, zero))."""
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32)
    _, q, s, z = ref_rtn(jnp.asarray(w), RefSpec(bits, gs))
    words = np.asarray(ref_pack(q, bits))
    pw = PackedWeight(w_packed=words_from_numpy(words), scale=_t(s),
                      zero=_t(z), bits=bits, group_size=gs, d_in=k)
    return pw, (jnp.asarray(words), s, z)


# ------------------------------------------------------ quant_matmul_t (row 4)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quant_matmul_t_plain_vs_pallas(bits):
    """y = x @ dequant(W)ᵀ against the reference's interpret-mode kernel:
    x (8, 128), W packed (256, 128), group 128."""
    m, d, k, gs = 8, 128, 256, 128
    pw, (words, s, z) = _packed(bits, k, d, gs, seed=bits)
    x = np.random.default_rng(1).standard_normal((m, d)).astype(np.float32)
    want = quant_matmul_t_pallas(jnp.asarray(x), words, s, z, bits=bits,
                                 group_size=gs, m_blk=8, k_blk=128,
                                 d_blk=128, interpret=True)
    _close(quant_matmul_t(_t(x), pw), want)


@pytest.mark.parametrize("k,gs", [(512, 128), (130, 130)])
def test_quant_matmul_t_plain_vs_reference_3bit(k, gs):
    """3 bits: ragged words (10 codes each; 512 rows -> 52 words, the last
    holding 2) whose rows straddle quant groups.  The reference's kernel
    does not take 3 bits; its oracle does."""
    m, d = 4, 128
    pw, (words, s, z) = _packed(3, k, d, gs, seed=3)
    x = np.random.default_rng(2).standard_normal((m, d)).astype(np.float32)
    want = ref_qmm_t(jnp.asarray(x), words, s, z, bits=3, group_size=gs,
                     d_in=k)
    _close(quant_matmul_t(_t(x), pw), want)


@pytest.mark.parametrize("bits", [3, 4])
def test_mla_latent_weights_views_bitwise(bits):
    """The per-head views of a packed wkv_b are the reference's, bit for
    bit, and are views of the parent (nothing copied)."""
    h, dn, dv, kvr, gs = 4, 16, 24, 256, 128
    pw, (words, s, z) = _packed(bits, kvr, h * (dn + dv), gs, seed=5)
    ref_pw = ref_qmm_ops.PackedWeight(w_packed=words, scale=s, zero=z,
                                      bits=bits, group_size=gs, d_in=kvr)
    ref_k, ref_v = ref_qmm_ops.mla_latent_weights(ref_pw, h, dn, dv)
    pw_k, pw_v = mla_latent_weights(pw, h, dn, dv)
    for got, want in ((pw_k, ref_k), (pw_v, ref_v)):
        np.testing.assert_array_equal(words_to_numpy(got.w_packed),
                                      np.asarray(want.w_packed))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))
        np.testing.assert_array_equal(got.zero.numpy(), np.asarray(want.zero))
        assert got.w_packed.data_ptr() >= pw.w_packed.data_ptr()
        assert got.w_packed.untyped_storage().data_ptr() == \
            pw.w_packed.untyped_storage().data_ptr()


@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("m", [1, 5])
def test_head_batched_absorb_and_expand_vs_per_head(bits, m):
    """One call for all heads (absorb: quant_matmul_t; expand:
    quant_matmul) equals each head's own call through the reference's
    oracles, on the views of one packed wkv_b."""
    h, dn, dv, kvr, gs = 4, 16, 24, 256, 128
    pw, (words, s, z) = _packed(bits, kvr, h * (dn + dv), gs, seed=6)
    ref_pw = ref_qmm_ops.PackedWeight(w_packed=words, scale=s, zero=z,
                                      bits=bits, group_size=gs, d_in=kvr)
    ref_k, ref_v = ref_qmm_ops.mla_latent_weights(ref_pw, h, dn, dv)
    pw_k, pw_v = mla_latent_weights(pw, h, dn, dv)
    rng = np.random.default_rng(7)
    qn = rng.standard_normal((h, m, dn)).astype(np.float32)
    cl = rng.standard_normal((h, m, kvr)).astype(np.float32)
    lat = quant_matmul_t(_t(qn), pw_k)
    ctx = quant_matmul(_t(cl), pw_v)
    assert lat.shape == (h, m, kvr) and ctx.shape == (h, m, dv)
    for i in range(h):
        _close(lat[i], ref_qmm_t(jnp.asarray(qn[i]), ref_k.w_packed[i],
                                 ref_k.scale[i], ref_k.zero[i], bits=bits,
                                 group_size=gs, d_in=kvr))
        _close(ctx[i], ref_qmm_ops.quant_matmul(
            jnp.asarray(cl[i]), ref_qmm_ops.PackedWeight(
                w_packed=ref_v.w_packed[i], scale=ref_v.scale[i],
                zero=ref_v.zero[i], bits=bits, group_size=gs, d_in=kvr),
            use_kernel=False))


def test_head_batched_operands_must_match():
    pw, _ = _packed(4, 128, 2 * 32, 128, seed=8)
    pw_k, _ = mla_latent_weights(pw, 2, 16, 16)
    with pytest.raises(ValueError, match="does not match"):
        quant_matmul_t(torch.zeros((3, 1, 16)), pw_k)
    with pytest.raises(ValueError, match="does not match"):
        quant_matmul_t(torch.zeros((1, 16)), pw_k)


# ------------------------------------------------ latent flash decode (8-10)


def _latent(seed, b, s, d, kv_bits, chunk=64):
    """Random latent rows encoded by the reference codec."""
    x = np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)
    return ref_att.kv_codec(kv_bits, chunk).encode(jnp.asarray(x))


def _chunk(kv_bits):
    return 1 if kv_bits == 8 else 64


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("pos", [0, 100, 191])
def test_mla_flash_decode_partials_vs_pallas(kv_bits, pos):
    """Raw fp32 partials (acc, m, l) at the same 64-row tiles, and the
    normalized output, against the reference kernel; latent width 40 (a
    partial 2-bit word), rope 8."""
    b, s, h, dl, dr = 2, 192, 4, 40, 8
    chunk = _chunk(kv_bits)
    cq, cs = _latent(0, b, s, dl, kv_bits)
    rq, rs = _latent(1, b, s, dr, kv_bits)
    rng = np.random.default_rng(2)
    ql = jnp.asarray(rng.normal(size=(b, h, dl)), jnp.float32)
    qr = jnp.asarray(rng.normal(size=(b, h, dr)), jnp.float32)
    kw = dict(kv_bits=kv_bits, chunk=chunk, dl=dl, dr=dr)
    want = mla_flash_decode_pallas(ql, qr, cq, cs, rq, rs,
                                   jnp.full((1, 1), pos, jnp.int32),
                                   s_blk=64, interpret=True, **kw)
    port = [_t(a) for a in (ql, qr, cq, cs, rq, rs)]
    got = mla_flash_decode_ref(*port, pos, tile=64, **kw)
    for g, w in zip(got, want):
        _close(g, w)
    out = mla_flash_decode(*port, pos, tile=64, **kw)
    _close(out, want[0] / jnp.maximum(want[2], 1e-30))


def _pools(codes, scales, tbl, page, chunk):
    """Scatter a flat (B, S, w) latent cache into pools along ``tbl``."""
    b, n_tiles = tbl.shape
    n_pages = int(tbl.max()) + 1
    codes, scales = np.asarray(codes), np.asarray(scales, np.float32)
    cp = np.zeros((n_pages, page) + codes.shape[2:], codes.dtype)
    sp = np.zeros((n_pages, page // chunk), np.float32)
    cp[tbl.reshape(-1)] = codes.reshape((b * n_tiles, page) + codes.shape[2:])
    sp[tbl.reshape(-1)] = scales.reshape(b * n_tiles, page // chunk)
    return jnp.asarray(cp), jnp.asarray(sp).astype(jnp.bfloat16)


@pytest.mark.parametrize("kv_bits", [8, 2])
def test_paged_mla_flash_decode_vs_pallas_and_flat(kv_bits):
    """A shuffled page table with a trash entry past every position and
    stale codes on the trash page: against the reference's paged kernel,
    and bitwise the port's flat decode at tile = page."""
    page, b, h, dl, dr, s = 64, 3, 4, 32, 16, 256
    chunk = _chunk(kv_bits)
    cq, cs = _latent(3, b, s, dl, kv_bits)
    rq, rs = _latent(4, b, s, dr, kv_bits)
    n_tiles = s // page
    tbl = (np.random.default_rng(5).permutation(b * n_tiles) + 1).reshape(
        b, n_tiles).astype(np.int32)
    cqp, csp = _pools(cq, cs, tbl, page, chunk)
    rqp, rsp = _pools(rq, rs, tbl, page, chunk)
    cqp = cqp.at[0].set(cqp[1])
    tbl = np.concatenate([tbl, np.zeros((b, 1), np.int32)], 1)
    pos = np.array([70, 255, 0], np.int32)
    rng = np.random.default_rng(6)
    ql = jnp.asarray(rng.normal(size=(b, h, dl)), jnp.float32)
    qr = jnp.asarray(rng.normal(size=(b, h, dr)), jnp.float32)
    kw = dict(kv_bits=kv_bits, chunk=chunk, dl=dl, dr=dr)
    acc, _, l = paged_mla_flash_decode_pallas(
        jnp.asarray(tbl), jnp.asarray(pos)[:, None], ql, qr, cqp, csp, rqp,
        rsp, page=page, interpret=True, **kw)
    got = paged_mla_flash_decode(torch.from_numpy(tbl), torch.from_numpy(pos),
                                 *map(_t, (ql, qr, cqp, csp, rqp, rsp)),
                                 page=page, **kw)
    _close(got, acc / jnp.maximum(l, 1e-30))
    flat = mla_flash_decode(*map(_t, (ql, qr, cq, cs, rq, rs)),
                            torch.from_numpy(pos), tile=page, **kw)
    assert torch.equal(got, flat)


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("n_past,L", [(0, 17), (2, 30), (1, 64)])
def test_paged_mla_flash_extend_vs_pallas(kv_bits, n_past, L):
    """An L-token chunk (partial or a whole page) over n_past shuffled past
    pages, against the reference's extend kernel."""
    page, h, dl, dr = 64, 4, 32, 16
    chunk = _chunk(kv_bits)
    n_pages = n_past + 2
    cq, cs = _latent(7, 1, n_pages * page, dl, kv_bits)
    rq, rs = _latent(8, 1, n_pages * page, dr, kv_bits)
    pools = [cq.reshape((n_pages, page) + cq.shape[2:]),
             cs.reshape(n_pages, page // chunk),
             rq.reshape((n_pages, page) + rq.shape[2:]),
             rs.reshape(n_pages, page // chunk)]
    tbl = (np.random.default_rng(9).permutation(n_pages - 1)[:n_past]
           + 1).astype(np.int32)
    rng = np.random.default_rng(10)
    ql, qr = (jnp.asarray(rng.normal(size=(L, h, d)), jnp.float32)
              for d in (dl, dr))
    c_new, r_new = (jnp.asarray(rng.normal(size=(L, d)), jnp.float32)
                    for d in (dl, dr))
    kw = dict(kv_bits=kv_bits, chunk=chunk, dl=dl, dr=dr, page=page)
    want = paged_mla_flash_extend_pallas(jnp.asarray(tbl), ql, qr, c_new,
                                         r_new, *pools, n_past * page,
                                         interpret=True, **kw)
    got = paged_mla_flash_extend(torch.from_numpy(tbl),
                                 *map(_t, (ql, qr, c_new, r_new)),
                                 *map(_t, pools), **kw)
    _close(got, want)


# ------------------------------------------------------ latent codec appends


def _x(seed, *shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * rng.exponential(size=shape[:-1] + (1,))
            ).astype(np.float32)


def _same(got, want):
    want = np.asarray(want)
    if want.dtype == np.uint32:
        np.testing.assert_array_equal(words_to_numpy(got), want)
    elif want.dtype.name == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kv_bits", [8, 2])
@pytest.mark.parametrize("d", [512, 40])
def test_latent_flat_append_bitwise(kv_bits, d):
    """Latent rows (B, T, d) with no head axis: prefill 120 rows, then
    append 16 tokens one at a time across the chunk boundary at 128."""
    x = _x(11, 2, 136, d)
    codec_r, codec_p = ref_att.kv_codec(kv_bits, 64), att.kv_codec(kv_bits, 64)
    c_r, s_r = codec_r.encode(jnp.asarray(x[:, :120]))
    c_p, s_p = codec_p.encode(torch.from_numpy(x[:, :120]))
    _same(c_p, c_r)
    _same(s_p, s_r)
    rows, srows = 192, codec_p.scale_rows(192)
    c_r = jnp.concatenate([c_r, jnp.zeros((2, rows - 120) + c_r.shape[2:],
                                          c_r.dtype)], 1)
    s_r = jnp.concatenate([s_r, jnp.zeros((2, srows - s_r.shape[1]),
                                          s_r.dtype)], 1)
    c_p = torch.cat([c_p, c_p.new_zeros((2, rows - 120) + c_p.shape[2:])], 1)
    s_p = torch.cat([s_p, s_p.new_zeros((2, srows - s_p.shape[1]))], 1)
    for t in range(120, 136):
        c_r, s_r = codec_r.append(c_r, s_r, jnp.asarray(x[:, t:t + 1]),
                                  jnp.int32(t))
        codec_p.append(c_p, s_p, torch.from_numpy(x[:, t:t + 1]), t)
    _same(c_p, c_r)
    _same(s_p, s_r)


@pytest.mark.parametrize("kv_bits", [8, 2])
def test_latent_paged_append_bitwise(kv_bits):
    """One latent row per slot into (n_pages, page, w) pools: slot 2 at a
    chunk leader, slot 1 inactive (written to the trash page)."""
    page, n_pages, d = 64, 6, 40
    codec_r, codec_p = ref_att.kv_codec(kv_bits, page), att.kv_codec(kv_bits,
                                                                      page)
    c_r, s_r = codec_r.encode(jnp.asarray(_x(12, 1, n_pages * page, d)))
    c_r = c_r.reshape((n_pages, page) + c_r.shape[2:])
    s_r = s_r.reshape(n_pages, -1)
    c_p, s_p = _t(c_r), _t(s_r)
    x = _x(13, 3, 1, d)
    pages = np.array([3, 1, 4], np.int32)
    pos = np.array([3 * 64 + 17, 64 + 5, 4 * 64], np.int32)
    active = np.array([True, False, True])
    c_r, s_r = ref_att.kv_paged_append(
        codec_r, c_r, s_r, jnp.asarray(x), jnp.asarray(pages),
        jnp.asarray(pos), jnp.asarray(active))
    att.kv_paged_append(codec_p, c_p, s_p, torch.from_numpy(x),
                        torch.from_numpy(pages).long(),
                        torch.from_numpy(pos).long(),
                        torch.from_numpy(active))
    _same(c_p, c_r)
    _same(s_p, s_r)
