"""The port's quantized KV cache against the reference: codecs, flat
appends with the kv2 chunk-leader rule, paged appends, and the cache
layout the model allocates.

Every comparison here is bitwise: int8 codes, uint32 words of 2-bit codes
(held as int32 by the port) and bf16 scales are integer or pure
elementwise math on the same fp32 inputs.  Inputs are numpy draws shared by
both sides.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_att
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantizer import words_from_numpy, words_to_numpy
from repro_torch.models import attention as att
from repro_torch.models.lm import Model


def _x(seed, *shape):
    rng = np.random.default_rng(seed)
    # a spread of magnitudes per token, so scales vary across rows
    return (rng.normal(size=shape) * rng.exponential(size=shape[:-1] + (1,))
            ).astype(np.float32)


def _np(a):
    """Port tensor or reference array -> numpy, bf16 widened exactly."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.float().numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _same_codes(got, want):
    want = np.asarray(want)
    if want.dtype == np.uint32:
        np.testing.assert_array_equal(words_to_numpy(got), want)
    else:
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("shape", [(2, 96, 2, 16), (3, 70, 2, 40),
                                   (1, 5, 8, 128)])
def test_kv_quantize_bitwise(shape):
    x = _x(0, *shape)
    q_r, s_r = ref_att.kv_quantize(jnp.asarray(x))
    q_p, s_p = att.kv_quantize(torch.from_numpy(x))
    assert q_p.dtype == torch.int8 and s_p.dtype == torch.bfloat16
    _same_codes(q_p, q_r)
    np.testing.assert_array_equal(_np(s_p), _np(s_r))
    np.testing.assert_array_equal(
        _np(att.kv_dequantize(q_p, s_p, torch.float32)),
        _np(ref_att.kv_dequantize(q_r, s_r, jnp.float32)))


@pytest.mark.parametrize("d", [16, 40, 128])
def test_kv_pack_unpack_bitwise(d):
    codes = np.random.default_rng(1).integers(0, 4, (3, 7, d))
    # force code 3 into bits 30-31 of some words: a negative int32
    codes[..., 15::16] = 3
    w_r = ref_att.kv_pack(jnp.asarray(codes, jnp.int32))
    w_p = att.kv_pack(torch.from_numpy(codes))
    assert w_p.dtype == torch.int32 and bool((w_p < 0).any())
    _same_codes(w_p, w_r)
    np.testing.assert_array_equal(att.kv_unpack(w_p, d).numpy(), codes)
    np.testing.assert_array_equal(
        att.kv_unpack(words_from_numpy(np.asarray(w_r)), d).numpy(),
        np.asarray(ref_att.kv_unpack(w_r, d)))


@pytest.mark.parametrize("t,d,chunk", [(130, 16, 64), (64, 40, 64),
                                       (37, 128, 16)])
def test_kv_log_scales_encode_decode_bitwise(t, d, chunk):
    x = _x(2, 2, t, 2, d)
    s_r = ref_att.kv_log_scales(jnp.asarray(x), chunk)
    s_p = att.kv_log_scales(torch.from_numpy(x), chunk)
    assert s_p.shape == (2, -(-t // chunk), 2)
    np.testing.assert_array_equal(_np(s_p), _np(s_r))
    c_r = ref_att.kv_log_encode(jnp.asarray(x), s_r, chunk)
    c_p = att.kv_log_encode(torch.from_numpy(x), s_p, chunk)
    _same_codes(c_p, c_r)
    np.testing.assert_array_equal(
        att.kv_log_decode(c_p, s_p, d=d, chunk=chunk).numpy(),
        np.asarray(ref_att.kv_log_decode(c_r, s_r, d=d, chunk=chunk)))


@pytest.mark.parametrize("kv_bits", [8, 2])
def test_flat_append_with_chunk_leader_bitwise(kv_bits):
    """Prefill 128 rows, then append 76 tokens one at a time (crossing a
    chunk boundary at 192): codes and scales equal the reference's after
    every append, and a kv2 chunk's scale is stamped only by its leader."""
    x = _x(3, 2, 204, 2, 40)
    codec_r = ref_att.kv_codec(kv_bits, 64)
    codec_p = att.kv_codec(kv_bits, 64)
    c_r, s_r = codec_r.encode(jnp.asarray(x[:, :128]))
    c_p, s_p = codec_p.encode(torch.from_numpy(x[:, :128]))
    rows, srows = 256, codec_p.scale_rows(256)
    c_r = jnp.concatenate([c_r, jnp.zeros_like(c_r[:, :1]).repeat(
        rows - 128, 1)], 1)
    s_r = jnp.concatenate([s_r, jnp.zeros_like(s_r[:, :1]).repeat(
        srows - s_r.shape[1], 1)], 1)
    c_p = torch.cat([c_p, c_p.new_zeros((2, rows - 128) + c_p.shape[2:])], 1)
    s_p = torch.cat([s_p, s_p.new_zeros((2, srows - s_p.shape[1], 2))], 1)
    for t in range(128, 204):
        c_r, s_r = codec_r.append(c_r, s_r, jnp.asarray(x[:, t:t + 1]),
                                  jnp.int32(t))
        codec_p.append(c_p, s_p, torch.from_numpy(x[:, t:t + 1]), t)
    _same_codes(c_p, c_r)
    np.testing.assert_array_equal(_np(s_p), _np(s_r))
    if kv_bits == 2:  # chunk 3's scale is token 192's own amax
        lead = np.abs(x[:, 192]).max(-1)
        np.testing.assert_array_equal(
            _np(s_p[:, 3]), _np(torch.from_numpy(lead).to(torch.bfloat16)))


@pytest.mark.parametrize("kv_bits", [8, 2])
def test_paged_append_bitwise(kv_bits):
    """One token per slot into shared pools: slots 0 and 2 active (slot 2
    at a chunk leader), slot 1 inactive and routed to the trash page."""
    page, n_pages = 64, 6
    codec_r = ref_att.kv_codec(kv_bits, page)
    codec_p = att.kv_codec(kv_bits, page)
    init = _x(4, n_pages * page, 2, 16)[None]
    c_r, s_r = codec_r.encode(jnp.asarray(init))
    c_r = c_r.reshape((n_pages, page) + c_r.shape[2:])
    s_r = s_r.reshape((n_pages, -1) + s_r.shape[2:])
    c_p = torch.from_numpy(np.array(c_r)) if kv_bits == 8 else \
        words_from_numpy(np.asarray(c_r))
    s_p = torch.from_numpy(_np(s_r)).to(torch.bfloat16)
    x = _x(5, 3, 1, 2, 16)
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
    _same_codes(c_p, c_r)
    np.testing.assert_array_equal(_np(s_p), _np(s_r))


def test_codec_layout_and_model_cache(tiny_cfg):
    for bits, code_dt, w in ((8, torch.int8, 16), (2, torch.int32, 1)):
        codec = att.kv_codec(bits, 64)
        ref = ref_att.kv_codec(bits, 64)
        assert codec.page_tokens == ref.page_tokens == 64
        assert codec.chunk == ref.chunk
        for s in (1, 64, 100, 130):
            assert codec.round_len(s) == ref.round_len(s)
            assert codec.scale_rows(codec.round_len(s)) == \
                ref.scale_rows(ref.round_len(s))
        cfg = dataclasses.replace(ModelConfig(**dataclasses.asdict(tiny_cfg)),
                                  kv_bits=bits)
        model = Model(cfg, "cpu")
        assert model._cache_len(100) == 128
        cache = model.init_cache(2, 100)
        assert len(cache) == cfg.n_layers
        assert cache[0]["k"].shape == (2, 128, 2, w)
        assert cache[0]["k"].dtype == code_dt
        assert cache[0]["ks"].shape == (2, codec.scale_rows(128), 2)
        assert cache[0]["ks"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="kv_bits"):
        att.kv_codec(4, 64)
    with pytest.raises(ValueError, match="kv_bits"):
        Model(dataclasses.replace(ModelConfig(**dataclasses.asdict(tiny_cfg)),
                                  kv_bits=4), "cpu")
