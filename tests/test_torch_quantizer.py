"""Port quantizer (``repro_torch.core.quantizer``) against the reference:
bitwise equal on the same numpy inputs — find_params, RTN, dequantize,
pack/unpack at 2/3/4/8 bits (including the ragged 3-bit last word)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizer as ref
from repro_torch.core import quantizer as port


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), \
        np.abs(a.astype(np.float64) - b.astype(np.float64)).max()


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("sym", [True, False])
def test_find_params_rtn_dequant_bitwise(bits, sym):
    rng = np.random.default_rng(bits)
    w = (rng.standard_normal((128, 40)) * rng.uniform(0.01, 3, (1, 40))
         ).astype(np.float32)
    w[:, 0] = 0.0  # all-zero column: the 1e-9 scale floor
    rs = ref.QuantSpec(bits=bits, group_size=128, sym=sym)
    ps = port.QuantSpec(bits=bits, group_size=128, sym=sym)
    s_r, z_r = ref.find_params(jnp.asarray(w), rs)
    s_p, z_p = port.find_params(torch.from_numpy(w), ps)
    _same(s_r, s_p.numpy())
    _same(z_r, z_p.numpy())
    q_r = ref.quantize_rtn(jnp.asarray(w), s_r, z_r, rs)
    q_p = port.quantize_rtn(torch.from_numpy(w), s_p, z_p, ps)
    _same(q_r, q_p.numpy())
    _same(ref.dequantize(q_r, s_r, z_r), port.dequantize(q_p, s_p, z_p).numpy())


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_quantize_weight_rtn_bitwise(bits):
    w = np.random.default_rng(0).standard_normal((256, 24)).astype(np.float32)
    r = ref.quantize_weight_rtn(jnp.asarray(w), ref.QuantSpec(bits, 64))
    p = port.quantize_weight_rtn(torch.from_numpy(w), port.QuantSpec(bits, 64))
    for a, b in zip(r, p):
        _same(a, b.numpy())


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("d_in", [128, 37, 10])
def test_pack_unpack_bitwise(bits, d_in):
    rng = np.random.default_rng(d_in)
    q = rng.integers(0, 2 ** bits, (d_in, 24)).astype(np.int32)
    q[0] = 2 ** bits - 1  # top code in the first word
    words_r = np.asarray(ref.pack_codes(jnp.asarray(q), bits))
    words_p = port.pack_codes(torch.from_numpy(q), bits)
    assert words_r.dtype == np.uint32
    _same(words_r, port.words_to_numpy(words_p))
    back = port.unpack_codes(port.words_from_numpy(words_r), bits, d_in)
    _same(q, back.numpy())
    _same(ref.unpack_codes(jnp.asarray(words_r), bits, d_in), back.numpy())


@pytest.mark.parametrize("bits", [3, 4])
def test_dequantize_packed_bitwise(bits):
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((256, 32)).astype(np.float32)
    _, q, s, z = ref.quantize_weight_rtn(jnp.asarray(w), ref.QuantSpec(bits))
    words = np.asarray(ref.pack_codes(q, bits))
    want = ref.dequantize_packed(jnp.asarray(words), s, z, bits=bits,
                                 d_in=256)
    got = port.dequantize_packed(port.words_from_numpy(words),
                                 torch.from_numpy(np.array(s)),
                                 torch.from_numpy(np.array(z)),
                                 bits=bits, d_in=256)
    _same(want, got.numpy())
