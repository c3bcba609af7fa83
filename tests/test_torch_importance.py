"""The port's eight token-importance strategies, chunk restriction and
dataset expansion against the reference's, on shared numpy inputs.

Tolerances: the {0, 1} masks (``first_n``, ``first_last_n``), the chunk
mask and the expanded token sets bitwise; the normalized strategies 1e-6
relative (fp32 norms and the Eq. 4 map, reduced in another order);
``token_sim`` 1e-5 on features on a grid of 1/8, where every squared
distance is exact in fp32 (the sums over T and the map in another order).
On Gaussian features a token's distance to itself, |z|² + |z|² - 2·z·z,
cancels to rounding noise of either sign, and its square root (~1e-3)
differs between the two frameworks' summation orders; there both are held
to the float64 value within 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.expansion import expand_dataset as ref_expand
from repro.core.importance import ImportanceInputs as RefInputs
from repro.core.importance import STRATEGIES as REF_STRATEGIES
from repro.core.pipeline import RSQConfig as RefRSQConfig
from repro.core.pipeline import _chunk_mask as ref_chunk_mask
from repro.core.pipeline import _strategy_kwargs as ref_strategy_kwargs
from repro_torch.core.expansion import expand_dataset
from repro_torch.core.importance import STRATEGIES, ImportanceInputs
from repro_torch.core.pipeline import RSQConfig, _chunk_mask, _strategy_kwargs

B, T, D, VOCAB = 3, 40, 24, 97


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    z_in = rng.standard_normal((B, T, D)).astype(np.float32)
    return {"z_in": z_in,
            "z_out": (z_in + 0.3 * rng.standard_normal((B, T, D))
                      ).astype(np.float32),
            "tokens": rng.integers(0, VOCAB, (B, T)),
            "attn_colsum": rng.uniform(0.0, 9.0, (B, T)).astype(np.float32),
            "token_counts": rng.integers(0, 50, VOCAB).astype(np.float32)}


def _both(name, kw, seed=0):
    raw = _inputs(seed)
    ref = REF_STRATEGIES[name](RefInputs(**{k: jnp.asarray(v)
                                            for k, v in raw.items()}), **kw)
    port = STRATEGIES[name](ImportanceInputs(**{k: torch.from_numpy(v)
                                                for k, v in raw.items()}),
                            **kw)
    return np.asarray(port), np.asarray(ref)


def test_the_eight_strategies_are_the_references():
    assert set(STRATEGIES) == set(REF_STRATEGIES) and len(STRATEGIES) == 8


@pytest.mark.parametrize("name,n", [("first_n", 16), ("first_n", 64),
                                    ("first_last_n", 16),
                                    ("first_last_n", 15),
                                    ("first_last_n", 100)])
def test_position_masks_bitwise(name, n):
    port, ref = _both(name, {"n": n})
    assert port.shape == (B, T) and port.dtype == np.float32
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("name", ["uniform", "token_freq", "act_norm",
                                  "act_diff", "attn_con"])
@pytest.mark.parametrize("r_min,r_max", [(0.01, 1.0), (0.2, 0.6)])
def test_normalized_strategies(name, r_min, r_max):
    kw = {} if name == "uniform" else {"r_min": r_min, "r_max": r_max}
    port, ref = _both(name, kw, seed=1)
    assert port.shape == (B, T)
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=1e-6 * r_max)


def test_attn_con_without_colsum_is_act_norm():
    raw = _inputs(2)
    inp = ImportanceInputs(z_in=torch.from_numpy(raw["z_in"]))
    ref = REF_STRATEGIES["attn_con"](RefInputs(z_in=jnp.asarray(raw["z_in"])))
    np.testing.assert_allclose(np.asarray(STRATEGIES["attn_con"](inp)),
                               np.asarray(ref), rtol=1e-6, atol=1e-6)


def _token_sim(z, chunk):
    ref = REF_STRATEGIES["token_sim"](RefInputs(z_in=jnp.asarray(z)),
                                      chunk=chunk)
    port = STRATEGIES["token_sim"](ImportanceInputs(z_in=torch.from_numpy(z)),
                                   chunk=chunk)
    return port.numpy(), np.asarray(ref)


@pytest.mark.parametrize("chunk", [16, 7, 40, 512])
def test_token_sim_chunked(chunk):
    """T 40 is no multiple of 16 or 7: the port's last chunk is ragged,
    where the reference computes all T at once."""
    z = np.round(_inputs(3)["z_in"] * 8) / 8  # exact squared distances
    port, ref = _token_sim(z.astype(np.float32), chunk)
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk", [16, 512])
def test_token_sim_gaussian_to_float64(chunk):
    z = _inputs(3)["z_in"]
    port, ref = _token_sim(z, chunk)
    z64 = z.astype(np.float64)
    raw = np.sqrt(((z64[:, :, None] - z64[:, None]) ** 2).sum(-1)).sum(-1)
    lo, hi = raw.min(-1, keepdims=True), raw.max(-1, keepdims=True)
    exact = 0.005 + (raw - lo) / (hi - lo) * (1.0 - 0.005)
    np.testing.assert_allclose(ref, exact, atol=1e-4)
    np.testing.assert_allclose(port, exact, atol=1e-4)


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_strategy_kwargs_as_the_reference(name):
    for kw in ({}, {"first_n": 7, "r_min": 0.2, "r_max": 0.9}):
        assert _strategy_kwargs(RSQConfig(importance=name, **kw)) == \
            ref_strategy_kwargs(RefRSQConfig(importance=name, **kw))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.25, 0.5), (0.0, 0.3),
                                   (0.7, 1.0), (0.33, 0.34)])
def test_chunk_mask_bitwise(lo, hi):
    r = np.random.default_rng(4).uniform(0.01, 1.0, (B, T)).astype(np.float32)
    port = _chunk_mask(torch.from_numpy(r),
                       RSQConfig(chunk_lo=lo, chunk_hi=hi))
    ref = ref_chunk_mask(jnp.asarray(r), RefRSQConfig(chunk_lo=lo,
                                                      chunk_hi=hi))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("m", [1, 2, 8])
@pytest.mark.parametrize("t", [37, 64])
def test_expand_dataset_bitwise(m, t):
    tokens = np.random.default_rng(m + t).integers(0, 500, (3, t))
    port = expand_dataset(torch.from_numpy(tokens), m)
    ref = ref_expand(jnp.asarray(tokens), m)
    assert port.shape == (3 * m, t)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
