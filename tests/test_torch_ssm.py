"""The port's Mamba-2 (SSD) mixer (``repro_torch.models.ssm``) against the
reference's ``repro.models.ssm`` on the same numpy inputs, in fp32, at
``mamba2-780m-smoke``'s widths (d_model 64, d_inner 128, state 16, 8 heads
of 16, conv width 4, chunk 32).  The reference draws A_log, dt_bias and
conv_b as zeros and D and the gated norm as ones; here they are drawn away
from those values so that every term is exercised.

Tolerances, relative to the largest reference magnitude: 1e-5 for every
output and state (fp32 products and exps summed in another order); the
conv alone 1e-6 (taps added in the reference's order).  The decode run
token by token is held to the whole-sequence forward at 1e-5.

The whole-model tests of ``tests/test_torch_dense_variants.py`` run here
too, on ``mamba2-780m-smoke`` and on the same with 16 SSD heads
(``MAMBA_CASES``): logits, rotation, pipeline codes bitwise, the
reference's artifacts served by the port, greedy tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import ssm as ref_ssm
from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm
from test_torch_dense_variants import *  # noqa: F401,F403 (its __all__)
from test_torch_dense_variants import MAMBA_CASES, case_fixture

RTOL = 1e-5
case = case_fixture(MAMBA_CASES)


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err < rtol, err


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    """(reference cfg, port cfg, numpy params) of one Mamba mixer."""
    cfg = dataclasses.replace(ref_get_config("mamba2-780m").reduced(),
                              dtype="float32")
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    d, di, st, nh = (cfg.d_model, cfg.d_inner, cfg.ssm_d_state,
                     cfg.ssm_n_heads)
    w = cfg.ssm_conv_width
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"wzx": normal(d, 2 * di, scale=d ** -0.5),
         "wbc": normal(d, 2 * st, scale=d ** -0.5),
         "wdt": normal(d, nh, scale=d ** -0.5),
         "conv_x": normal(w, di, scale=0.3),
         "conv_bc": normal(w, 2 * st, scale=0.3),
         "conv_b": normal(di + 2 * st, scale=0.1),
         "A_log": rng.uniform(-1.0, 1.0, nh).astype(np.float32),
         "D": rng.uniform(0.5, 1.5, nh).astype(np.float32),
         "dt_bias": rng.uniform(-1.0, 0.5, nh).astype(np.float32),
         "norm": rng.uniform(0.5, 1.5, di).astype(np.float32),
         "out_proj": normal(di, d, scale=di ** -0.5)}
    return cfg, pcfg, p


def _ref(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _port(p):
    return {k: _t(v) for k, v in p.items()}


def _x(cfg, b, t, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)


def test_init_mamba_leaves_and_dtypes():
    """The reference's leaves and shapes; A_log, D and dt_bias fp32 in a
    bf16 mixer, the rest bf16."""
    cfg = ref_get_config("mamba2-780m").reduced()
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    want = ref_ssm.init_mamba(jax.random.key(0), cfg, jnp.bfloat16)
    got = ssm.init_mamba(torch.Generator().manual_seed(0), pcfg,
                         torch.bfloat16, "cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(v.dtype), k


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 10, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    want = ref_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b))
    _close(ssm._causal_conv(_t(x), _t(w), _t(b)), want, 1e-6)


@pytest.mark.parametrize("t", [20, 64], ids=["T_lt_chunk", "T_2chunks"])
def test_ssd_scan_matches_reference(setup, t):
    """T 20 (one chunk of 20: ``min(chunk, T)``) and T 64 (two chunks of
    32, the state carried across): y and the final state."""
    cfg = setup[0]
    nh, hd, st = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_d_state
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, nh, hd)).astype(np.float32)
    dt = rng.uniform(0.01, 1.0, (2, t, nh)).astype(np.float32)
    B = rng.standard_normal((2, t, st)).astype(np.float32)
    C = rng.standard_normal((2, t, st)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, nh).astype(np.float32)
    y_r, h_r = ref_ssm._ssd_scan(*(jnp.asarray(a) for a in (x, dt, B, C, A)),
                                 cfg.ssm_chunk)
    y_p, h_p = ssm._ssd_scan(*(_t(a) for a in (x, dt, B, C, A)),
                             cfg.ssm_chunk)
    _close(y_p, y_r)
    _close(h_p, h_r)


def test_ssd_scan_refuses_a_chunk_that_does_not_divide_t(setup):
    """T 48 with chunk 32: the reference asserts, the port raises."""
    cfg = setup[0]
    nh, hd, st = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_d_state
    x = torch.zeros((1, 48, nh, hd))
    with pytest.raises(ValueError, match="not divisible by chunk=32"):
        ssm._ssd_scan(x, torch.ones((1, 48, nh)), torch.zeros((1, 48, st)),
                      torch.zeros((1, 48, st)), -torch.ones(nh),
                      cfg.ssm_chunk)
    with pytest.raises(AssertionError, match="not divisible"):
        ref_ssm._ssd_scan(jnp.zeros((1, 48, nh, hd)), jnp.ones((1, 48, nh)),
                          jnp.zeros((1, 48, st)), jnp.zeros((1, 48, st)),
                          -jnp.ones(nh), cfg.ssm_chunk)


@pytest.mark.parametrize("t", [64, 2], ids=["T64", "T2_lt_W-1"])
def test_apply_mamba_output_and_state_match_reference(setup, t):
    """Output, conv state (the last W - 1 conv inputs; zero rows in front
    for a prompt shorter than W - 1) and the final SSM state."""
    cfg, pcfg, p = setup
    x = _x(cfg, 2, t, 3)
    out_r, (conv_r, ssm_r) = ref_ssm.apply_mamba(_ref(p), cfg, jnp.asarray(x),
                                                 return_state=True)
    out_p, (conv_p, ssm_p) = ssm.apply_mamba(_port(p), pcfg, _t(x),
                                             return_state=True)
    _close(out_p, out_r)
    _close(conv_p, conv_r)
    _close(ssm_p, ssm_r)
    assert conv_p.shape == (2, cfg.ssm_conv_width - 1,
                            cfg.d_inner + 2 * cfg.ssm_d_state)
    if t < cfg.ssm_conv_width - 1:
        assert not conv_p[:, :cfg.ssm_conv_width - 1 - t].any()
    _close(ssm.apply_mamba(_port(p), pcfg, _t(x)), out_r)


def test_capture_mamba_inputs_match_reference(setup):
    """The four calibration inputs: wzx / wbc / wdt the stream itself,
    out_proj the gated, normed output."""
    cfg, pcfg, p = setup
    x = _x(cfg, 2, 32, 4)
    out_r, caps_r = ref_ssm.capture_mamba(_ref(p), cfg, jnp.asarray(x))
    out_p, caps_p = ssm.capture_mamba(_port(p), pcfg, _t(x))
    _close(out_p, out_r)
    assert set(caps_p) == set(caps_r) == {"wzx", "wbc", "wdt", "out_proj"}
    for name, v in caps_r.items():
        _close(caps_p[name], v)


def test_mamba_decode_token_by_token_equals_apply(setup):
    """A 2-token prompt's state (shorter than W - 1), then 30 decode steps:
    each step's output and the state after the last are the whole
    sequence's (``apply_mamba`` over all 32 tokens), and every step is the
    reference's step on the same state; the state buffers advance in
    place."""
    cfg, pcfg, p = setup
    pp, pr = _port(p), _ref(p)
    x = _x(cfg, 2, 32, 5)
    whole, (conv_w, ssm_w) = ssm.apply_mamba(pp, pcfg, _t(x),
                                             return_state=True)
    out, (conv, state) = ssm.apply_mamba(pp, pcfg, _t(x[:, :2]),
                                         return_state=True)
    conv, state = conv.clone(), state.clone()
    buffers = (conv.data_ptr(), state.data_ptr())
    # copies: a jax array may share a numpy buffer that the port then
    # advances in place
    conv_r, state_r = (jnp.asarray(a.numpy().copy()) for a in (conv, state))
    for i in range(2, 32):
        want, (conv_r, state_r) = ref_ssm.mamba_decode(
            pr, cfg, jnp.asarray(x[:, i:i + 1]), conv_r, state_r)
        step = ssm.mamba_decode(pp, pcfg, _t(x[:, i:i + 1]), conv, state)
        _close(step, want)
        _close(step, whole[:, i:i + 1].numpy())
    assert (conv.data_ptr(), state.data_ptr()) == buffers
    _close(conv, conv_r)
    _close(state, state_r)
    _close(conv, conv_w.numpy())
    _close(state, ssm_w.numpy())
