"""The port's dense GQA decoder against the reference on the same weights
(``convert.params_from_jax``): logits, one block's calibration capture
(inputs of every weight and the AttnCon column sums), greedy generation,
and rotation with the reference's own Q.

Tolerance: 1e-5 relative to the largest magnitude (2e-5 through a whole
rotated model) — fp32 throughout; XLA and PyTorch sum in different orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rotation import random_hadamard as ref_random_hadamard
from repro.core.rotation import rotate_model as ref_rotate_model
from repro.launch.serve import generate as ref_generate
from repro.models.lm import capture_block as ref_capture_block
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.rotation import rotate_model
from repro_torch.launch.serve import generate
from repro_torch.models.lm import Model, capture_block

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err < rtol, err


@pytest.fixture(scope="module")
def pair(tiny_cfg, tiny_model_params):
    """(ref model, ref params, port model, port params) on the same weights."""
    model, params = tiny_model_params
    pcfg = ModelConfig(**dataclasses.asdict(tiny_cfg))
    pparams = params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                              device="cpu")
    return model, params, Model(pcfg, "cpu"), pparams


def _tokens(cfg, b=2, t=24, seed=0):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (b, t)).astype(np.int32)


def test_logits_match_reference(pair):
    model, params, pmodel, pparams = pair
    toks = _tokens(model.cfg)
    want = model.logits(params, jnp.asarray(toks))
    got = pmodel.logits(pparams, torch.from_numpy(toks).long())
    _close(got, want)


def test_capture_block_matches_reference(pair):
    model, params, pmodel, pparams = pair
    toks = _tokens(model.cfg, seed=1)
    x = params["embed"][jnp.asarray(toks)]
    blk = jax.tree.map(lambda a: a[0], params["groups"])["b0"]
    y_r, caps_r, dom_r, col_r = ref_capture_block(
        blk, model.cfg, model.group_metas[0], x)
    y_p, caps_p, dom_p, col_p = capture_block(
        pparams["layers"][0], pmodel.cfg, torch.from_numpy(np.array(x)))
    _close(y_p, y_r)
    assert dom_p == dom_r
    assert set(caps_p) == set(caps_r)
    for path in caps_r:
        _close(caps_p[path], caps_r[path])
    _close(col_p, col_r)


def test_greedy_generate_matches_reference(pair):
    model, params, pmodel, pparams = pair
    prompts = _tokens(model.cfg, b=2, t=12, seed=2)
    want = np.asarray(ref_generate(model, params, jnp.asarray(prompts), 8))
    got = generate(pmodel, pparams, torch.from_numpy(prompts).long(), 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rotate_model_with_reference_q(pair):
    """Rotation is output-preserving, and with the reference's own Q the
    rotated weights match the reference's rotated weights."""
    model, params, pmodel, pparams = pair
    key = jax.random.key(3)
    kd, _ = jax.random.split(jax.random.fold_in(key, 7))
    q = np.asarray(ref_random_hadamard(kd, model.cfg.d_model))
    rparams, _ = rotate_model(pparams, pmodel.cfg, torch.from_numpy(q.copy()))
    toks = torch.from_numpy(_tokens(model.cfg, seed=4)).long()
    _close(pmodel.logits(rparams, toks), pmodel.logits(pparams, toks), 2e-5)
    ref_rot, rots = ref_rotate_model(params, model.cfg, model, key)
    np.testing.assert_array_equal(np.asarray(rots["q"]), q)
    want = params_from_jax(jax.tree.map(np.asarray, ref_rot), pmodel.cfg,
                           device="cpu")
    for name in ("embed", "head", "final_norm"):
        _close(rparams[name], want[name].numpy())
    for got_l, want_l in zip(rparams["layers"], want["layers"]):
        for sub in ("mixer", "ffn"):
            for w in got_l[sub]:
                _close(got_l[sub][w], want_l[sub][w].numpy())
        for norm in ("mixer_norm", "ffn_norm"):
            _close(got_l[norm], want_l[norm].numpy())
