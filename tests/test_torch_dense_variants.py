"""Whole models of the configs that add qkv bias, tied embeddings and the
Mamba-2 mixer, against the reference: ``qwen1.5-4b-smoke`` (qkv bias, 4 of
4 KV heads), ``command-r-35b-smoke`` (tied embeddings), ``minitron-4b-smoke``
(plain GQA) here; ``mamba2-780m-smoke`` (Mamba-2 blocks, no FFN, tied) and
the same with ``ssm_head_dim`` 8, whose 16 heads make ``wdt`` (64 x 16)
wide enough to quantize, as it is at full width (1536 x 48), run the same
tests from ``tests/test_torch_ssm.py`` (``case_fixture(MAMBA_CASES)``), so
that the two files share the suite's workers.  The same weights
(``convert.params_from_jax``), rotation Q and calibration tokens go through
both packages, in fp32.  The reference draws zero biases and, for Mamba,
zero A_log / dt_bias / conv_b and unit D; here they, and every norm scale,
are drawn away from those values so that every term is exercised.

Tolerances, relative to the largest reference magnitude:
  * logits, rotated weights (the untied head included), logits of a model
    served from an artifact: 1e-5 (fp32 products summed in another order);
  * greedy tokens, quantized codes and packed entries: equal (bitwise).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.packed import load_packed_artifact as ref_load_artifact
from repro.checkpoint.packed import load_packed_forward_params as ref_load_fwd
from repro.checkpoint.packed import save_packed_artifact as ref_save_artifact
from repro.configs import get_config as ref_get_config
from repro.core import rotation as ref_rot
from repro.core.pipeline import RSQConfig as RefRSQConfig
from repro.core.pipeline import RSQPipeline as RefPipeline
from repro.launch.serve import generate as ref_generate
from repro.models import build_model
from repro_torch.checkpoint.packed import (load_packed_artifact,
                                           load_packed_forward_params,
                                           load_packed_params,
                                           save_packed_artifact)
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import rotation
from repro_torch.core.pipeline import RSQConfig, RSQPipeline
from repro_torch.kernels.quant_matmul.ops import PackedWeight
from repro_torch.launch.serve import generate
from repro_torch.models.lm import Model

RTOL = 1e-5
DENSE_CASES = ("qwen1.5-4b", "command-r-35b", "minitron-4b")
MAMBA_CASES = ("mamba2-780m", "mamba2-780m-nh16")


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err < rtol, err


def _tokens(vocab, b, t, seed):
    return np.random.default_rng(seed).integers(2, vocab, (b, t)).astype(
        np.int32)


def _cfg(case: str):
    if case == "mamba2-780m-nh16":
        return dataclasses.replace(ref_get_config("mamba2-780m").reduced(),
                                   ssm_head_dim=8, dtype="float32")
    return dataclasses.replace(ref_get_config(case).reduced(),
                               dtype="float32")


# leaves drawn away from the reference's constant init: (low, high) of a
# uniform draw, or "normal" for N(0, 0.1)
_DRAWN = {"mixer_norm": (0.5, 1.5), "ffn_norm": (0.5, 1.5),
          "final_norm": (0.5, 1.5), "norm": (0.5, 1.5), "D": (0.5, 1.5),
          "A_log": (-1.0, 1.0), "dt_bias": (-1.0, 0.5), "conv_b": "normal",
          "bq": "normal", "bk": "normal", "bv": "normal"}


def _draw(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _draw(v, rng)
        elif k in _DRAWN:
            lo_hi = _DRAWN[k]
            a = (rng.standard_normal(v.shape) * 0.1 if lo_hi == "normal"
                 else rng.uniform(*lo_hi, v.shape))
            out[k] = jnp.asarray(a, v.dtype)
        else:
            out[k] = v
    return out


def _case(name: str, tmp_path_factory) -> dict:
    """Both models on the same params; both pipelines (3-bit, group 128,
    AttnCon) on the same 8 x 32 calibration tokens, rotated by the same Q
    (the reference's model rotated by its compiled ``rotate_model``, its
    own rotation step off, as ``tests/test_torch_moe.py``) and with
    ``--no-rotate``; the reference's artifacts and the port's."""
    cfg = _cfg(name)
    model = build_model(cfg)
    params = _draw(jax.jit(model.init)(jax.random.key(0)),
                   np.random.default_rng(1))
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    pmodel = Model(pcfg, "cpu")
    pparams = params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                              device="cpu")
    calib = _tokens(cfg.vocab_size, 8, 32, 6)
    kd, _ = jax.random.split(jax.random.fold_in(jax.random.key(0), 7))
    q = np.asarray(ref_rot.random_hadamard(kd, cfg.d_model))
    rotated = jax.jit(lambda p: ref_rot.rotate_model(
        p, cfg, model, jax.random.key(0))[0])(params)
    out = {"cfg": cfg, "model": model, "params": params, "pcfg": pcfg,
           "pmodel": pmodel, "pparams": pparams, "q": q, "rotated": rotated}
    for tag, rotate in (("rot", True), ("norot", False)):
        ref_pipe = RefPipeline(model, RefRSQConfig(
            pack_output=True, rotate=False, scheduler="sequential"))
        ref_q, _ = ref_pipe.run(rotated if rotate else params,
                                jnp.asarray(calib), batch_size=4)
        ref_dir = tmp_path_factory.mktemp(f"ref_{tag}")
        ref_save_artifact(ref_dir, ref_pipe.artifact, params=ref_q)
        pipe = RSQPipeline(pmodel, RSQConfig(pack_output=True,
                                             rotate=rotate))
        port_q, report = pipe.run(pparams, torch.from_numpy(calib).long(),
                                  batch_size=4,
                                  rotation=torch.from_numpy(q.copy()))
        port_dir = tmp_path_factory.mktemp(f"port_{tag}")
        save_packed_artifact(port_dir, pipe.artifact, params=port_q)
        out[tag] = {"ref_q": ref_q, "ref_dir": ref_dir, "port_q": port_q,
                    "port_dir": port_dir, "report": report}
    return out


def case_fixture(cases):
    """The module fixture ``case`` over ``cases``."""
    @pytest.fixture(scope="module", params=cases)
    def case(request, tmp_path_factory):
        return _case(request.param, tmp_path_factory)
    return case


case = case_fixture(DENSE_CASES)
# the tests that take ``case``, which ``tests/test_torch_ssm.py`` runs on
# MAMBA_CASES by a star import
__all__ = ["test_params_match_reference_layout",
           "test_logits_and_loss_match_reference",
           "test_rotate_model_matches_reference",
           "test_quantize_pipeline_codes_bitwise",
           "test_reference_artifact_serves_in_the_port",
           "test_port_artifact_keep_packed_equals_dequantized",
           "test_greedy_generate_matches_reference"]


def test_configs_are_the_references():
    for name in ("minitron-4b", "qwen1.5-4b", "command-r-35b",
                 "command-r-plus-104b", "mamba2-780m", "whisper-medium",
                 "llama-3.2-vision-11b"):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
            ref_get_config(name)), name
        Model(get_config(name + "-smoke"), "cpu")


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b"])
def test_model_refuses_what_is_not_ported(arch):
    """The hybrid is served since it was ported
    (``tests/test_torch_hybrid.py``), but not at a depth that is not a
    whole number of its layer groups, which the reference refuses too.
    (Enc-dec and vision models are served since they were ported,
    ``tests/test_torch_cross.py``.)"""
    cfg = ModelConfig(**dataclasses.asdict(ref_get_config(arch).reduced()))
    with pytest.raises(ValueError, match="scan period"):
        Model(dataclasses.replace(cfg, n_layers=cfg.scan_period + 2), "cpu")


def test_params_match_reference_layout(case):
    """No ``head`` where the reference keeps none (tied), qkv biases where
    it has them, no FFN in a Mamba block; the port's own init draws the
    same leaves and shapes."""
    cfg, pparams = case["cfg"], case["pparams"]
    assert ("head" in pparams) == (not cfg.tie_embeddings)
    own = case["pmodel"].init(torch.Generator().manual_seed(0))
    assert set(own) == set(pparams)
    for blk, ref_blk in zip(own["layers"], pparams["layers"]):
        assert set(blk) == set(ref_blk)
        assert {k: tuple(v.shape) for k, v in blk["mixer"].items()} == \
            {k: tuple(v.shape) for k, v in ref_blk["mixer"].items()}
    if cfg.family == "ssm":
        assert set(pparams["layers"][0]) == {"mixer_norm", "mixer"}
        assert own["layers"][0]["mixer"]["A_log"].dtype == torch.float32
    if cfg.qkv_bias:
        assert {"bq", "bk", "bv"} <= set(pparams["layers"][0]["mixer"])


def test_logits_and_loss_match_reference(case):
    """Logits of 2 x 64 tokens (two 32-token SSD chunks on Mamba) and the
    next-token loss through the tied table or the head."""
    cfg, model, params = case["cfg"], case["model"], case["params"]
    toks = _tokens(cfg.vocab_size, 2, 64, 2)
    want = model.logits(params, jnp.asarray(toks))
    got = case["pmodel"].logits(case["pparams"], torch.from_numpy(toks).long())
    _close(got, want)
    labels = np.roll(toks, -1, axis=1)
    want = model.loss(params, {"tokens": jnp.asarray(toks),
                               "labels": jnp.asarray(labels)})
    got = case["pmodel"].loss(case["pparams"], torch.from_numpy(toks).long(),
                              torch.from_numpy(labels).long())
    _close(got, np.asarray(want))


def test_rotate_model_matches_reference(case):
    """Norms fused (Mamba's into wzx / wbc / wdt; its gated ``norm``
    stays), every block rotated, a tied head untied into Qᵀ·diag(γ)·Eᵀ
    beside the table E·Q, biases left as they are."""
    want = case["rotated"]
    got, _ = rotation.rotate_model(case["pparams"], case["pcfg"],
                                   torch.from_numpy(case["q"].copy()))
    assert "head" in got and "head" not in case["params"] or \
        not case["cfg"].tie_embeddings
    _close(got["head"], want["head"])
    _close(got["embed"], want["embed"])
    stacked = want["groups"]["b0"]
    for li, blk in enumerate(got["layers"]):
        for path, w in jax.tree_util.tree_flatten_with_path(stacked)[0]:
            node = blk
            for key in path:
                node = node[key.key]
            _close(node, np.asarray(w)[li])
    if case["cfg"].qkv_bias:
        np.testing.assert_array_equal(
            got["layers"][0]["mixer"]["bq"].numpy(),
            np.asarray(case["params"]["groups"]["b0"]["mixer"]["bq"][0]))


@pytest.mark.parametrize("tag", ["rot", "norot"])
def test_quantize_pipeline_codes_bitwise(case, tag):
    """Every packed entry of the port's artifact bitwise the reference's,
    at the reference's locations; ``wdt`` is packed where it is 16 wide."""
    ref_e, ref_meta = ref_load_artifact(case[tag]["ref_dir"])
    port_e, port_meta = load_packed_artifact(case[tag]["port_dir"])
    assert set(port_e) == set(ref_e)
    for name, em in ref_meta["entries"].items():
        pem = port_meta["entries"][name]
        for key in ("loc", "path", "d_in", "group_size"):
            assert pem[key] == em[key], (name, key)
        for field in ("codes", "scale", "zero"):
            np.testing.assert_array_equal(port_e[name][field],
                                          ref_e[name][field])
    cfg = case["cfg"]
    if cfg.family == "ssm":
        assert ("layer0/mixer/wdt" in ref_e) == (cfg.ssm_n_heads >= 16)
        assert "layer0/mixer/wzx" in ref_e


@pytest.mark.parametrize("tag", ["rot", "norot"])
def test_reference_artifact_serves_in_the_port(case, tag):
    """A reference-written artifact, rotated (an untied head) and
    ``--no-rotate`` (a tied model keeps no head), loads in the port: the
    packed weights bitwise, the residual's leaves as the reference's tree
    has them, logits as the reference's quantized model, keep-packed greedy
    tokens as the reference's own keep-packed serve."""
    cfg, model, pmodel = case["cfg"], case["model"], case["pmodel"]
    run = case[tag]
    params_p, meta = load_packed_forward_params(run["ref_dir"], device="cpu")
    assert ("head" in params_p) == ("head" in run["ref_q"])
    if tag == "norot":
        assert ("head" in params_p) == (not cfg.tie_embeddings)
    n_packed = sum(isinstance(v, PackedWeight)
                   for blk in params_p["layers"]
                   for v in blk["mixer"].values())
    assert n_packed == sum(em["path"].startswith("mixer/")
                           for em in meta["entries"].values())
    toks = _tokens(cfg.vocab_size, 2, 32, 7)
    _close(pmodel.logits(params_p, torch.from_numpy(toks).long()),
           model.logits(run["ref_q"], jnp.asarray(toks)))
    fwd_r, _ = ref_load_fwd(run["ref_dir"])
    want = ref_generate(model, fwd_r, jnp.asarray(toks[:, :16]), 6)
    got = generate(pmodel, params_p, torch.from_numpy(toks[:, :16]).long(), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_artifact_keep_packed_equals_dequantized(case):
    """The port's own artifacts: keep-packed and load-time dequantized
    serving give the same greedy tokens, in both loops."""
    cfg, pmodel = case["cfg"], case["pmodel"]
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 2, 16, 8)).long()
    for tag in ("rot", "norot"):
        packed, _ = load_packed_forward_params(case[tag]["port_dir"],
                                               device="cpu")
        deq, _ = load_packed_params(case[tag]["port_dir"], device="cpu")
        a = generate(pmodel, packed, toks, 6)
        np.testing.assert_array_equal(
            a.numpy(), generate(pmodel, deq, toks, 6).numpy())
        np.testing.assert_array_equal(
            a.numpy(), generate(pmodel, packed, toks, 6,
                                loop="python").numpy())


def test_greedy_generate_matches_reference(case):
    """Greedy tokens of the fp model: a 16-token prompt, 8 new tokens (on
    Mamba: one 16-token chunk, then 7 state updates)."""
    cfg = case["cfg"]
    toks = _tokens(cfg.vocab_size, 2, 16, 9)
    want = ref_generate(case["model"], case["params"], jnp.asarray(toks), 8)
    got = generate(case["pmodel"], case["pparams"],
                   torch.from_numpy(toks).long(), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
