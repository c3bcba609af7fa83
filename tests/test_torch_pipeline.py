"""The slice end to end against the reference: the reference's quantize
CLI (``repro.launch.quantize --pack-out``) and the port's RSQ pipeline
(rotate -> AttnCon scale -> GPTQ) on the same weights, rotation Q and
calibration tokens, and the packed serving artifact in both directions.

Tolerances:
  * perplexity: 1e-5 relative for the fp model (same weights, fp32);
    1e-4 after quantization.  The two pipelines' codes agree (at least 99%
    required, as for GPTQ alone; bit for bit here), so what remains is fp32
    summation order; a single flipped 3-bit code moves a weight by a whole
    quantization step and would show up as ~1e-3;
  * packed entries of a reference-written artifact: bitwise;
  * serving logits from a reference artifact: 1e-5 relative (fp32).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.packed import load_packed_artifact as ref_load_artifact
from repro.checkpoint.packed import load_packed_forward_params as ref_load_fwd
from repro.checkpoint.packed import load_packed_params as ref_load_params
from repro.configs import get_config as ref_get_config
from repro.core.rotation import random_hadamard as ref_random_hadamard
from repro.data.calibration import calibration_set as ref_calibration_set
from repro.data.synthetic import SyntheticCorpus as RefCorpus
from repro.launch.quantize import main as ref_quantize_main
from repro.launch.serve import generate as ref_generate
from repro.models import build_model
from repro_torch.checkpoint.packed import (ArtifactCorruptError,
                                           load_packed_artifact,
                                           load_packed_forward_params,
                                           load_packed_params,
                                           resident_weight_bytes,
                                           save_packed_artifact)
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.pipeline import RSQConfig, RSQPipeline
from repro_torch.core.quantizer import words_to_numpy
from repro_torch.kernels.quant_matmul.ops import PackedWeight
from repro_torch.launch.quantize import eval_ppl
from repro_torch.launch.serve import generate
from repro_torch.models.lm import Model

ARCH = "llama3-8b-smoke"  # d_model 64, 4 heads / 2 KV, d_ff 128, vocab 512


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference CLI (``repro.launch.quantize --pack-out``) and the
    port's pipeline on the same params, Q and calibration tokens."""
    art = tmp_path_factory.mktemp("ref_artifact")
    ref_out = ref_quantize_main([
        "--arch", ARCH, "--n-calib", "8", "--calib-seq", "32", "--batch", "4",
        "--scheduler", "sequential", "--pack-out", str(art)])
    # the CLI's own draws: params from key(seed), its calibration and
    # held-out sets, and the pipeline's rotation fold_in(key(seed), 7)
    cfg = dataclasses.replace(ref_get_config(ARCH), dtype="float32")
    model = build_model(cfg)
    params = jax.jit(model.init)(jax.random.key(0))
    calib = np.array(ref_calibration_set(cfg.vocab_size, 8, 32, seed=0))
    heldout = np.array(RefCorpus(vocab_size=cfg.vocab_size, seed=0).sample(
        jax.random.key(12345), 8, 32))
    kd, _ = jax.random.split(jax.random.fold_in(jax.random.key(0), 7))
    rot = np.array(ref_random_hadamard(kd, cfg.d_model))

    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    pmodel = Model(pcfg, "cpu")
    pparams = params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                              device="cpu")
    ppipe = RSQPipeline(pmodel, RSQConfig(pack_output=True))
    pq_params, report = ppipe.run(pparams, torch.from_numpy(calib),
                                  batch_size=4,
                                  rotation=torch.from_numpy(rot))
    return {"model": model, "summary": ref_out["summary"], "art_dir": art,
            "heldout": heldout, "pmodel": pmodel, "pparams": pparams,
            "pq_params": pq_params, "partifact": ppipe.artifact,
            "report": report}


def test_rsq_pipeline_ppl_matches_reference(runs):
    pmodel, held = runs["pmodel"], torch.from_numpy(runs["heldout"])
    ppl_fp_r, ppl_q_r = runs["summary"]["ppl_fp"], runs["summary"]["ppl_quant"]
    ppl_fp_p = eval_ppl(pmodel, runs["pparams"], held)
    assert abs(ppl_fp_p - ppl_fp_r) <= 1e-5 * ppl_fp_r
    ppl_q_p = eval_ppl(pmodel, runs["pq_params"], held)
    assert abs(ppl_q_p - ppl_q_r) <= 1e-4 * ppl_q_r, (ppl_q_p, ppl_q_r)
    assert set(runs["report"]["layers"]) == {"layer0", "layer1"}
    # the two pipelines' codes: the same weights, nearly every code equal
    ref_e, ref_meta = ref_load_artifact(runs["art_dir"])
    port_e = runs["partifact"]["entries"]
    assert set(ref_e) == set(port_e)
    for name in ref_e:
        same = (words_to_numpy(port_e[name]["codes"])
                == ref_e[name]["codes"]).mean()
        assert same >= 0.99, (name, same)
        assert runs["partifact"]["meta"][name]["group_size"] == \
            ref_meta["entries"][name]["group_size"]


def test_reference_artifact_loads_bitwise_and_serves(runs):
    art = runs["art_dir"]
    entries_r, meta_r = ref_load_artifact(art)
    entries_p, meta_p = load_packed_artifact(art)
    assert meta_p["entries"] == meta_r["entries"]
    for name, e in entries_r.items():
        for field in ("codes", "scale", "zero"):
            a, b = entries_p[name][field], np.asarray(e[field])
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, field)
    params_p, _ = load_packed_forward_params(art, device="cpu")
    for name, em in meta_r["entries"].items():
        pw = params_p["layers"][em["loc"][1]]
        for key in em["path"].split("/"):
            pw = pw[key]
        assert isinstance(pw, PackedWeight)
        assert np.array_equal(words_to_numpy(pw.w_packed),
                              entries_r[name]["codes"])
    model, pmodel = runs["model"], runs["pmodel"]
    toks = runs["heldout"][:2, :16]
    params_r, _ = ref_load_params(art)
    want = model.logits(params_r, jnp.asarray(toks))
    got = pmodel.logits(params_p, torch.from_numpy(toks).long())
    assert _rel(got.numpy(), want) < 1e-5
    fwd_r, _ = ref_load_fwd(art)
    tok_r = ref_generate(model, fwd_r, jnp.asarray(toks[:, :8]), 6)
    tok_p = generate(pmodel, params_p, torch.from_numpy(toks[:, :8]).long(), 6)
    np.testing.assert_array_equal(tok_p.numpy(), np.asarray(tok_r))


def test_port_artifact_roundtrip_and_checksum(runs, tmp_path):
    pmodel = runs["pmodel"]
    art = tmp_path / "port_artifact"
    save_packed_artifact(art, runs["partifact"], params=runs["pq_params"],
                         extra={"arch": "tiny"})
    packed, _ = load_packed_forward_params(art, device="cpu")
    deq, _ = load_packed_params(art, device="cpu")
    toks = torch.from_numpy(runs["heldout"][:2, :16]).long()
    np.testing.assert_array_equal(pmodel.logits(packed, toks).numpy(),
                                  pmodel.logits(deq, toks).numpy())
    assert _rel(pmodel.logits(deq, toks).numpy(),
                pmodel.logits(runs["pq_params"], toks).numpy()) < 1e-5
    packed_b, fp_b = resident_weight_bytes(packed)
    assert 0 < packed_b < resident_weight_bytes(deq)[1] - fp_b
    meta = json.loads((art / "meta.json").read_text())
    assert "residual_treedef" not in meta and meta["residual_paths"]
    blob = bytearray((art / "packed.npz").read_bytes())
    blob[-100] ^= 0xFF
    (art / "packed.npz").write_bytes(bytes(blob))
    with pytest.raises(ArtifactCorruptError):
        load_packed_forward_params(art, device="cpu")


@pytest.mark.parametrize("entry", ["Model", "load_packed_forward_params",
                                   "load_packed_params",
                                   "packed_weight_from_artifact",
                                   "params_from_jax", "quantize_cli",
                                   "serve_cli"])
def test_entry_points_default_to_cuda_and_raise_without_card(
        runs, entry, monkeypatch):
    """Every entry point runs on the card unless asked for the CPU; with no
    card, the default raises instead of carrying on with the plain
    versions."""
    from repro_torch.kernels.quant_matmul.ops import \
        packed_weight_from_artifact
    from repro_torch.launch import quantize, serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    art = runs["art_dir"]
    entries, meta = load_packed_artifact(art)
    name = next(iter(meta["entries"]))
    calls = {
        "Model": lambda: Model(runs["pmodel"].cfg),
        "load_packed_forward_params": lambda: load_packed_forward_params(art),
        "load_packed_params": lambda: load_packed_params(art),
        "packed_weight_from_artifact": lambda: packed_weight_from_artifact(
            entries[name], meta["entries"][name], meta["spec"]),
        "params_from_jax": lambda: params_from_jax(
            jax.tree.map(np.asarray, runs["model"].init(jax.random.key(0))),
            runs["pmodel"].cfg),
        "quantize_cli": lambda: quantize.main(["--arch", ARCH]),
        "serve_cli": lambda: serve.main(["--arch", ARCH]),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()
