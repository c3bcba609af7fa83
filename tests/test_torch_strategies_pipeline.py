"""Two more of the paper's calibration settings end to end against the
reference: its quantize CLI with ``--importance token_freq --expansion 2``
(token counts over the expanded set, every sample and its circular shift)
and with ``--importance act_diff`` (the block's output against its input),
and the port's pipeline with the same settings on the same weights,
rotation Q and calibration tokens.

Tolerances as ``tests/test_torch_pipeline.py``: at least 99% of every
packed weight's codes equal, and the quantized model's perplexity within
1e-4 relative (what fp32 summation order leaves once the codes agree; one
flipped 3-bit code moves a weight by a whole step, ~1e-3).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.packed import load_packed_artifact as ref_load_artifact
from repro.configs import get_config as ref_get_config
from repro.core.rotation import random_hadamard as ref_random_hadamard
from repro.data.calibration import calibration_set as ref_calibration_set
from repro.data.synthetic import SyntheticCorpus as RefCorpus
from repro.launch.quantize import main as ref_quantize_main
from repro.models import build_model
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.pipeline import RSQConfig, RSQPipeline
from repro_torch.core.quantizer import words_to_numpy
from repro_torch.launch.quantize import eval_ppl
from repro_torch.models.lm import Model

ARCH = "llama3-8b-smoke"  # d_model 64, 4 heads / 2 KV, d_ff 128, vocab 512


@pytest.fixture(scope="module", params=[("token_freq", 2), ("act_diff", 1)],
                ids=["token_freq-expansion2", "act_diff"])
def runs(request, tmp_path_factory):
    importance, expansion = request.param
    art = tmp_path_factory.mktemp(f"ref_{importance}")
    ref_out = ref_quantize_main([
        "--arch", ARCH, "--n-calib", "8", "--calib-seq", "32", "--batch", "4",
        "--importance", importance, "--expansion", str(expansion),
        "--scheduler", "sequential", "--pack-out", str(art)])
    # the CLI's own draws: params from key(seed), its calibration and
    # held-out sets, and the pipeline's rotation fold_in(key(seed), 7)
    cfg = dataclasses.replace(ref_get_config(ARCH), dtype="float32")
    params = jax.jit(build_model(cfg).init)(jax.random.key(0))
    calib = np.array(ref_calibration_set(cfg.vocab_size, 8, 32, seed=0))
    heldout = np.array(RefCorpus(vocab_size=cfg.vocab_size, seed=0).sample(
        jax.random.key(12345), 8, 32))
    kd, _ = jax.random.split(jax.random.fold_in(jax.random.key(0), 7))
    rot = np.array(ref_random_hadamard(kd, cfg.d_model))

    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    pmodel = Model(pcfg, "cpu")
    pparams = params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                              device="cpu")
    pipe = RSQPipeline(pmodel, RSQConfig(importance=importance,
                                         expansion=expansion,
                                         pack_output=True))
    pq_params, report = pipe.run(pparams, torch.from_numpy(calib),
                                 batch_size=4, rotation=torch.from_numpy(rot))
    return {"summary": ref_out["summary"], "art_dir": art, "heldout": heldout,
            "pmodel": pmodel, "pq_params": pq_params,
            "partifact": pipe.artifact, "report": report}


def test_codes_match_reference(runs):
    ref_e, _ = ref_load_artifact(runs["art_dir"])
    port_e = runs["partifact"]["entries"]
    assert set(ref_e) == set(port_e) and len(port_e) == 14  # 2 layers x 7
    for name in ref_e:
        same = (words_to_numpy(port_e[name]["codes"])
                == ref_e[name]["codes"]).mean()
        assert same >= 0.99, (name, same)


def test_ppl_matches_reference(runs):
    ppl_r = runs["summary"]["ppl_quant"]
    ppl_p = eval_ppl(runs["pmodel"], runs["pq_params"],
                     torch.from_numpy(runs["heldout"]))
    assert abs(ppl_p - ppl_r) <= 1e-4 * ppl_r, (ppl_p, ppl_r)
    losses = [v for rep in runs["report"]["layers"].values()
              for v in rep["weights"].values()]
    assert len(losses) == 14 and all(np.isfinite(losses))
