"""The port's MLA slice against the reference, on deepseek-v3's layers with
the experts taken out: ``deepseek-v3-671b`` reduced, with no routed or
shared experts, so both of its layers are MLA plus a dense SwiGLU FFN
(the reference holds layer 0 as a ``prefix`` block and layer 1 in its
stacked ``groups``; it cannot build a model whose layers all sit in the
dense prefix).  The same weights (``convert.params_from_jax``), rotation Q
and calibration tokens go through both packages, in fp32.

Tolerances, relative to the largest reference magnitude:
  * rotated weights, prefill logits, fp and kv2 decode logits: 1e-5 —
    fp32 products summed in another order;
  * kv8 decode logits: 1e-4 — the latent rows reach the int8 codec from
    two fp32 forwards that differ in the last bit, and a code on a rounding
    boundary then flips by one step (as ``tests/test_torch_serving.py``);
  * greedy tokens, quantized codes, packed entries and kv2 cache codes:
    equal (bitwise); kv8 cache codes of the paged steps: at most one code
    in a thousand a single step apart, scales within one bf16 rounding
    (2^-8), for the same reason as kv8's logits.
Within the port the engine is held to its own solo ``generate`` bitwise
(whole-prompt and exact chunked admission); the paged chunked prefill,
which reads earlier chunks back from their codes, is held bitwise to each
request served alone through the same mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.packed import dequantize_entry as ref_dequantize_entry
from repro.checkpoint.packed import load_packed_artifact as ref_load_artifact
from repro.checkpoint.packed import load_packed_forward_params as ref_load_fwd
from repro.checkpoint.packed import save_packed_artifact as ref_save_artifact
from repro.configs import get_config as ref_get_config
from repro.core import rotation as ref_rot
from repro.core.pipeline import RSQConfig as RefRSQConfig
from repro.core.pipeline import RSQPipeline as RefPipeline
from repro.launch.serve import generate as ref_generate
from repro.models import build_model
from repro.serving import PagedPools as RefPagedPools
from repro_torch.checkpoint.packed import (load_packed_artifact,
                                           load_packed_forward_params,
                                           load_packed_params,
                                           save_packed_artifact)
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import rotation
from repro_torch.core.pipeline import RSQConfig, RSQPipeline
from repro_torch.core.quantizer import words_to_numpy
from repro_torch.kernels.quant_matmul.ops import PackedWeight
from repro_torch.launch import serve
from repro_torch.launch.serve import generate
from repro_torch.models.lm import Model
from repro_torch.serving import (Engine, PagedPools, SamplingParams,
                                 ServeRequest)

RTOL = {0: 1e-5, 2: 1e-5, 8: 1e-4}  # by kv_bits, see above
EXPERT_FREE = dict(n_routed_experts=0, n_shared_experts=0, moe_top_k=0,
                   moe_d_ff=0)


def _close(got, want, rtol):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err < rtol, err


def _tokens(vocab, b, t, seed):
    return np.random.default_rng(seed).integers(2, vocab, (b, t)).astype(
        np.int32)


def _expert_free(kv_bits=0):
    return dataclasses.replace(ref_get_config("deepseek-v3-671b").reduced(),
                               dtype="float32", kv_bits=kv_bits,
                               **EXPERT_FREE)


@pytest.fixture(scope="module")
def shared():
    """Reference params of the expert-free config (norm scales drawn away
    from 1 so that every fold is exercised) and the port's copy."""
    cfg = _expert_free()
    model = build_model(cfg)
    params = jax.jit(model.init)(jax.random.key(0))
    rng = np.random.default_rng(1)

    def jitter(tree):
        return {k: (jitter(v) if isinstance(v, dict) else
                    (v * jnp.asarray(rng.uniform(0.5, 1.5, v.shape),
                                     v.dtype) if k.endswith("norm") else v))
                for k, v in tree.items()}

    params = dict(params, prefix=[jitter(b) for b in params["prefix"]],
                  groups=jitter(params["groups"]))
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    pparams = params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                              device="cpu")
    return cfg, params, pcfg, pparams


def _models(cfg, pcfg, kv_bits):
    return (build_model(dataclasses.replace(cfg, kv_bits=kv_bits)),
            Model(dataclasses.replace(pcfg, kv_bits=kv_bits), "cpu"))


@pytest.mark.parametrize("arch", ["deepseek-v3-671b",
                                  "deepseek-v3-671b-smoke",
                                  "deepseek-v2-236b",
                                  "deepseek-v2-236b-smoke"])
def test_model_builds_deepseek_with_its_moe_layers(arch):
    """Both DeepSeek configs, full and smoke, build with their routed-expert
    layers after the dense prefix (no weights are drawn here)."""
    cfg = get_config(arch)
    kinds = cfg.ffn_kinds()
    assert Model(cfg, "cpu").cfg is cfg
    assert kinds[:cfg.first_dense_layers] == \
        ("dense",) * cfg.first_dense_layers
    assert set(kinds[cfg.first_dense_layers:]) == {"moe"}
    if arch.endswith("-smoke"):
        assert cfg == get_config(arch.removesuffix("-smoke")).reduced()


@pytest.mark.parametrize("arch,match", [
    ("mamba2-780m", "dense GQA"), ("jamba-v0.1-52b", "dense GQA"),
    ("qwen1.5-4b", "qkv"), ("command-r-35b", "tied embeddings")])
def test_model_refuses_ssm_hybrid_qkv_bias_and_tied_embeddings(arch, match):
    """SSM, qkv bias, tied embeddings and the hybrid (jamba: Mamba and GQA
    blocks, routed experts on every other block) are served since they
    were ported (held to the reference by
    ``tests/test_torch_dense_variants.py``, ``tests/test_torch_ssm.py`` and
    ``tests/test_torch_hybrid.py``): their full-width configs build, with
    Mamba blocks, bias leaves and no LM head of their own; jamba's smoke
    group has a Mamba block first and a GQA block second."""
    cfg = ModelConfig(**dataclasses.asdict(ref_get_config(arch)))
    model = Model(cfg, "cpu")
    params = Model(cfg.reduced(), "cpu").init(torch.Generator())
    mixer = params["layers"][0]["mixer"]
    assert ("wzx" in mixer) == (cfg.family in ("ssm", "hybrid"))
    if cfg.family == "hybrid":
        assert "wq" in params["layers"][1]["mixer"]
    assert ("bq" in mixer) == cfg.qkv_bias
    assert ("head" in params) == (not cfg.tie_embeddings)
    assert model.cfg is cfg


@pytest.mark.parametrize("n", [24, 7 * 64])
def test_random_hadamard_of_a_non_power_of_two_width(n):
    """deepseek-v3's d_model 7168 = 2^10 * 7 takes the Kronecker form
    H_{2^k} (x) Q_m; QR returns a column-major Q_m, which ``torch.kron``
    refused before the port made it contiguous.  The draw is orthogonal
    and has the reference's structure: diag(s) (H (x) Q_m)."""
    q = rotation.random_hadamard(torch.Generator().manual_seed(0), n)
    assert q.shape == (n, n)
    torch.testing.assert_close(q @ q.T, torch.eye(n), atol=1e-5, rtol=0)
    k2 = n & -n  # the power-of-two factor
    h = rotation.hadamard_matrix(k2)
    signs = torch.sign(q[:, 0] / h[:, 0].repeat_interleave(n // k2))
    qm = (signs[:, None] * q)[:n // k2, :n // k2] / h[0, 0]
    torch.testing.assert_close(signs[:, None] * q, torch.kron(h, qm),
                               atol=1e-6, rtol=0)


def test_rotated_norm_fused_mla_block_matches_reference(shared):
    cfg, params, pcfg, pparams = shared
    model = build_model(cfg)
    q = np.array(ref_rot.random_hadamard(jax.random.key(3), cfg.d_model))
    for li, (blk, meta) in enumerate(
            ((params["prefix"][0], model.prefix_metas[0]),
             (jax.tree.map(lambda a: a[0], params["groups"]["b0"]),
              model.group_metas[0]))):
        want = ref_rot.rotate_block(ref_rot.fuse_norms_block(blk, cfg), cfg,
                                    meta, jnp.asarray(q))
        got = rotation.rotate_block(rotation.fuse_norms_block(
            pparams["layers"][li], pcfg), pcfg, torch.from_numpy(q))
        for sub in ("mixer", "ffn"):
            assert set(got[sub]) == set(want[sub])
            for name, w in want[sub].items():
                _close(got[sub][name], w, 1e-5)
        for norm in ("mixer_norm", "ffn_norm"):
            np.testing.assert_array_equal(got[norm].numpy(), want[norm])


@pytest.mark.parametrize("kv_bits", [0, 8, 2])
def test_prefill_decode_and_generate_match_reference(shared, kv_bits):
    """Prefill logits of 2 x 70 tokens, 3 teacher-forced decode steps, and
    greedy ``generate`` tokens."""
    cfg, params, pcfg, pparams = shared
    model, pmodel = _models(cfg, pcfg, kv_bits)
    toks = _tokens(cfg.vocab_size, 2, 70, 2)
    forced = _tokens(cfg.vocab_size, 3, 2, 3)
    logits_r, cache_r = model.prefill(params, jnp.asarray(toks),
                                      cache_len=73)
    logits_p, cache_p = pmodel.prefill(pparams,
                                       torch.from_numpy(toks).long(),
                                       cache_len=73)
    _close(logits_p, logits_r, 1e-5)
    for i in range(3):
        tok = forced[i][:, None]
        logits_r, cache_r = model.decode_step(
            params, cache_r, jnp.asarray(tok), jnp.int32(70 + i))
        logits_p = pmodel.decode_step(pparams, cache_p,
                                      torch.from_numpy(tok).long(), 70 + i)
        _close(logits_p, logits_r, RTOL[kv_bits])
    want = ref_generate(model, params, jnp.asarray(toks[:, :40]), 8)
    got = generate(pmodel, pparams, torch.from_numpy(toks[:, :40]).long(), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kv_bits", [8, 2])
def test_paged_steps_match_reference(shared, kv_bits):
    """The engine's model steps against the reference's: a 100-token prompt
    ingested in page-aligned chunks of 64 through the paged (lossy) extend,
    every chunk's latent codes bitwise, then 2 teacher-forced paged decode
    steps of two slots (the second inactive, the table's last entry
    trash)."""
    cfg, params, pcfg, pparams = shared
    model, pmodel = _models(cfg, pcfg, kv_bits)
    toks = _tokens(cfg.vocab_size, 1, 100, 4)
    ids, t = [3, 1], 100
    ref_pools, pools = RefPagedPools(model, 4), PagedPools(pmodel, 4)
    for start in range(0, t, 64):
        n = min(64, t - start)
        past = ids[:start // 64]
        logits_r, _, cc_r = model.paged_extend_step(
            params, jnp.asarray(toks[:, start:start + n]), jnp.int32(start),
            None, t_total=t, last=start + n >= t, pools=ref_pools.pools,
            page_tbl=jnp.asarray(past, jnp.int32))
        logits_p, cc_p = pmodel.paged_extend_step(
            pparams, torch.from_numpy(toks[:, start:start + n]).long(),
            start, None, t_total=t, last=start + n >= t, pools=pools.pools,
            page_tbl=torch.tensor(past, dtype=torch.int32))
        page_ids = ids[start // 64:start // 64 + 1]
        ref_pools.write_prefill(cc_r, jnp.asarray(page_ids, jnp.int32))
        pools.write_prefill(cc_p, page_ids)
    _close(logits_p, logits_r, RTOL[kv_bits])
    ref_layers = list(ref_pools.pools["prefix"]) + [
        jax.tree.map(lambda a: a[0], ref_pools.pools["groups"]["b0"])]
    for c_p, c_r in zip(pools.pools, ref_layers):
        assert list(c_p) == ["c", "cs", "r", "rs"]
        for key, a in c_p.items():
            want = np.asarray(c_r[key])
            got = (a.float().numpy() if a.dtype == torch.bfloat16 else
                   words_to_numpy(a) if want.dtype == np.uint32 else
                   a.numpy())
            want = want.astype(got.dtype)
            if kv_bits == 2:
                np.testing.assert_array_equal(got, want)
            elif key in ("c", "r"):  # int8: a boundary code may flip once
                diff = np.abs(got.astype(np.int32) - want)
                assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
            else:  # bf16 scales of the same rows: one rounding apart
                np.testing.assert_allclose(got, want, rtol=2.0 ** -8)
    tbl = np.array([[3, 1, 0], [0, 0, 0]], np.int32)
    pos = np.array([100, 0], np.int32)
    act = np.array([True, False])
    forced = _tokens(cfg.vocab_size, 2, 2, 5)
    pp = ref_pools.pools
    for i in range(2):
        tok = forced[i][:, None]
        logits_r, pp = model.paged_decode_step(
            params, pp, jnp.asarray(tbl), jnp.asarray(tok),
            jnp.asarray(pos + i * act), jnp.asarray(act))
        logits_p = pmodel.paged_decode_step(
            pparams, pools.pools, torch.from_numpy(tbl),
            torch.from_numpy(tok).long(),
            torch.from_numpy(pos + i * act).long(), torch.from_numpy(act))
        _close(logits_p[0], logits_r[0], RTOL[kv_bits])


# ------------------------------------------- quantize, artifact, keep-packed


@pytest.fixture(scope="module")
def quantized(shared, tmp_path_factory):
    """Both pipelines (3-bit, group 128, rotation, AttnCon) on the same
    params, Q and 8 x 32 calibration tokens, and both artifacts.

    The reference pipeline rotates eagerly, and XLA's eager product of the
    narrow (64, 32) ``wq_a`` with Q rounds otherwise than its compiled
    one; the port's rotation equals the compiled one bit for bit.  So the
    reference runs on the model rotated by its compiled ``rotate_model``
    (the pipeline's own Q, ``fold_in(key(seed), 7)``), with its rotation
    step off, and the port rotates with that Q itself."""
    cfg, params, pcfg, pparams = shared
    model = build_model(cfg)
    calib = _tokens(cfg.vocab_size, 8, 32, 6)
    rotated = jax.jit(lambda p: ref_rot.rotate_model(
        p, cfg, model, jax.random.key(0))[0])(params)
    ref_pipe = RefPipeline(model, RefRSQConfig(pack_output=True, rotate=False,
                                               scheduler="sequential"))
    ref_q, _ = ref_pipe.run(rotated, jnp.asarray(calib), batch_size=4)
    ref_dir = tmp_path_factory.mktemp("ref_mla_artifact")
    ref_save_artifact(ref_dir, ref_pipe.artifact, params=ref_q)
    kd, _ = jax.random.split(jax.random.fold_in(jax.random.key(0), 7))
    rot = np.asarray(ref_rot.random_hadamard(kd, cfg.d_model))
    pmodel = Model(pcfg, "cpu")
    pipe = RSQPipeline(pmodel, RSQConfig(pack_output=True))
    port_q, _ = pipe.run(pparams, torch.from_numpy(calib).long(),
                         batch_size=4, rotation=torch.from_numpy(np.array(rot)))
    port_dir = tmp_path_factory.mktemp("port_mla_artifact")
    save_packed_artifact(port_dir, pipe.artifact, params=port_q)
    return {"model": model, "pmodel": pmodel, "ref_dir": ref_dir,
            "port_dir": port_dir, "ref_q": ref_q, "port_q": port_q}


def test_quantize_pipeline_codes_bitwise(quantized):
    ref_e, ref_meta = ref_load_artifact(quantized["ref_dir"])
    port_e, port_meta = load_packed_artifact(quantized["port_dir"])
    assert set(port_e) == set(ref_e) and len(ref_e) == 16
    for name, em in ref_meta["entries"].items():
        pem = port_meta["entries"][name]
        for key in ("loc", "path", "d_in", "group_size"):
            assert pem[key] == em[key], (name, key)
        for field in ("codes", "scale", "zero"):
            np.testing.assert_array_equal(port_e[name][field],
                                          ref_e[name][field])
    # layer 0 is the reference's prefix block, layer 1 its stacked group;
    # wkv_b (d_in 32 here) packs 3-bit codes in ragged words
    assert ref_meta["entries"]["layer0/mixer/wkv_b"]["loc"] == ["prefix", 0]
    assert ref_meta["entries"]["layer1/mixer/wkv_b"]["loc"] == \
        ["groups", 0, 0]
    assert ref_e["layer0/mixer/wkv_b"]["codes"].shape[0] == 4


def test_reference_artifact_serves_in_the_port(quantized, shared):
    """A reference-written artifact (prefix + groups locations, pickled
    treedef) loads in the port: entries bitwise, logits as the reference's
    quantized model, keep-packed greedy tokens as the reference's own
    keep-packed serve (absorb and expand on the packed wkv_b)."""
    cfg = shared[0]
    ref_dir, model, pmodel = (quantized[k] for k in ("ref_dir", "model",
                                                     "pmodel"))
    entries_r, meta_r = ref_load_artifact(ref_dir)
    params_p, _ = load_packed_forward_params(ref_dir, device="cpu")
    for name, em in meta_r["entries"].items():
        li = em["loc"][1] if em["loc"][0] == "prefix" else 1 + em["loc"][1]
        pw = params_p["layers"][li]
        for key in em["path"].split("/"):
            pw = pw[key]
        assert isinstance(pw, PackedWeight)
        np.testing.assert_array_equal(words_to_numpy(pw.w_packed),
                                      entries_r[name]["codes"])
    toks = _tokens(cfg.vocab_size, 2, 24, 7)
    _close(pmodel.logits(params_p, torch.from_numpy(toks).long()),
           model.logits(quantized["ref_q"], jnp.asarray(toks)), 1e-5)
    fwd_r, _ = ref_load_fwd(ref_dir)
    want = ref_generate(model, fwd_r, jnp.asarray(toks[:, :16]), 6)
    got = generate(pmodel, params_p, torch.from_numpy(toks[:, :16]).long(), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_artifact_reads_in_the_reference(quantized, shared):
    """A port-written artifact: the reference's reader takes its entries
    bit for bit at the reference's own locations, and the reference model
    with those entries dequantized into its tree (``dequantize_entry`` at
    each location) gives the port's logits; in the port, keep-packed and
    dequantized-at-load serving give the same tokens."""
    cfg = shared[0]
    port_dir, model, pmodel = (quantized[k] for k in ("port_dir", "model",
                                                      "pmodel"))
    entries_r, meta_r = ref_load_artifact(port_dir)
    entries_p, meta_p = load_packed_artifact(port_dir)
    assert meta_r["entries"] == meta_p["entries"]
    params = jax.tree.map(lambda a: a, quantized["ref_q"])
    params["prefix"] = [dict(b) for b in params["prefix"]]
    for name, em in meta_r["entries"].items():
        for field in ("codes", "scale", "zero"):
            np.testing.assert_array_equal(entries_r[name][field],
                                          entries_p[name][field])
        w = ref_dequantize_entry(entries_r[name], em, meta_r["spec"])
        sub, leaf = em["path"].split("/")
        if em["loc"][0] == "prefix":
            blk = params["prefix"][em["loc"][1]]
            blk[sub] = dict(blk[sub], **{leaf: w})
        else:
            grp = params["groups"]["b0"]
            stacked = grp[sub][leaf].at[em["loc"][1]].set(w)
            grp[sub] = dict(grp[sub], **{leaf: stacked})
    toks = _tokens(cfg.vocab_size, 2, 24, 8)
    packed, _ = load_packed_forward_params(port_dir, device="cpu")
    deq, _ = load_packed_params(port_dir, device="cpu")
    got = pmodel.logits(packed, torch.from_numpy(toks).long())
    _close(got, model.logits(params, jnp.asarray(toks)), 1e-5)
    for kv_bits in (0, 2):
        _, m_p = _models(cfg, ModelConfig(**dataclasses.asdict(cfg)),
                         kv_bits)
        a = generate(m_p, packed, torch.from_numpy(toks[:, :16]).long(), 6)
        b = generate(m_p, deq, torch.from_numpy(toks[:, :16]).long(), 6)
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ------------------------------------------------------- the port's engine


@pytest.fixture(scope="module", params=[8, 2], ids=["kv8", "kv2"])
def port(request, shared):
    model = Model(dataclasses.replace(shared[2], kv_bits=request.param),
                  "cpu")
    return model, shared[3]


def _engine(model, params, prompts, budgets, sps, *, chunk, attn, slots):
    engine = Engine(model, params, max_slots=slots, n_pages=16,
                    max_pages_per_request=3, burst_steps=3,
                    prefill_chunk=chunk, prefill_attn=attn)
    rids = [engine.submit(ServeRequest(tokens=p, max_new_tokens=n,
                                       sampling=sp))
            for p, n, sp in zip(prompts, budgets, sps)]
    outs = {o.request_id: o for o in engine.drain()}
    assert engine.pools.free_pages() == 16
    assert all(outs[r].status == "ok" for r in rids)
    return [outs[r].tokens for r in rids]


@pytest.mark.parametrize("mode", ["whole", "chunked-exact", "chunked-paged"])
def test_engine_bitwise(port, mode):
    """Three requests over two slots (the third waits), 130-token prompts
    (a partial last chunk of 64), one sampled: whole-prompt and exact
    chunked admission give each request its solo ``generate`` tokens;
    paged chunked admission gives each request the tokens it gets served
    alone in that mode."""
    model, params = port
    prompts = _tokens(model.cfg.vocab_size, 3, 130, 9).tolist()
    sps = [SamplingParams(), SamplingParams(),
           SamplingParams(temperature=1.3, seed=7)]
    budgets = [10, 7, 6]
    chunk, attn = {"whole": (None, "exact"),
                   "chunked-exact": (64, "exact"),
                   "chunked-paged": (64, "paged")}[mode]
    got = _engine(model, params, prompts, budgets, sps, chunk=chunk,
                  attn=attn, slots=2)
    for i in range(3):
        if attn == "exact":
            want = generate(model, params, torch.tensor([prompts[i]]),
                            budgets[i], temperature=sps[i].temperature,
                            seed=sps[i].seed)[0].tolist()
        else:
            want = _engine(model, params, prompts[i:i + 1], budgets[i:i + 1],
                           sps[i:i + 1], chunk=chunk, attn=attn, slots=1)[0]
        assert got[i] == want, i


def test_serve_engine_and_cache_bytes(port):
    """``launch.serve.serve_engine`` serves the MLA model (three requests
    on a Poisson trace, chunked), and the latent cache is smaller than its
    fp form."""
    model, params = port
    prompts = torch.from_numpy(_tokens(model.cfg.vocab_size, 3, 70, 10))
    eng, st = serve.serve_engine(model, params, prompts.long(), 5,
                                 max_slots=2, n_pages=12, prefill_chunk=64)
    assert st["statuses"] == {"ok": 3} and eng.pools.free_pages() == 12
    cache_b, fp_b = serve.kv_cache_bytes(model, 2, 75)
    assert cache_b < fp_b
