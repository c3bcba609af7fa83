"""The hybrid (jamba) slice against the reference: decoders whose layer
group holds several blocks, Mamba-2 and GQA mixers in one stack, each with
a dense or a routed-expert FFN (no shared expert).

Two configs: ``jamba-v0.1-52b-smoke`` (one group of 4: Mamba + dense, GQA
+ 4 experts, Mamba + dense, Mamba + experts) and the same at ``n_layers``
8 (two groups, so that both g > 0 and o > 0 occur in the locations
``["groups", g, o]``).  The same weights (``convert.params_from_jax``),
rotation Q and calibration tokens go through both packages, in fp32; norm
scales, A_log, D, dt_bias and conv_b are drawn away from the reference's
constant init so that every term is exercised.

Tolerances, relative to the largest reference magnitude:
  * logits, loss, rotated weights, logits of a model served from an
    artifact, prefill and fp / kv2 decode logits: 1e-5 (fp32 products
    summed in another order);
  * kv8 decode logits: 1e-4 (a K/V row reaches the int8 codec from two
    fp32 forwards that differ in the last bit, and a code on a rounding
    boundary then flips by one step, as ``tests/test_torch_moe.py``);
  * greedy tokens, quantized codes and packed entries: equal (bitwise).
Within the port the graph loop is held to the Python loop bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.packed import dequantize_entry as ref_dequantize_entry
from repro.checkpoint.packed import load_packed_artifact as ref_load_artifact
from repro.checkpoint.packed import load_packed_entry as ref_load_entry
from repro.checkpoint.packed import load_packed_forward_params as ref_load_fwd
from repro.checkpoint.packed import save_packed_artifact as ref_save_artifact
from repro.configs import get_config as ref_get_config
from repro.core import rotation as ref_rot
from repro.core.pipeline import RSQConfig as RefRSQConfig
from repro.core.pipeline import RSQPipeline as RefPipeline
from repro.launch.serve import generate as ref_generate
from repro.models import build_model
from repro.serving import Engine as RefEngine
from repro_torch.checkpoint import packed
from repro_torch.checkpoint.packed import (load_packed_artifact,
                                           load_packed_forward_params,
                                           load_packed_params,
                                           save_packed_artifact)
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import rotation
from repro_torch.core.pipeline import RSQConfig, RSQPipeline, handover
from repro_torch.kernels.quant_matmul.ops import PackedWeight
from repro_torch.launch import quantize, serve
from repro_torch.launch.serve import generate
from repro_torch.models.lm import Model, layer_loc
from repro_torch.serving import Engine
from test_torch_dense_variants import _draw

ARCH = "jamba-v0.1-52b"
RTOL = {0: 1e-5, 2: 1e-5, 8: 1e-4}  # by kv_bits, see above
CASES = {"one_group": 4, "two_groups": 8}  # n_layers of the smoke config


def _close(got, want, rtol=1e-5):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err < rtol, err


def _tokens(vocab, b, t, seed):
    return np.random.default_rng(seed).integers(2, vocab, (b, t)).astype(
        np.int32)


def _cfg(n_layers: int, kv_bits: int = 0):
    return dataclasses.replace(ref_get_config(ARCH).reduced(),
                               n_layers=n_layers, dtype="float32",
                               kv_bits=kv_bits)


def _models(cfg, kv_bits):
    cfg = dataclasses.replace(cfg, kv_bits=kv_bits)
    return build_model(cfg), Model(ModelConfig(**dataclasses.asdict(cfg)),
                                   "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These models are tiny: their thousands of small ops run faster on
    one intra-op thread a test worker than on threads that contend with
    the other workers sharing the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(CASES))
def case(request, tmp_path_factory):
    """Both models on the same params; both pipelines (3-bit, group 128,
    AttnCon) on the same 8 x 32 calibration tokens and Q (the reference's
    model rotated by its compiled ``rotate_model``, its own rotation step
    off, as ``tests/test_torch_moe.py``); both artifacts."""
    cfg = _cfg(CASES[request.param])
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
    ref_pipe = RefPipeline(model, RefRSQConfig(
        pack_output=True, rotate=False, scheduler="sequential"))
    ref_q, _ = ref_pipe.run(rotated, jnp.asarray(calib), batch_size=4)
    ref_dir = tmp_path_factory.mktemp("ref_hybrid")
    ref_save_artifact(ref_dir, ref_pipe.artifact, params=ref_q)
    pipe = RSQPipeline(pmodel, RSQConfig(pack_output=True))
    port_q, report = pipe.run(pparams, torch.from_numpy(calib).long(),
                              batch_size=4,
                              rotation=torch.from_numpy(q.copy()))
    port_dir = tmp_path_factory.mktemp("port_hybrid")
    save_packed_artifact(port_dir, pipe.artifact, params=port_q)
    return {"cfg": cfg, "model": model, "params": params, "pcfg": pcfg,
            "pmodel": pmodel, "pparams": pparams, "q": q,
            "rotated": rotated, "calib": calib, "ref_q": ref_q,
            "ref_dir": ref_dir, "port_q": port_q, "port_dir": port_dir,
            "report": report, "artifact": pipe.artifact}


# ------------------------------------------------------------ config, layout


def test_config_is_the_references_and_builds_at_full_width():
    """The port's jamba config is the reference's; at full width a group
    is 8 blocks, GQA at position 4 with a dense FFN, routed experts on the
    odd (Mamba) positions; the smoke group is 4 blocks, its GQA block at
    position 1 with routed experts."""
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_get_config(ARCH))
    assert Model(cfg, "cpu").cfg is cfg
    assert cfg.scan_period == 8
    assert cfg.layer_kinds()[:8] == ("mamba",) * 4 + ("attn",) + \
        ("mamba",) * 3
    assert cfg.ffn_kinds()[:8] == ("dense", "moe") * 4
    smoke = get_config(ARCH + "-smoke")
    assert smoke.scan_period == 4 and smoke.n_shared_experts == 0
    assert smoke.layer_kinds() == ("mamba", "attn", "mamba", "mamba")
    assert smoke.ffn_kinds() == ("dense", "moe", "dense", "moe")


@pytest.mark.parametrize("arch,period", [(ARCH, 8), (ARCH + "-smoke", 4)])
def test_partial_layer_group_is_refused(arch, period):
    """6 layers are not a whole number of groups: the model (the reference
    asserts) and the quantize CLI refuse them with the period named."""
    cfg = dataclasses.replace(get_config(arch), n_layers=6)
    with pytest.raises(ValueError, match=f"scan period {period}"):
        Model(cfg, "cpu")
    with pytest.raises(AssertionError):
        build_model(dataclasses.replace(ref_get_config(arch.removesuffix(
            "-smoke")).reduced() if arch.endswith("-smoke") else
            ref_get_config(arch), n_layers=6))
    with pytest.raises(ValueError, match=f"scan period {period}"):
        quantize.main(["--device", "cpu", "--arch", arch, "--n-layers", "6"])


def test_params_from_jax_orders_layers_group_by_group(case):
    """Layer g·P + o is block ``o`` of group ``g`` (``groups["b{o}"][g]``),
    and ``layer_loc`` gives it back as ``["groups", g, o]``; each block
    has its own mixer and FFN leaves."""
    cfg, params, pparams = case["cfg"], case["params"], case["pparams"]
    period = cfg.scan_period
    assert len(pparams["layers"]) == cfg.n_layers
    for li, blk in enumerate(pparams["layers"]):
        g, o = divmod(li, period)
        assert layer_loc(case["pcfg"], li) == ["groups", g, o]
        ref_blk = params["groups"][f"b{o}"]
        for path, w in jax.tree_util.tree_flatten_with_path(ref_blk)[0]:
            node = blk
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(node.numpy(), np.asarray(w)[g])
        assert ("wzx" in blk["mixer"]) == (cfg.layer_kinds()[li] == "mamba")
        assert ("router" in blk["ffn"]) == (cfg.ffn_kinds()[li] == "moe")
        assert "shared" not in blk["ffn"]
    own = case["pmodel"].init(torch.Generator().manual_seed(0))
    for blk, ref_blk in zip(own["layers"], pparams["layers"]):
        assert jax.tree.map(lambda a: tuple(a.shape), blk) == \
            jax.tree.map(lambda a: tuple(a.shape), ref_blk)


def test_residual_paths_sort_block_positions_as_jax():
    """A reference residual of 11 block positions: "b10" flattens before
    "b2", as JAX flattens the dict."""
    blocks = [["mixer_norm", "mixer/wq"]] * 11
    paths = packed._reference_residual_paths(0, [], blocks)
    tree = {"embed": 0, "final_norm": 0, "head": 0,
            "groups": {f"b{o}": {"mixer_norm": 0, "mixer": {"wq": 0}}
                       for o in range(11)}}
    want = ["/".join(k.key for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert paths == want
    assert paths.index("groups/b10/mixer/wq") < paths.index("groups/b2/mixer/wq")


# ------------------------------------------------------------------ forward


def test_logits_and_loss_match_reference(case):
    """Logits of 2 x 64 tokens (two 32-token SSD chunks) and the
    next-token loss."""
    cfg = case["cfg"]
    toks = _tokens(cfg.vocab_size, 2, 64, 2)
    _close(case["pmodel"].logits(case["pparams"],
                                 torch.from_numpy(toks).long()),
           case["model"].logits(case["params"], jnp.asarray(toks)))
    labels = np.roll(toks, -1, axis=1)
    want = case["model"].loss(case["params"], {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    got = case["pmodel"].loss(case["pparams"], torch.from_numpy(toks).long(),
                              torch.from_numpy(labels).long())
    _close(got, np.asarray(want))


@pytest.mark.parametrize("kv_bits", [0, 8, 2])
def test_prefill_decode_and_generate_match_reference(case, kv_bits):
    """A mixed cache: each Mamba block's state ({"conv", "ssm"}, fp32 SSM
    state, never quantized) beside the GQA blocks' K/V (fp, or codes and
    scales); prefill logits of 2 x 64 tokens (a prompt is whole SSD chunks
    or shorter than one, in both packages), 3 teacher-forced decode steps,
    and greedy ``generate`` tokens."""
    cfg, params, pparams = case["cfg"], case["params"], case["pparams"]
    model, pmodel = _models(cfg, kv_bits)
    toks = _tokens(cfg.vocab_size, 2, 64, 2)
    forced = _tokens(cfg.vocab_size, 3, 2, 3)
    logits_r, cache_r = model.prefill(params, jnp.asarray(toks),
                                      cache_len=67)
    logits_p, cache_p = pmodel.prefill(pparams, torch.from_numpy(toks).long(),
                                       cache_len=67)
    _close(logits_p, logits_r)
    attn_keys = {"k", "v"} if not kv_bits else {"k", "ks", "v", "vs"}
    for kind, entry in zip(cfg.layer_kinds(), cache_p):
        if kind == "mamba":
            assert set(entry) == {"conv", "ssm"}
            assert entry["ssm"].dtype == torch.float32
        else:
            assert set(entry) == attn_keys
    step_r = jax.jit(model.decode_step)
    for i in range(3):
        tok = forced[i][:, None]
        logits_r, cache_r = step_r(params, cache_r, jnp.asarray(tok),
                                   jnp.int32(64 + i))
        logits_p = pmodel.decode_step(pparams, cache_p,
                                      torch.from_numpy(tok).long(), 64 + i)
        _close(logits_p, logits_r, RTOL[kv_bits])
    want = ref_generate(model, params, jnp.asarray(toks[:, :32]), 8)
    got = generate(pmodel, pparams, torch.from_numpy(toks[:, :32]).long(), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_graph_loop_bitwise_python_loop(case, kv_bits):
    """The captured decode region (the prefill's Mamba states and K/V
    loaded into its static cache after the capture) gives the Python
    loop's tokens bit for bit, greedy and sampled."""
    _, pmodel = _models(case["cfg"], kv_bits)
    toks = torch.from_numpy(_tokens(case["cfg"].vocab_size, 2, 24, 4)).long()
    for temperature in (0.0, 0.9):
        got = generate(pmodel, case["pparams"], toks, 7,
                       temperature=temperature, seed=3)
        want = generate(pmodel, case["pparams"], toks, 7,
                        temperature=temperature, seed=3, loop="python")
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_rotate_model_matches_reference(case):
    """Norms fused (a Mamba block's mixer norm into wzx / wbc / wdt, its
    FFN norm into its dense FFN or its router and experts), every block
    rotated, the head Qᵀ·diag(γ)·head beside the table E·Q."""
    want = case["rotated"]
    got, _ = rotation.rotate_model(case["pparams"], case["pcfg"],
                                   torch.from_numpy(case["q"].copy()))
    _close(got["head"], want["head"])
    _close(got["embed"], want["embed"])
    period = case["cfg"].scan_period
    for li, blk in enumerate(got["layers"]):
        g, o = divmod(li, period)
        flat = jax.tree_util.tree_flatten_with_path(want["groups"][f"b{o}"])
        for path, w in flat[0]:
            node = blk
            for key in path:
                node = node[key.key]
            _close(node, np.asarray(w)[g])


# ------------------------------------------------ quantize and the artifacts


def test_quantize_pipeline_codes_bitwise(case):
    """Every packed entry bitwise the reference's, at the reference's
    locations ``["groups", g, o]``: the Mamba blocks' projections (wdt is
    8 wide here, too narrow to quantize), the GQA block's, the dense FFNs'
    and the expert stacks' (E, ·, ·)."""
    ref_e, ref_meta = ref_load_artifact(case["ref_dir"])
    port_e, port_meta = load_packed_artifact(case["port_dir"])
    assert set(port_e) == set(ref_e)
    for name, em in ref_meta["entries"].items():
        pem = port_meta["entries"][name]
        for key in ("loc", "path", "d_in", "group_size", "tag"):
            assert pem[key] == em[key], (name, key)
        for field in ("codes", "scale", "zero"):
            np.testing.assert_array_equal(port_e[name][field],
                                          ref_e[name][field])
    cfg = case["cfg"]
    locs = {tuple(em["loc"]) for em in ref_meta["entries"].values()}
    assert locs == {("groups", g, o) for g in range(cfg.n_layers // 4)
                    for o in range(4)}
    assert ref_meta["entries"]["layer1/ffn/experts/wd"]["loc"] == \
        ["groups", 0, 1]
    assert {"layer0/mixer/wzx", "layer1/mixer/wk", "layer3/ffn/experts/wi",
            "layer2/ffn/wd"} <= set(ref_e)
    assert "layer0/mixer/wdt" not in ref_e


def test_pipeline_with_handed_over_layers_is_bitwise(case):
    """Layers handed over as an iterator (``handover``, as the quantize CLI
    does) give the same quantized params and artifact bit for bit as a
    kept list, and the handed-over list is emptied."""
    pipe = RSQPipeline(case["pmodel"], RSQConfig(pack_output=True))
    layers = list(case["pparams"]["layers"])
    params = dict(case["pparams"], layers=handover(layers))
    got, _ = pipe.run(params, torch.from_numpy(case["calib"]).long(),
                      batch_size=4, rotation=torch.from_numpy(case["q"].copy()))
    assert layers == []
    assert len(case["pparams"]["layers"]) == case["cfg"].n_layers
    want = packed._flatten(case["port_q"])
    flat = packed._flatten(got)
    assert set(flat) == set(want)
    for path, w in want.items():
        assert torch.equal(flat[path], w), path
    for name, entry in case["artifact"]["entries"].items():
        for field, v in entry.items():
            assert torch.equal(pipe.artifact["entries"][name][field], v)


def test_load_packed_entry_reads_one_entry(case):
    """``load_packed_entry`` reads one entry's fields as the whole-artifact
    reader does, and as the reference's ``load_packed_entry``, from either
    package's artifact."""
    for d in (case["ref_dir"], case["port_dir"]):
        entries, meta = load_packed_artifact(d)
        for name in ("layer0/mixer/wbc", "layer1/ffn/experts/wd"):
            got = packed.load_packed_entry(d, name, verify=True)
            want = ref_load_entry(d, name)
            for field in ("codes", "scale", "zero"):
                np.testing.assert_array_equal(got[field],
                                              entries[name][field])
                np.testing.assert_array_equal(got[field], want[field])


def test_reference_artifact_serves_in_the_port(case):
    """A reference-written hybrid artifact (each block position with its
    own residual leaves: a Mamba block's fp leaves and FFN norm, the
    experts' fp32 router) loads in the port: packed weights bitwise at
    layer g·P + o, logits as the reference's quantized model, keep-packed
    greedy tokens as the reference's own keep-packed serve."""
    cfg, model, pmodel = case["cfg"], case["model"], case["pmodel"]
    entries_r, meta_r = ref_load_artifact(case["ref_dir"])
    params_p, _ = load_packed_forward_params(case["ref_dir"], device="cpu")
    for name, em in meta_r["entries"].items():
        _, g, o = em["loc"]
        pw = params_p["layers"][g * cfg.scan_period + o]
        for key in em["path"].split("/"):
            pw = pw[key]
        assert isinstance(pw, PackedWeight)
        np.testing.assert_array_equal(packed.words_to_numpy(pw.w_packed),
                                      entries_r[name]["codes"])
    for li, blk in enumerate(params_p["layers"]):
        g, o = divmod(li, cfg.scan_period)
        ref_blk = case["ref_q"]["groups"][f"b{o}"]
        np.testing.assert_array_equal(blk["ffn_norm"].numpy(),
                                      np.asarray(ref_blk["ffn_norm"][g]))
        if "router" in blk["ffn"]:
            np.testing.assert_array_equal(
                blk["ffn"]["router"].numpy(),
                np.asarray(ref_blk["ffn"]["router"][g]))
        if "A_log" in blk["mixer"]:
            np.testing.assert_array_equal(
                blk["mixer"]["A_log"].numpy(),
                np.asarray(ref_blk["mixer"]["A_log"][g]))
    toks = _tokens(cfg.vocab_size, 2, 32, 7)
    _close(pmodel.logits(params_p, torch.from_numpy(toks).long()),
           model.logits(case["ref_q"], jnp.asarray(toks)))
    fwd_r, _ = ref_load_fwd(case["ref_dir"])
    want = ref_generate(model, fwd_r, jnp.asarray(toks[:, :16]), 6)
    got = generate(pmodel, params_p, torch.from_numpy(toks[:, :16]).long(), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_artifact_reads_in_the_reference(case):
    """A port-written hybrid artifact: the reference's reader takes its
    entries and locations ``["groups", g, o]`` bit for bit, and the
    reference model with them dequantized into ``groups["b{o}"][g]``
    gives the port's logits."""
    cfg, model, pmodel = case["cfg"], case["model"], case["pmodel"]
    entries_r, meta_r = ref_load_artifact(case["port_dir"])
    entries_p, meta_p = load_packed_artifact(case["port_dir"])
    assert meta_r["entries"] == meta_p["entries"]
    params = jax.tree.map(lambda a: a, case["ref_q"])
    for name, em in meta_r["entries"].items():
        for field in ("codes", "scale", "zero"):
            np.testing.assert_array_equal(entries_r[name][field],
                                          entries_p[name][field])
        _, g, o = em["loc"]
        w = ref_dequantize_entry(entries_r[name], em, meta_r["spec"])
        parts = em["path"].split("/")
        node = params["groups"][f"b{o}"]
        for key in parts[:-1]:
            node = node[key]
        node[parts[-1]] = node[parts[-1]].at[g].set(w)
    toks = _tokens(cfg.vocab_size, 2, 24, 8)
    got = pmodel.logits(load_packed_forward_params(
        case["port_dir"], device="cpu")[0], torch.from_numpy(toks).long())
    _close(got, model.logits(params, jnp.asarray(toks)))


@pytest.mark.parametrize("kv_bits", [0, 8, 2])
def test_port_artifact_keep_packed_equals_dequantized(case, kv_bits):
    """The port's own artifact: keep-packed and load-time dequantized
    serving give the same greedy tokens, in both loops."""
    _, pmodel = _models(case["cfg"], kv_bits)
    toks = torch.from_numpy(_tokens(case["cfg"].vocab_size, 2, 16, 9)).long()
    keep, _ = load_packed_forward_params(case["port_dir"], device="cpu")
    deq, _ = load_packed_params(case["port_dir"], device="cpu")
    a = generate(pmodel, keep, toks, 6)
    np.testing.assert_array_equal(a.numpy(),
                                  generate(pmodel, deq, toks, 6).numpy())
    np.testing.assert_array_equal(
        a.numpy(), generate(pmodel, keep, toks, 6, loop="python").numpy())


# ------------------------------------------------------------ serving paths


def test_engine_and_chunked_prefill_refuse_the_hybrid():
    """Mamba state is per slot, not per page: the port's engine refuses a
    hybrid as the reference's does, and so do the chunked prefill and the
    serve CLI's engine mode."""
    cfg = _cfg(4, kv_bits=8)
    model, pmodel = _models(cfg, 8)
    with pytest.raises(ValueError, match="launch.serve.generate"):
        RefEngine(model, jax.jit(model.init)(jax.random.key(0)), n_pages=4)
    params = pmodel.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="launch.serve.generate"):
        Engine(pmodel, params, n_pages=4)
    with pytest.raises(NotImplementedError, match="got 'mamba'"):
        pmodel.init_ingest(64)
    with pytest.raises(ValueError, match="launch.serve.generate"):
        serve.main(["--device", "cpu", "--arch", ARCH + "-smoke",
                    "--kv-bits", "8", "--mode", "engine",
                    "--prefill-chunk", "64"])


@pytest.mark.parametrize("kv_bits", [0, 8, 2])
def test_kv_cache_bytes_counts_each_layer_kind(kv_bits):
    """Each Mamba layer's state plus each GQA layer's K/V, fp or codes:
    what ``init_cache`` allocates, in bf16."""
    cfg = dataclasses.replace(get_config(ARCH + "-smoke"), n_layers=8,
                              kv_bits=kv_bits, dtype="bfloat16")
    model = Model(cfg, "cpu")

    def allocated(m):
        return sum(a.numel() * a.element_size()
                   for c in m.init_cache(3, 70) for a in c.values())

    fp = Model(dataclasses.replace(cfg, kv_bits=0), "cpu")
    assert serve.kv_cache_bytes(model, 3, 70) == (allocated(model),
                                                  allocated(fp))


def test_quantize_serve_cli_round_trip(tmp_path):
    """The CLIs on the CPU: quantize ``jamba-v0.1-52b-smoke`` at 8 layers
    (two groups) into an artifact, then serve it keep-packed and
    dequantized, fp cache and kv8: the same tokens."""
    art = tmp_path / "art"
    common = ["--device", "cpu", "--arch", ARCH + "-smoke", "--n-layers", "8"]
    q = quantize.main(common + ["--n-calib", "8", "--calib-seq", "64",
                                "--batch", "4", "--pack-out", str(art)])
    assert q["summary"]["n_weights"] == len(load_packed_artifact(art)[0])
    assert np.isfinite(q["summary"]["ppl_ratio"])
    args = common + ["--packed", str(art), "--batch", "2", "--prompt-len",
                     "16", "--gen", "5"]
    for kv in ("0", "8"):
        keep = serve.main(args + ["--kv-bits", kv])
        deq = serve.main(args + ["--kv-bits", kv, "--no-keep-packed"])
        assert keep["mode"] == "keep-packed" and deq["mode"] == "dequantized"
        assert keep["tokens"] == deq["tokens"]
        assert keep["kv_cache_bytes"] > 0
