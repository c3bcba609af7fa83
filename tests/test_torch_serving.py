"""The port's quantized-KV serving path: the model's flat, paged and
chunked-prefill steps against the reference on shared weights, and the
port's own engine against its own solo ``generate``.

Against the reference (``convert.params_from_jax``, llama3-8b-smoke in
fp32, token streams from numpy and teacher-forced on both sides): logits
agree within 1e-5 of the largest magnitude for kv2 — fp32 throughout, sums
in another order — and within 1e-4 for kv8.  The codecs are bitwise
(``test_torch_kv_cache``), but K and V reach them from two fp32 forwards
that differ in the last bit, and an int8 code whose input lies on a
rounding boundary then flips by one step (1/127 of its row's amax): here
one of the 17,920 codes of the kv8 prefill, which moves later logits
by up to 6e-5.  The 2-bit levels are four times coarser and rarely sit on a
boundary.

Within the port the contract is bitwise: every request the ``Engine``
serves (queued behind fewer slots, greedy or sampled, whole-prompt or
exact chunked admission) gets the tokens that ``launch.serve.generate``
gives its prompt alone, and exact chunked prefill reproduces the
whole-prompt prefill's logits and codes.  The sampling stream is the
port's own (it cannot match ``jax.random``), so the engine is held to the
port's ``generate``, as the reference's engine is held to its own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model
from repro.serving import PagedPools as RefPagedPools
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.launch.serve import generate
from repro_torch.models import attention as att
from repro_torch.models.lm import Model
from repro_torch.serving import (Engine, PageAccountingError,
                                 PageAllocatorExhausted, PagedPools,
                                 SamplingParams, ServeRequest, poisson_trace,
                                 run_trace)
from repro_torch.serving.sampling import gumbel_noise, sample_tokens

RTOL = {2: 1e-5, 8: 1e-4}  # by kv_bits, see above


def _close(got, want, rtol):
    got = got.numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err < rtol, err


@pytest.fixture(scope="module", params=[8, 2], ids=["kv8", "kv2"])
def pair(request, tiny_cfg, tiny_model_params):
    """(ref model, ref params, port model, port params) with a quantized
    cache of ``kv_bits``, on the same weights."""
    _, params = tiny_model_params
    cfg = dataclasses.replace(tiny_cfg, kv_bits=request.param)
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    pparams = params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                              device="cpu")
    return build_model(cfg), params, Model(pcfg, "cpu"), pparams


def _tokens(vocab, b, t, seed):
    return np.random.default_rng(seed).integers(2, vocab, (b, t)).astype(
        np.int32)


def test_decode_step_matches_reference(pair):
    """Prefill 2 x 70 tokens into a flat quantized cache (128 rows), then
    6 teacher-forced decode steps at positions 70..75."""
    model, params, pmodel, pparams = pair
    toks = _tokens(model.cfg.vocab_size, 2, 70, 0)
    forced = _tokens(model.cfg.vocab_size, 6, 2, 1)
    logits_r, cache_r = model.prefill(params, jnp.asarray(toks),
                                      cache_len=76)
    logits_p, cache_p = pmodel.prefill(pparams, torch.from_numpy(toks).long(),
                                       cache_len=76)
    _close(logits_p, logits_r, RTOL[2])  # prefill attends in fp
    for i in range(6):
        tok = forced[i][:, None]
        logits_r, cache_r = model.decode_step(params, cache_r,
                                              jnp.asarray(tok),
                                              jnp.int32(70 + i))
        logits_p = pmodel.decode_step(pparams, cache_p,
                                      torch.from_numpy(tok).long(), 70 + i)
        _close(logits_p, logits_r, RTOL[model.cfg.kv_bits])


def test_paged_decode_step_matches_reference(pair):
    """Two slots at different positions (63 -> crosses into a fresh page,
    100) on prompts written into pages 3, 5 / 2, 4; the table's last entry
    is trash; 4 teacher-forced steps."""
    model, params, pmodel, pparams = pair
    vocab = model.cfg.vocab_size
    prompts = [_tokens(vocab, 1, 63, 2), _tokens(vocab, 1, 100, 3)]
    tbl = np.array([[3, 5, 0], [2, 4, 0]], np.int32)
    ref_pools, pools = RefPagedPools(model, 6), PagedPools(pmodel, 6)
    for i, pr in enumerate(prompts):
        n_pp = -(-pr.shape[1] // 64)
        _, c_r = model.prefill(params, jnp.asarray(pr))
        ref_pools.write_prefill(c_r, jnp.asarray(tbl[i, :n_pp]))
        _, c_p = pmodel.prefill(pparams, torch.from_numpy(pr).long())
        pools.write_prefill(c_p, tbl[i, :n_pp].tolist())
    pos = np.array([63, 100], np.int32)
    act = np.array([True, True])
    forced = _tokens(vocab, 4, 2, 4)
    pp = ref_pools.pools
    for i in range(4):
        tok = forced[i][:, None]
        logits_r, pp = model.paged_decode_step(
            params, pp, jnp.asarray(tbl), jnp.asarray(tok),
            jnp.asarray(pos + i), jnp.asarray(act))
        logits_p = pmodel.paged_decode_step(
            pparams, pools.pools, torch.from_numpy(tbl),
            torch.from_numpy(tok).long(), torch.from_numpy(pos + i).long(),
            torch.from_numpy(act))
        _close(logits_p, logits_r, RTOL[model.cfg.kv_bits])


@pytest.mark.parametrize("mode", ["exact", "paged"])
def test_paged_extend_step_matches_reference(pair, mode):
    """A 150-token prompt ingested in page-aligned chunks of 64 (the last
    one partial); the final chunk's logits and every chunk's codes."""
    model, params, pmodel, pparams = pair
    toks = _tokens(model.cfg.vocab_size, 1, 150, 5)
    t = toks.shape[1]
    ids = [4, 1, 3]
    ref_pools, pools = RefPagedPools(model, 4), PagedPools(pmodel, 4)
    state_r = model.init_ingest(t) if mode == "exact" else None
    state_p = pmodel.init_ingest(t) if mode == "exact" else None
    for start in range(0, t, 64):
        n = min(64, t - start)
        last = start + n >= t
        chunk = toks[:, start:start + n]
        past = ids[:start // 64]
        logits_r, state_r, cc_r = model.paged_extend_step(
            params, jnp.asarray(chunk), jnp.int32(start), state_r,
            t_total=t, last=last, pools=ref_pools.pools,
            page_tbl=jnp.asarray(past, jnp.int32))
        logits_p, cc_p = pmodel.paged_extend_step(
            pparams, torch.from_numpy(chunk).long(), start, state_p,
            t_total=t, last=last, pools=pools.pools,
            page_tbl=torch.tensor(past, dtype=torch.int32))
        page_ids = ids[start // 64:start // 64 + 1]
        ref_pools.write_prefill(cc_r, jnp.asarray(page_ids, jnp.int32))
        pools.write_prefill(cc_p, page_ids)
    _close(logits_p, logits_r, RTOL[model.cfg.kv_bits])
    for layer, c in enumerate(pools.pools):
        for key, a in c.items():
            want = np.asarray(ref_pools.pools["groups"]["b0"][key][layer])
            got = a.float().numpy() if a.dtype == torch.bfloat16 else \
                a.numpy().view(np.uint32) if want.dtype == np.uint32 else \
                a.numpy()
            np.testing.assert_array_equal(got, want.astype(got.dtype))


# --------------------------------------------------- the port's own engine


@pytest.fixture(scope="module", params=[8, 2], ids=["kv8", "kv2"])
def port(request, tiny_cfg):
    cfg = dataclasses.replace(ModelConfig(**dataclasses.asdict(tiny_cfg)),
                              kv_bits=request.param)
    model = Model(cfg, "cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _solo(model, params, prompt, n_gen, sp):
    return generate(model, params, torch.tensor([prompt]), n_gen,
                    temperature=sp.temperature, seed=sp.seed)[0].tolist()


@pytest.mark.parametrize("chunk", [None, 64], ids=["whole", "chunked"])
def test_engine_bit_identical_to_solo_generate(port, chunk):
    """Three requests over two slots (the third waits for a retirement),
    130-token prompts (3 pages, a partial last chunk), budgets that cross
    into the third page, one sampled request: every request's tokens are
    its solo batch-1 ``generate`` stream, and every page comes back."""
    model, params = port
    prompts = _tokens(model.cfg.vocab_size, 3, 130, 6).tolist()
    sps = [SamplingParams(), SamplingParams(),
           SamplingParams(temperature=1.3, seed=7)]
    budgets = [12, 9, 7]
    expected = [_solo(model, params, prompts[i], budgets[i], sps[i])
                for i in range(3)]
    engine = Engine(model, params, max_slots=2, n_pages=16,
                    max_pages_per_request=3, burst_steps=4,
                    prefill_chunk=chunk)
    rids = [engine.submit(ServeRequest(tokens=prompts[i],
                                       max_new_tokens=budgets[i],
                                       sampling=sps[i])) for i in range(3)]
    outs = {o.request_id: o for o in engine.drain()}
    assert sorted(outs) == rids
    for i, rid in enumerate(rids):
        assert outs[rid].tokens == expected[i], i
        assert outs[rid].status == "ok" and outs[rid].prompt_len == 130
        assert outs[rid].ttft <= outs[rid].latency
    assert engine.pools.free_pages() == 16


def test_engine_paged_prefill_serves_every_request(port):
    """The paged chunked prefill reads earlier chunks back from their
    quantized pages (lossy): every request still finishes with its full
    budget and every page comes back."""
    model, params = port
    prompts = _tokens(model.cfg.vocab_size, 3, 150, 7).tolist()
    engine = Engine(model, params, max_slots=2, n_pages=12,
                    max_pages_per_request=3, burst_steps=3,
                    prefill_chunk=64, prefill_attn="paged")
    for p in prompts:
        engine.submit(ServeRequest(tokens=p, max_new_tokens=10))
    outs = engine.drain()
    assert len(outs) == 3
    assert all(o.status == "ok" and len(o.tokens) == 10 for o in outs)
    assert engine.pools.free_pages() == 12


def test_exact_chunked_prefill_equals_whole_prompt_bitwise(port):
    model, params = port
    toks = torch.from_numpy(_tokens(model.cfg.vocab_size, 1, 150, 8)).long()
    t = toks.shape[1]
    logits_w, cache_w = model.prefill(params, toks, cache_len=t)
    state = model.init_ingest(t)
    chunks = []
    for start in range(0, t, 64):
        n = min(64, t - start)
        logits_c, cc = model.paged_extend_step(
            params, toks[:, start:start + n], start, state, t_total=t,
            last=start + n >= t)
        chunks.append(cc)
    assert torch.equal(logits_c, logits_w)
    for layer, c in enumerate(cache_w):
        for key, a in c.items():
            got = torch.cat([cc[layer][key] for cc in chunks], 1)
            assert torch.equal(got[:, :a.shape[1]], a), (layer, key)


def test_engine_eos_early_stop(port):
    model, params = port
    prompts = _tokens(model.cfg.vocab_size, 2, 20, 9).tolist()
    full = _solo(model, params, prompts[0], 10, SamplingParams())
    eos = full[4]
    cut = full.index(eos) + 1
    engine = Engine(model, params, max_slots=2, n_pages=8,
                    max_pages_per_request=1, burst_steps=3)
    r0 = engine.submit(ServeRequest(tokens=prompts[0], max_new_tokens=10,
                                    sampling=SamplingParams(eos_token=eos)))
    r1 = engine.submit(ServeRequest(tokens=prompts[1], max_new_tokens=10))
    outs = {o.request_id: o for o in engine.drain()}
    assert outs[r0].tokens == full[:cut]
    assert outs[r1].tokens == _solo(model, params, prompts[1], 10,
                                    SamplingParams())


def test_pages_reused_lifo_and_accounting_errors(port):
    model, params = port
    pools = PagedPools(model, 8)
    a = pools.alloc(3)
    assert pools.free_pages() == 5 and 0 not in a
    pools.release(a)
    assert pools.alloc(3) == a  # freshly released pages are reused first
    with pytest.raises(PageAccountingError, match="trash"):
        pools.release([0])
    pools.release(a)
    with pytest.raises(PageAccountingError, match="double free"):
        pools.release(a[:1])
    b = pools.alloc(2)
    with pytest.raises(PageAccountingError, match="leak"):
        pools.assert_quiescent()
    pools.release(b)
    pools.assert_quiescent()
    with pytest.raises(PageAllocatorExhausted, match="need 9 pages"):
        pools.alloc(9)
    # a second wave decodes on the pages the first wave dirtied
    prompts = _tokens(model.cfg.vocab_size, 4, 12, 10).tolist()
    engine = Engine(model, params, max_slots=2, n_pages=2,
                    max_pages_per_request=1, burst_steps=2)
    for p in prompts:
        engine.submit(ServeRequest(tokens=p, max_new_tokens=5))
    outs = sorted(engine.drain(), key=lambda o: o.request_id)
    for p, o in zip(prompts, outs):
        assert o.tokens == _solo(model, params, p, 5, SamplingParams())


def test_submit_fails_fast_with_sizing(port):
    model, params = port
    engine = Engine(model, params, max_slots=2, n_pages=2,
                    max_pages_per_request=4)
    with pytest.raises(PageAllocatorExhausted, match="can never fit"):
        engine.submit(ServeRequest(tokens=[1] * 150, max_new_tokens=20))
    with pytest.raises(ValueError, match="page table holds 4"):
        engine.submit(ServeRequest(tokens=[1] * 300, max_new_tokens=20))
    with pytest.raises(ValueError, match="quantized"):
        PagedPools(Model(dataclasses.replace(model.cfg, kv_bits=0), "cpu"), 4)


def test_serving_never_materializes_fp_cache(port, monkeypatch):
    """generate and the engine in all three admission modes, with the
    fp materializers of the cache counting their calls: none."""
    calls = []

    def wrap(tag, fn):
        return lambda *a, **k: (calls.append(tag), fn(*a, **k))[1]

    monkeypatch.setattr(att, "kv_dequantize",
                        wrap("kv_dequantize", att.kv_dequantize))
    monkeypatch.setattr(att, "kv_log_decode",
                        wrap("kv_log_decode", att.kv_log_decode))
    model, params = port
    prompts = torch.from_numpy(_tokens(model.cfg.vocab_size, 2, 100, 11))
    assert generate(model, params, prompts.long(), 5).shape == (2, 5)
    for chunk, attn in ((None, "exact"), (64, "exact"), (64, "paged")):
        _, stats = serve.serve_engine(model, params, prompts, 5,
                                      prefill_chunk=chunk, prefill_attn=attn)
        assert stats["statuses"] == {"ok": 2}
    assert calls == []


def test_poisson_trace_and_run_trace(port):
    model, params = port
    reqs = [ServeRequest(tokens=p, max_new_tokens=n) for p, n in zip(
        _tokens(model.cfg.vocab_size, 5, 30, 12).tolist(), (3, 8, 5, 2, 6))]
    trace = poisson_trace(reqs, rate=0.7, seed=1)
    assert [e.step for e in trace] == sorted(e.step for e in trace)
    engine = Engine(model, params, max_slots=2, n_pages=8,
                    max_pages_per_request=1, burst_steps=2)
    stats = run_trace(engine, trace)
    assert stats["n_requests"] == 5 and stats["statuses"] == {"ok": 5}
    assert stats["n_tokens"] == 3 + 8 + 5 + 2 + 6
    assert 0 <= stats["ttft_p50_s"] <= stats["ttft_p99_s"]
    assert stats["ttft_p99_s"] <= stats["p99_latency_s"]
    assert stats["sustained_tok_s"] > 0


def test_sampling_stream_is_stateless():
    seeds = torch.tensor([0, 0, 7])
    index = torch.tensor([3, 4, 3])
    g = gumbel_noise(seeds, index, 4096)
    again = gumbel_noise(seeds[[2, 0]], index[[2, 0]], 4096)
    assert torch.equal(g[[2, 0]], again)  # a row depends on (seed, j) only
    assert not torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    # standard Gumbel: mean = Euler's constant, var = pi^2 / 6
    assert abs(float(g.mean()) - 0.5772) < 0.03
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.1
    logits = torch.randn((3, 4096), generator=torch.Generator().manual_seed(0))
    temp = torch.tensor([0.0, 1.0, 0.5])
    tok = sample_tokens(logits, temp, seeds, index)
    assert int(tok[0]) == int(logits[0].argmax())
    assert torch.equal(tok, sample_tokens(logits, temp, seeds, index))
    assert int(tok[1]) == int((logits[1] + g[1]).argmax())


@pytest.mark.parametrize("kv_bits,overload,loop", [
    pytest.param(8, False, None, id="8"), pytest.param(2, False, None, id="2"),
    pytest.param(8, True, None, id="8-overload"),
    pytest.param(8, False, "python", id="8-loop-python"),
    pytest.param(2, False, "graph", id="2-loop-graph")])
def test_serve_cli_on_cpu(kv_bits, overload, loop):
    """The batch and engine modes of the CLI; with ``overload`` the engine
    runs whole-prompt admission again with a bounded queue, a deadline and
    a burst failure injected at round 2 (retried): every request finishes
    with the same tokens.  ``--loop`` (default ``graph``) names the decode
    loop in the JSON line, with ``captures`` and ``capture_s`` (none on
    the CPU); with ``--loop python`` both modes give the tokens of the
    default loop."""
    common = ["--device", "cpu", "--kv-bits", str(kv_bits), "--batch", "3",
              "--prompt-len", "70", "--gen", "6"]
    flags = [] if loop is None else ["--loop", loop]
    out = serve.main(common + flags)
    assert np.asarray(out["tokens"]).shape == (3, 6)
    assert out["kv_cache_bytes"] < out["kv_cache_fp_bytes"] / (
        1.5 if kv_bits == 8 else 5)
    assert out["loop"] == (loop or "graph")
    assert out["captures"] == 0 and out["capture_s"] == 0.0
    engine = common + ["--mode", "engine", "--temperature", "0.7"]
    eng = serve.main(engine + ["--prefill-chunk", "64"] + flags)
    assert eng["statuses"] == {"ok": 3} and eng["free_pages"] == 64
    assert all(len(t) == 6 for t in eng["tokens"].values())
    assert eng["loop"] == (loop or "graph") and eng["captures"] == 0
    if loop == "python":
        assert serve.main(common)["tokens"] == out["tokens"]
        assert serve.main(engine + ["--prefill-chunk", "64"])["tokens"] == \
            eng["tokens"]
    if overload:
        plain = serve.main(engine)
        over = serve.main(engine + ["--queue-depth", "2", "--fail-at-round",
                                    "2:burst", "--deadline-s", "600"])
        assert over["n_requests"] == 3 and over["statuses"] == {"ok": 3}
        assert over["events"] == {"burst_retry": 1} and plain["events"] == {}
        assert over["tokens"] == plain["tokens"] == eng["tokens"]
        assert over["free_pages"] == 64


@pytest.mark.parametrize("kv_bits", [0, 8, 2])
@pytest.mark.parametrize("cache_len", [70, 128])
def test_kv_cache_bytes_is_the_layout_of_init_cache(kv_bits, cache_len):
    """The byte count comes from the codec's layout, with no tensor made;
    it must equal what ``init_cache`` allocates, and the fp figure what an
    activation-dtype cache of the same batch and length holds."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("llama3-8b-smoke"), kv_bits=kv_bits,
                              dtype="bfloat16")
    model = Model(cfg, device="cpu")
    fp_model = Model(dataclasses.replace(cfg, kv_bits=0), device="cpu")

    def allocated(m):
        return sum(a.numel() * a.element_size()
                   for c in m.init_cache(3, cache_len) for a in c.values())

    assert serve.kv_cache_bytes(model, 3, cache_len) == (
        allocated(model), allocated(fp_model))


@pytest.mark.parametrize("kv_bits", [0, 8, 2])
@pytest.mark.parametrize("cache_len", [70, 128])
def test_kv_cache_bytes_is_the_layout_of_init_cache_mla(kv_bits, cache_len):
    """The same for MLA's latent cache: per token and layer kv_lora_rank +
    qk_rope_dim values (their codes and scales), no head axis."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("deepseek-v3-671b-smoke"),
                              kv_bits=kv_bits, dtype="bfloat16",
                              n_routed_experts=0, n_shared_experts=0,
                              moe_top_k=0, moe_d_ff=0)
    model = Model(cfg, device="cpu")
    fp_model = Model(dataclasses.replace(cfg, kv_bits=0), device="cpu")

    def allocated(m):
        return sum(a.numel() * a.element_size()
                   for c in m.init_cache(3, cache_len) for a in c.values())

    assert serve.kv_cache_bytes(model, 3, cache_len) == (
        allocated(model), allocated(fp_model))
    assert serve.kv_cache_bytes(fp_model, 3, cache_len)[0] == (
        cfg.n_layers * 3 * cache_len
        * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2)
