"""The captured decode loops (``runtime.graphs``) on the CPU.

The CPU has no CUDA graphs, so there ``loop="graph"`` runs the same region
over the same static buffers without a capture: these tests reach every
line but the capture, which ``tests/test_torch_cuda.py`` runs on the card.

* A decode step given its position as a device tensor (what a captured
  loop passes) writes the same cache bytes and gives the same logits as
  the same step given an int, bit for bit: GQA and MLA, kv 0 / 8 / 2, kv2
  across a scale-chunk boundary.
* ``generate(loop="graph")`` gives ``loop="python"``'s tokens bit for bit,
  greedy and sampled; its greedy tokens are the reference's ``generate``
  (``loop="scan"``, the default) on shared weights.
* ``Engine(loop="graph")`` gives ``loop="python"``'s streams bit for bit:
  whole and chunked admission, under overload with preemption and replay,
  and through a retried burst.
* ``Replay``'s launch-count bookkeeping, through a stand-in capture that
  counts its replays: neither the warm-up nor the capture counts, each
  replay adds the capture's launches, and an error in the capture leaves
  ``run`` with the counts as they were.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.serve import generate as ref_generate
from repro.models import build_model
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.kernels import counted
from repro_torch.kernels.quant_matmul.ops import quant_matmul
from repro_torch.launch.serve import generate
from repro_torch.models.lm import Model
from repro_torch.runtime import graphs
from repro_torch.runtime.fault import FaultPlan, RetryPolicy
from repro_torch.serving import (Engine, SamplingParams, ServeRequest,
                                 poisson_trace, run_trace)

EXPERT_FREE = dict(n_routed_experts=0, n_shared_experts=0, moe_top_k=0,
                   moe_d_ff=0)
_MODELS: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of tiny ops: one intra-op thread keeps them from
    contending with the other test workers' threads (results are bitwise
    within the port either way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_cfg(kind: str):
    if kind == "gqa":
        return dataclasses.replace(ref_get_config("llama3-8b").reduced(),
                                   n_layers=2, d_model=64, vocab_size=256,
                                   dtype="float32")
    return dataclasses.replace(ref_get_config("deepseek-v3-671b").reduced(),
                               dtype="float32", **EXPERT_FREE)


def _port(kind: str, kv_bits: int):
    """(model, params) of the port on the CPU in fp32 with a ``kv_bits``
    cache: llama3-8b's tiny GQA config or deepseek-v3's reduced,
    expert-free MLA config, params from a seed."""
    key = (kind, kv_bits)
    if key not in _MODELS:
        cfg = ModelConfig(**dataclasses.asdict(dataclasses.replace(
            _ref_cfg(kind), kv_bits=kv_bits)))
        model = Model(cfg, "cpu")
        _MODELS[key] = model, model.init(torch.Generator().manual_seed(0))
    return _MODELS[key]


def _prompts(vocab: int, b: int, t: int, seed: int = 2) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(2, vocab, (b, t)))


# ------------------------------------------------------ the tensor position
@pytest.mark.parametrize("kind", ["gqa", "mla"])
@pytest.mark.parametrize("kv_bits", [0, 8, 2])
def test_tensor_position_decode_step_is_the_int_form(kind, kv_bits):
    """Decode steps at positions 60..67 (kv2's scale chunk of 64 is stamped
    anew at 64) from one prefill: the int position, a (1,) tensor and a
    0-d tensor give the same logits and the same cache bytes."""
    model, params = _port(kind, kv_bits)
    prompts = _prompts(model.cfg.vocab_size, 2, 60)
    _, cache = model.prefill(params, prompts, cache_len=68)
    caches = [[{k: a.clone() for k, a in c.items()} for c in cache]
              for _ in range(3)]
    toks = _prompts(model.cfg.vocab_size, 8, 2, seed=3)
    for i in range(8):
        tok = toks[i][:, None]
        pos = 60 + i
        want = model.decode_step(params, caches[0], tok, pos)
        for cc, p in zip(caches[1:], (torch.tensor([pos]),
                                      torch.tensor(pos))):
            got = model.decode_step(params, cc, tok, p)
            assert torch.equal(got, want)
            for c_got, c_want in zip(cc, caches[0]):
                for key in c_want:
                    assert torch.equal(c_got[key], c_want[key]), (i, key)


# ----------------------------------------------------------------- generate
@pytest.mark.parametrize("kind,kv_bits", [("gqa", 0), ("gqa", 8), ("gqa", 2),
                                          ("mla", 8)])
def test_generate_graph_loop_is_the_python_loop(kind, kv_bits):
    """Greedy and sampled, over a decode that crosses position 64; a second
    call reuses the first's region and static buffers."""
    model, params = _port(kind, kv_bits)
    prompts = _prompts(model.cfg.vocab_size, 2, 60)
    for temperature in (0.0, 1.3):
        python = generate(model, params, prompts, 9, temperature=temperature,
                          seed=5, loop="python")
        for _ in range(2):
            st: dict = {}
            graph = generate(model, params, prompts, 9,
                             temperature=temperature, seed=5, stats=st)
            assert torch.equal(graph, python)
            assert st["capture_s"] == 0.0  # the CPU captures nothing
    keys = [k[1:] for k in model.graphs]
    assert sorted(keys) == [(2, 60, 9, False), (2, 60, 9, True)]


def test_generate_rejects_an_unknown_loop():
    model, params = _port("gqa", 8)
    with pytest.raises(ValueError, match="loop"):
        generate(model, params, _prompts(256, 1, 8), 3, loop="scan")


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_generate_graph_greedy_matches_reference_scan(kv_bits):
    """The port's graph loop and the reference's fused scan loop on the
    same weights: the same greedy tokens."""
    cfg = dataclasses.replace(_ref_cfg("gqa"), kv_bits=kv_bits)
    ref_model = build_model(cfg)
    ref_params = jax.jit(ref_model.init)(jax.random.key(0))
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    model = Model(pcfg, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), pcfg,
                             device="cpu")
    prompts = _prompts(cfg.vocab_size, 2, 40, seed=4)
    want = ref_generate(ref_model, ref_params,
                        jnp.asarray(prompts.numpy().astype(np.int32)), 8,
                        loop="scan")
    got = generate(model, params, prompts, 8, loop="graph")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------- engine
def _engine_streams(model, params, reqs, loop, **kw) -> dict:
    engine = Engine(model, params, loop=loop, **kw)
    st = run_trace(engine, poisson_trace(reqs, rate=2.0, seed=0))
    assert st["n_requests"] == len(reqs)
    assert all(o.finished_ok for o in st["outputs"].values())
    return st


@pytest.mark.parametrize("kind,kv_bits,chunk,attn,n_pages", [
    ("gqa", 8, None, "exact", 32), ("gqa", 2, 64, "exact", 32),
    ("gqa", 8, None, "exact", 4), ("gqa", 2, 64, "paged", 4),
    ("mla", 8, None, "exact", 4)],
    ids=["whole", "chunked", "whole-overload", "chunked-paged-overload",
         "mla-whole-overload"])
def test_engine_graph_loop_is_the_python_loop(kind, kv_bits, chunk, attn,
                                              n_pages):
    """5 requests (one sampled, two at priority 1) through 3 slots, over 32
    pages or over 4 (two requests' worth), where requests are preempted
    for pages and replayed: the graph loop's streams, statuses and
    preemptions are the Python loop's."""
    model, params = _port(kind, kv_bits)
    prompts = _prompts(model.cfg.vocab_size, 5, 100, seed=6).tolist()
    budgets = [12, 7, 10, 9, 11]
    reqs = [ServeRequest(tokens=prompts[i], max_new_tokens=budgets[i],
                         sampling=SamplingParams(
                             temperature=1.1 if i == 2 else 0.0, seed=i,
                             priority=int(i >= 3)))
            for i in range(5)]
    kw = dict(max_slots=3, n_pages=n_pages, max_pages_per_request=2,
              burst_steps=4, prefill_chunk=chunk, prefill_attn=attn)
    graph = _engine_streams(model, params, reqs, "graph", **kw)
    python = _engine_streams(model, params, reqs, "python", **kw)
    if n_pages == 4:
        assert graph["n_preemptions"] >= 1
    for key in ("n_preemptions", "statuses", "rounds"):
        assert graph[key] == python[key]
    for rid, out in python["outputs"].items():
        assert graph["outputs"][rid].tokens == out.tokens


def test_engine_graph_burst_retry_is_the_python_loop():
    """A burst failure injected at round 2 fires before the burst's inputs
    are refreshed: the retry replays the same region on the same inputs,
    and the streams are the Python loop's."""
    model, params = _port("gqa", 8)
    prompts = _prompts(model.cfg.vocab_size, 2, 60).tolist()
    reqs = [ServeRequest(tokens=prompts[0], max_new_tokens=10),
            ServeRequest(tokens=prompts[1], max_new_tokens=7,
                         sampling=SamplingParams(temperature=1.3, seed=7))]
    streams = {}
    for loop in ("graph", "python"):
        plan = FaultPlan({(2, "burst"): 1})
        engine = Engine(model, params, max_slots=2, n_pages=8,
                        max_pages_per_request=2, burst_steps=4,
                        fault_plan=plan, retry=RetryPolicy(backoff_s=0.0),
                        loop=loop)
        rids = [engine.submit(r) for r in reqs]
        outs = {o.request_id: o for o in engine.drain()}
        assert "burst_retry" in engine.events.kinds()
        streams[loop] = [outs[r].tokens for r in rids]
    assert streams["graph"] == streams["python"]


def test_engine_rejects_an_unknown_loop():
    model, params = _port("gqa", 8)
    with pytest.raises(ValueError, match="loop"):
        Engine(model, params, loop="scan")


# --------------------------------------------------- the counts at a replay
class _StandIn:
    """In place of ``CudaGraphs``: the warm-up and the capture call the
    region on the CPU, and the "graph" counts its replays."""

    def __init__(self, fail=False):
        self.fail, self.replays = fail, 0

    def warm_up(self, fn):
        fn()

    def capture(self, fn):
        out = fn()
        if self.fail:
            raise RuntimeError("capture refused")
        stand_in = self

        class Graph:
            def replay(self):
                stand_in.replays += 1
        return Graph(), out


@pytest.fixture
def stand_in_counts(monkeypatch):
    """The stand-in capture in place of the card's, and every launch count
    put back afterwards."""
    before = graphs.read_counts()
    yield lambda fail=False: monkeypatch.setattr(graphs.Replay, "graphs",
                                                 _StandIn(fail))
    graphs.write_counts(before)


def _region():
    """Counts as a captured step of wrappers would: 3 packed decode
    products and 1 flat flash decode."""
    quant_matmul.launches += 3
    quant_matmul.by_kernel["qmm_decode"] += 3
    counted()["flash_decode"].launches += 1
    return torch.ones(2)


def test_replay_moves_counts_from_capture_to_replays(stand_in_counts):
    stand_in_counts()
    stand_in = graphs.Replay.graphs
    before = graphs.read_counts()
    replay = graphs.Replay(_region, "cuda")
    assert replay.ready() > 0.0 and replay.captured
    assert graphs.read_counts() == before  # warm-up and capture: none
    assert replay.ready() == 0.0           # captured once
    for n in (1, 2):
        assert torch.equal(replay.run(), torch.ones(2))
        after = graphs.read_counts()
        assert after["quant_matmul"][0] == before["quant_matmul"][0] + 3 * n
        assert after["quant_matmul"][1]["qmm_decode"] == \
            before["quant_matmul"][1]["qmm_decode"] + 3 * n
        assert after["flash_decode"][0] == before["flash_decode"][0] + n
        assert after["gram"] == before["gram"]
    assert stand_in.replays == replay.replays == 2


def test_replay_capture_error_propagates_without_a_fallback(
        stand_in_counts):
    """No eager run in place of a failed capture: ``run`` raises, the
    region's counts are put back, and nothing is kept to replay."""
    stand_in_counts(fail=True)
    before = graphs.read_counts()
    replay = graphs.Replay(_region, "cuda")
    with pytest.raises(RuntimeError, match="capture refused"):
        replay.run()
    assert graphs.read_counts() == before
    assert not replay.captured and replay.outputs is None


def test_replay_on_the_cpu_calls_the_region():
    calls = []
    replay = graphs.Replay(lambda: calls.append(1) or len(calls), "cpu")
    assert replay.ready() == 0.0 and not replay.captured
    assert [replay.run(), replay.run()] == [1, 2]
