"""The port's engine under overload: preemption with teacher-forced replay,
priorities, deadlines, backpressure, fault injection and the watchdog.

Held to the port's own solo ``generate`` (its sampling stream cannot be the
reference's ``jax.random``), one test for each of the reference's
``tests/test_engine_overload.py``: a preempted request is admitted again by
ingesting its prompt as at its first admission and replaying its emitted
tokens through teacher-forced decode steps, so its final tokens are
bitwise those of its prompt served alone, greedy or sampled, GQA or MLA,
kv8 or kv2, whole-prompt or chunked admission (paged chunked admission is
lossy, so there a preempted run is held to the same engine with a pool
large enough that nobody is preempted).

Held to the reference: its ``Engine`` and the port's, on shared weights
(``convert.params_from_jax``), greedy with no EOS so that scheduling
depends on the budgets alone, with the same trace, slots, pages, bursts,
priorities, ``FaultPlan`` and a clock that reads the round, make the same
scheduling decisions: the same ``preempt`` events, the same other events
in order, the same statuses, preemption counts and token counts per
request, and the same number of rounds.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model
from repro.runtime import fault as ref_fault
from repro.serving import Engine as RefEngine
from repro.serving import SamplingParams as RefSamplingParams
from repro.serving import ServeRequest as RefServeRequest
from repro.serving import poisson_trace as ref_poisson_trace
from repro.serving import run_trace as ref_run_trace
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import generate
from repro_torch.models.lm import Model
from repro_torch.runtime import fault as port_fault
from repro_torch.runtime.fault import FaultPlan, RetryPolicy
from repro_torch.serving import (Engine, EngineSaturated, EngineStuck,
                                 PageAccountingError, PageAllocatorExhausted,
                                 RequestOutput, SamplingParams, ServeRequest,
                                 poisson_trace, run_trace)
from repro_torch.serving.trace import _status_group

EXPERT_FREE = dict(n_routed_experts=0, n_shared_experts=0, moe_top_k=0,
                   moe_d_ff=0)
_MODELS: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The engine's CPU rounds are thousands of tiny ops; with one intra-op
    thread they do not contend with the threads of the other test workers
    sharing the machine (the results are bitwise within the port, and
    decisions, not logits, are compared with the reference)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(kind: str, kv_bits: int):
    """(model, params) of the port on the CPU: the tiny llama3-8b config of
    ``tests/conftest.py`` (GQA) or deepseek-v3's reduced, expert-free
    config (MLA), in fp32, params from a seed."""
    key = (kind, kv_bits)
    if key not in _MODELS:
        if kind == "gqa":
            ref = dataclasses.replace(ref_get_config("llama3-8b").reduced(),
                                      n_layers=2, d_model=64, vocab_size=256)
        else:
            ref = dataclasses.replace(
                ref_get_config("deepseek-v3-671b").reduced(), **EXPERT_FREE)
        cfg = ModelConfig(**dataclasses.asdict(dataclasses.replace(
            ref, dtype="float32", kv_bits=kv_bits)))
        model = Model(cfg, "cpu")
        _MODELS[key] = model, model.init(torch.Generator().manual_seed(0))
    return _MODELS[key]


def _prompts(model, n, t, seed=2):
    rng = np.random.default_rng(seed)
    return rng.integers(2, model.cfg.vocab_size, (n, t)).tolist()


def _solo(model, params, prompt, n_gen, sp):
    return generate(model, params, torch.tensor([prompt]), n_gen,
                    temperature=sp.temperature, seed=sp.seed)[0].tolist()


def _req(prompt, n, sp=SamplingParams()):
    return ServeRequest(tokens=prompt, max_new_tokens=n, sampling=sp)


# ---------------------------------------------------------------- preemption
@pytest.mark.parametrize("kind,kv_bits", [("gqa", 8), ("gqa", 2),
                                          ("mla", 8), ("mla", 2)])
def test_preempted_request_bit_identical(kind, kv_bits):
    """A 3-page pool cannot hold two 2-page requests: admitting B preempts
    A mid-stream (at position 63, mid-page) and the two trade the pool
    until both finish.  A samples, so its resumed stream must continue at
    the right draw index; both streams are bitwise their solo runs."""
    model, params = _port(kind, kv_bits)
    prompts = _prompts(model, 2, 60)
    sp_a = SamplingParams(temperature=1.3, seed=7)
    base_a = _solo(model, params, prompts[0], 12, sp_a)
    base_b = _solo(model, params, prompts[1], 6, SamplingParams())

    engine = Engine(model, params, max_slots=2, n_pages=3,
                    max_pages_per_request=2, burst_steps=3)
    ra = engine.submit(_req(prompts[0], 12, sp_a))
    engine.step()  # A: token 0 and one burst (position 63, mid-page)
    assert engine.load()["running"] == 1
    rb = engine.submit(_req(prompts[1], 6))
    outs = {o.request_id: o for o in engine.drain()}

    assert outs[ra].tokens == base_a, "preempted stream diverged from solo"
    assert outs[rb].tokens == base_b
    assert outs[ra].n_preempted >= 1
    assert outs[ra].status == f"preempted_{outs[ra].n_preempted}"
    assert outs[ra].finished_ok and outs[rb].finished_ok
    assert engine.n_preemptions >= 1
    assert "preempt" in engine.events.kinds()
    assert engine.pools.free_pages() == 3


@pytest.mark.parametrize("kind,attn", [("gqa", "exact"), ("gqa", "paged"),
                                       ("mla", "exact"), ("mla", "paged")])
def test_preempted_chunked_prefill_resumes_bit_identical(kind, attn):
    """A's 150-token prompt is ingested again chunk by chunk on resume
    (``_start_chunked(resume=...)``) and B's whole prompt through the
    prefill without the head.  Exact chunks give the solo streams; paged
    chunks (lossy) give the streams of the same engine with a pool where
    nobody is preempted."""
    model, params = _port(kind, 8)
    pa = _prompts(model, 1, 150)[0]
    pb = _prompts(model, 2, 60)[1]

    def serve(n_pages):
        engine = Engine(model, params, max_slots=2, n_pages=n_pages,
                        max_pages_per_request=3, burst_steps=4,
                        prefill_chunk=64, prefill_attn=attn)
        ra = engine.submit(_req(pa, 8))
        rb = engine.submit(_req(pb, 12))
        outs = {o.request_id: o for o in engine.drain()}
        assert engine.pools.free_pages() == n_pages
        return outs[ra], outs[rb]

    a, b = serve(4)
    assert a.n_preempted >= 1, "pool pressure should preempt A"
    if attn == "exact":
        want = (_solo(model, params, pa, 8, SamplingParams()),
                _solo(model, params, pb, 12, SamplingParams()))
    else:
        full = serve(16)
        assert full[0].n_preempted == 0
        want = tuple(o.tokens for o in full)
    assert (a.tokens, b.tokens) == want


def test_priority_orders_preemption_and_admission():
    """A high-priority arrival takes a slot from the youngest strictly
    lower-priority running request: C (younger) is preempted, A (older)
    runs undisturbed, and all three streams stay bitwise correct."""
    model, params = _port("gqa", 8)
    prompts = _prompts(model, 3, 60)
    hi = SamplingParams(priority=1)
    bases = [_solo(model, params, prompts[0], 8, SamplingParams()),
             _solo(model, params, prompts[1], 8, SamplingParams()),
             _solo(model, params, prompts[2], 4, hi)]

    engine = Engine(model, params, max_slots=2, n_pages=4,
                    max_pages_per_request=2, burst_steps=4)
    ra = engine.submit(_req(prompts[0], 8))
    rc = engine.submit(_req(prompts[1], 8))
    engine.step()  # A and C admitted, both decode fresh tokens
    rb = engine.submit(_req(prompts[2], 4, hi))
    outs = {o.request_id: o for o in engine.drain()}

    ev = next(e for e in engine.events if e["kind"] == "preempt")
    assert ev["request"] == rc and ev["for_request"] == rb
    assert outs[ra].status == "ok", "older same-priority victim chosen"
    assert outs[rc].n_preempted == 1
    assert outs[rb].status == "ok"
    assert [outs[r].tokens for r in (ra, rc, rb)] == bases


# ------------------------------------------------------------------ deadlines
def test_deadline_expires_queued_and_running_requests():
    """``deadline_s`` ends an expired request whether queued (no tokens) or
    decoding (partial tokens), with status ``deadline_exceeded``; the
    engine's clock is patched."""
    model, params = _port("gqa", 8)
    prompts = _prompts(model, 2, 12)
    engine = Engine(model, params, max_slots=1, n_pages=2,
                    max_pages_per_request=1, burst_steps=2)
    clock = {"now": 0.0}
    engine._now = lambda: clock["now"]
    ra = engine.submit(_req(prompts[0], 20, SamplingParams(deadline_s=5.0)))
    rb = engine.submit(_req(prompts[1], 4, SamplingParams(deadline_s=1.0)))
    engine.step()  # A admitted (1 slot); B waits in the queue
    clock["now"] = 2.0
    outs = {o.request_id: o for o in engine.step()}
    assert outs[rb].status == "deadline_exceeded"
    assert outs[rb].tokens == [], "a queued request never decoded"
    clock["now"] = 6.0
    outs = {o.request_id: o for o in engine.step()}
    assert outs[ra].status == "deadline_exceeded"
    assert 0 < len(outs[ra].tokens) < 20, "a running request keeps partials"
    assert outs[ra].tokens == _solo(model, params, prompts[0], 20,
                                    SamplingParams())[:len(outs[ra].tokens)]
    assert not outs[ra].finished_ok
    assert engine.events.kinds().count("request_deadline_exceeded") == 2
    engine.drain()
    assert engine.pools.free_pages() == 2


# --------------------------------------------------------------- backpressure
def test_bounded_queue_rejects_with_retry_hint():
    """``queue_depth`` bounds the queue: the refusing ``EngineSaturated``
    carries a retry-after hint, the live occupancy and the queue length,
    and the same request is accepted once the engine drains."""
    model, params = _port("gqa", 8)
    prompts = _prompts(model, 2, 12)
    engine = Engine(model, params, max_slots=1, n_pages=4, queue_depth=1)
    engine.submit(_req(prompts[0], 4))
    req_b = _req(prompts[1], 4)
    with pytest.raises(EngineSaturated, match="retry after") as ei:
        engine.submit(req_b)
    assert ei.value.retry_after_s > 0
    assert 0.0 <= ei.value.occupancy <= 1.0
    assert ei.value.queued == 1
    assert "occupancy" in str(ei.value)
    engine.drain()
    engine.submit(req_b)  # accepted now
    assert len(engine.drain()) == 1


def test_admit_watermark_bounds_outstanding_demand():
    """``admit_watermark`` refuses a submission whose page demand (live +
    queued + incoming) exceeds that fraction of the pool."""
    model, params = _port("gqa", 8)
    reqs = [_req(p, 8) for p in _prompts(model, 3, 60)]
    engine = Engine(model, params, max_slots=2, n_pages=4,
                    max_pages_per_request=2, admit_watermark=1.0)
    engine.submit(reqs[0])  # demand 2 of 4
    engine.submit(reqs[1])  # demand 4 of 4
    with pytest.raises(EngineSaturated, match="admit watermark"):
        engine.submit(reqs[2])  # demand 6 > 4
    engine.drain()
    engine.submit(reqs[2])
    assert engine.drain()[0].finished_ok
    assert engine.pools.free_pages() == 4


# ------------------------------------------------------------ fault injection
@pytest.mark.parametrize("kv_bits", [8, 2])
def test_burst_fault_retries_bit_identical(kv_bits):
    """An injected burst failure fires before any device work (pools and
    slot rows untouched), so the retried burst runs from the same inputs
    and every stream stays bitwise its solo run."""
    model, params = _port("gqa", kv_bits)
    prompts = _prompts(model, 2, 60)
    sps = [SamplingParams(), SamplingParams(temperature=1.3, seed=7)]
    budgets = [10, 7]
    bases = [_solo(model, params, prompts[i], budgets[i], sps[i])
             for i in range(2)]
    plan = FaultPlan({(2, "burst"): 1})
    engine = Engine(model, params, max_slots=2, n_pages=8,
                    max_pages_per_request=2, burst_steps=4,
                    fault_plan=plan, retry=RetryPolicy(backoff_s=0.0))
    rids = [engine.submit(_req(prompts[i], budgets[i], sps[i]))
            for i in range(2)]
    outs = {o.request_id: o for o in engine.drain()}
    assert plan.fired == [{"layer": 2, "stage": "burst", "batch": None}]
    assert "burst_retry" in engine.events.kinds()
    for rid, base in zip(rids, bases):
        assert outs[rid].status == "ok"
        assert outs[rid].tokens == base, "retried burst diverged"


def test_burst_retries_exhausted_isolates_batch_engine_continues():
    """A burst that keeps failing past ``max_restarts`` fails the decoding
    requests (pages released) but the engine serves later submissions."""
    model, params = _port("gqa", 8)
    prompts = _prompts(model, 3, 60)
    base_c = _solo(model, params, prompts[2], 6, SamplingParams())
    plan = FaultPlan({(2, "burst"): 3})  # fires through every retry
    engine = Engine(model, params, max_slots=2, n_pages=8,
                    max_pages_per_request=2, burst_steps=4, fault_plan=plan,
                    retry=RetryPolicy(max_restarts=2, backoff_s=0.0))
    ra = engine.submit(_req(prompts[0], 10))
    rb = engine.submit(_req(prompts[1], 10))
    outs = {o.request_id: o for o in engine.drain()}
    assert outs[ra].status == outs[rb].status == "failed"
    assert engine.events.kinds().count("burst_retry") == 2
    assert "burst_poisoned" in engine.events.kinds()
    rc = engine.submit(_req(prompts[2], 6))
    outs = {o.request_id: o for o in engine.drain()}
    assert outs[rc].tokens == base_c, "the engine serves on after poison"


def test_unrecoverable_burst_error_propagates():
    """Only ``RetryPolicy.recoverable`` errors are caught: any other error
    of a burst (a CUDA error, a failed launch) leaves ``step`` at once,
    and is neither retried nor turned into a failed request."""
    model, params = _port("gqa", 8)
    engine = Engine(model, params, max_slots=1, n_pages=2,
                    retry=RetryPolicy(backoff_s=0.0))
    engine.submit(_req(_prompts(model, 1, 12)[0], 8))

    def broken():
        raise RuntimeError("CUDA error: an illegal memory access")
    engine._burst = broken
    with pytest.raises(RuntimeError, match="illegal memory access"):
        engine.step()
    assert engine.events.kinds() == []


def test_admit_and_ingest_faults_isolate_one_request():
    """A fault at the admit or ingest stage fails only the request being
    worked on; its pages are released and every other request finishes
    bitwise clean."""
    model, params = _port("gqa", 8)
    prompts = _prompts(model, 2, 30)
    base = _solo(model, params, prompts[1], 6, SamplingParams())
    engine = Engine(model, params, max_slots=2, n_pages=4,
                    fault_plan=FaultPlan({(1, "admit"): 1}),
                    retry=RetryPolicy(backoff_s=0.0))
    ra = engine.submit(_req(prompts[0], 6))
    rb = engine.submit(_req(prompts[1], 6))
    outs = {o.request_id: o for o in engine.drain()}
    assert outs[ra].status == "failed" and outs[ra].tokens == []
    assert outs[rb].tokens == base
    assert "request_failed" in engine.events.kinds()

    long_p = _prompts(model, 1, 150)[0]
    engine = Engine(model, params, max_slots=2, n_pages=4,
                    max_pages_per_request=3, prefill_chunk=64,
                    fault_plan=FaultPlan({(2, "ingest"): 1}),
                    retry=RetryPolicy(backoff_s=0.0))
    ra = engine.submit(_req(long_p, 6))
    rb = engine.submit(_req(prompts[1], 6))
    outs = {o.request_id: o for o in engine.drain()}
    assert outs[ra].status == "failed", "a chunked ingest fault isolates A"
    assert outs[rb].tokens == base
    assert engine.pools.free_pages() == 4


def test_retire_fault_defers_one_round():
    """A retire fault defers retirement (idempotent bookkeeping) by one
    round; the request still finishes with its exact stream."""
    model, params = _port("gqa", 8)
    p = _prompts(model, 1, 12)[0]
    base = _solo(model, params, p, 4, SamplingParams())
    engine = Engine(model, params, max_slots=1, n_pages=2, burst_steps=4,
                    fault_plan=FaultPlan({(1, "retire"): 1}),
                    retry=RetryPolicy(backoff_s=0.0))
    rid = engine.submit(_req(p, 4))
    assert engine.step() == []  # finished, but retirement deferred
    assert engine.busy and "retire_deferred" in engine.events.kinds()
    outs = {o.request_id: o for o in engine.drain()}
    assert outs[rid].tokens == base and outs[rid].status == "ok"


def test_watchdog_raises_on_wedged_engine():
    """A busy engine making no progress emits ``stuck_round`` at
    ``watchdog_rounds`` idle rounds and raises ``EngineStuck`` at twice
    that, so ``drain()`` fails instead of spinning for ever."""
    model, params = _port("gqa", 8)
    engine = Engine(model, params, max_slots=1, n_pages=2,
                    watchdog_rounds=3)
    engine.submit(_req(_prompts(model, 1, 12)[0], 8))
    engine._burst = lambda: None  # wedged: bursts never decode anything
    with pytest.raises(EngineStuck, match="wedged"):
        for _ in range(20):
            engine.step()
    assert "stuck_round" in engine.events.kinds()
    assert engine._round == 1 + 2 * 3  # the admitting round, then 6 idle


# ------------------------------------------------------------ overload traces
@pytest.mark.parametrize("kind,kv_bits,mode", [
    ("gqa", 8, "whole"), ("mla", 2, "whole"),
    ("gqa", 2, "chunked-exact"), ("mla", 8, "chunked-exact"),
    ("gqa", 8, "chunked-paged"), ("mla", 2, "chunked-paged")])
def test_oversubscribed_trace_all_terminal_and_bit_identical(kind, kv_bits,
                                                             mode):
    """A Poisson trace whose hot page demand is twice the pool (4 slots x 2
    pages against 4 pages) drains with every request finished,
    preemptions exercised, and every stream, preempted and sampled ones
    included, bitwise its solo run (paged chunks, which are lossy: the
    same trace over 16 pages, where nobody is preempted)."""
    model, params = _port(kind, kv_bits)
    chunk, attn = {"whole": (None, "exact"), "chunked-exact": (64, "exact"),
                   "chunked-paged": (64, "paged")}[mode]
    prompts = _prompts(model, 8, 60 if chunk is None else 100)
    budgets = [8, 12, 9, 10, 8, 11, 12, 9]
    sps = [SamplingParams() if i % 2 == 0
           else SamplingParams(temperature=1.3, seed=i) for i in range(8)]
    reqs = [_req(prompts[i], budgets[i], sps[i]) for i in range(8)]

    def drive(n_pages):
        engine = Engine(model, params, max_slots=4, n_pages=n_pages,
                        max_pages_per_request=2, burst_steps=4,
                        prefill_chunk=chunk, prefill_attn=attn)
        stats = run_trace(engine, poisson_trace(reqs, rate=2.0, seed=3))
        assert engine.pools.free_pages() == n_pages
        return stats

    stats = drive(4)
    assert stats["n_requests"] == 8
    assert sum(stats["statuses"].values()) == 8
    assert stats["n_shed"] == stats["n_deadline"] == stats["n_failed"] == 0
    assert stats["n_preemptions"] >= 1, "2x oversubscription must preempt"
    assert stats["n_preempted_requests"] >= 1
    assert "preempted" in stats["per_status"]
    outs = stats["outputs"]
    if attn == "exact":
        want = [_solo(model, params, prompts[i], budgets[i], sps[i])
                for i in range(8)]
    else:
        full = drive(16)
        assert full["n_preemptions"] == 0
        want = [full["outputs"][rid].tokens for rid in range(8)]
    for i, rid in enumerate(sorted(outs)):  # ids follow the arrivals
        assert outs[rid].finished_ok
        assert outs[rid].ttft >= 0
        assert outs[rid].tokens == want[i], i
    assert any(outs[rid].n_preempted and sps[rid].temperature > 0
               for rid in outs), "a sampled request among the preempted"


def test_trace_sheds_over_queue_depth():
    """``run_trace`` records submissions refused by backpressure as
    ``shed`` outputs with negative ids, so every submission is accounted
    for."""
    model, params = _port("gqa", 8)
    p = _prompts(model, 1, 12)[0]
    reqs = [_req(p, 4) for _ in range(3)]
    engine = Engine(model, params, max_slots=1, n_pages=2,
                    max_pages_per_request=1, queue_depth=1)
    # rate 50: all three arrive in round 0, one queued and two shed
    stats = run_trace(engine, poisson_trace(reqs, rate=50.0, seed=0))
    assert stats["n_requests"] == 3
    assert stats["n_shed"] == 2 == stats["statuses"]["shed"]
    shed = [o for o in stats["outputs"].values() if o.status == "shed"]
    assert all(o.request_id < 0 and o.tokens == [] for o in shed)
    done = [o for o in stats["outputs"].values() if o.finished_ok]
    assert len(done) == 1 and len(done[0].tokens) == 4
    assert stats["per_status"]["shed"]["n"] == 2


def test_run_trace_overload_counters_on_stub_engine():
    """The summary's overload counters and per-status percentiles, on
    hand-built outputs (one of each terminal status and one shed)."""
    outs = [RequestOutput(request_id=0, tokens=[1, 2], prompt_len=2,
                          submit_time=0.0, finish_time=1.0,
                          first_token_time=0.5),
            RequestOutput(request_id=1, tokens=[3], prompt_len=2,
                          submit_time=0.0, finish_time=2.0,
                          first_token_time=0.5, status="preempted_2",
                          n_preempted=2),
            RequestOutput(request_id=2, tokens=[], prompt_len=2,
                          submit_time=0.0, finish_time=3.0,
                          status="deadline_exceeded"),
            RequestOutput(request_id=3, tokens=[4], prompt_len=2,
                          submit_time=0.0, finish_time=4.0, status="failed")]

    class Pools:
        def assert_quiescent(self):
            pass

    class Stub:
        n_preemptions = 2
        admission_stall_s = 0.0
        pools = Pools()

        def __init__(self):
            self._pending = list(outs)
            self._n = 0

        def submit(self, req):
            self._n += 1
            if self._n == 3:
                e = EngineSaturated("full")
                e.retry_after_s, e.occupancy, e.queued = 0.1, 1.0, 2
                raise e

        @property
        def busy(self):
            return bool(self._pending)

        def step(self):
            return [self._pending.pop(0)] if self._pending else []

    reqs = [ServeRequest(tokens=[1, 2], max_new_tokens=2)] * 5
    stats = run_trace(Stub(), poisson_trace(reqs, rate=100.0, seed=0))
    assert stats["n_requests"] == 5
    assert stats["statuses"] == {"ok": 1, "preempted_2": 1, "shed": 1,
                                 "deadline_exceeded": 1, "failed": 1}
    assert stats["n_shed"] == 1 and stats["n_deadline"] == 1
    assert stats["n_failed"] == 1
    assert stats["n_preemptions"] == 2
    assert stats["n_preempted_requests"] == 1
    assert set(stats["per_status"]) == {"ok", "preempted", "shed",
                                        "deadline_exceeded", "failed"}
    assert stats["per_status"]["preempted"]["n"] == 1
    # service percentiles cover only the finished requests
    assert stats["p50_latency_s"] == pytest.approx(
        float(np.percentile([1.0, 2.0], 50)))
    assert stats["ttft_p50_s"] == pytest.approx(0.5)
    assert _status_group("preempted_7") == "preempted"
    assert _status_group("ok") == "ok"


# ------------------------------------------------------------ page accounting
def test_engine_drain_detects_leaked_pages():
    """``drain()`` ends with a free-list audit: a page that never came back
    (leaked here by reaching around the engine) fails the drain."""
    model, params = _port("gqa", 8)
    engine = Engine(model, params, max_slots=1, n_pages=4)
    engine.pools.alloc(1, context=" (leaked on purpose)")
    engine.submit(ServeRequest(tokens=[1, 2, 3], max_new_tokens=2))
    with pytest.raises(PageAccountingError, match="leak"):
        engine.drain()


def test_exhaustion_error_carries_occupancy_and_hint():
    """The allocator's sizing error exposes need, have and occupancy (and
    an optional retry-after hint) as attributes."""
    model, params = _port("gqa", 8)
    engine = Engine(model, params, max_slots=1, n_pages=2,
                    max_pages_per_request=8)
    with pytest.raises(PageAllocatorExhausted, match="can never fit") as ei:
        engine.submit(ServeRequest(tokens=[1] * 60, max_new_tokens=200))
    err = ei.value
    assert err.need == -(-260 // engine.page) and err.have == 2
    assert err.occupancy == pytest.approx(0.0)  # empty pool, still too small
    assert err.retry_after_s is None
    assert "occupancy" in str(err) and "need" in str(err)
    hinted = engine.pools.exhausted(4, retry_after_s=0.25)
    assert "Retry after ~0.25s" in str(hinted)
    assert hinted.retry_after_s == 0.25


@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_prefill_without_logits_writes_the_same_cache(kind):
    """The resume's prefill (``logits=False``) skips the head and returns
    the same cache bits as the admitting prefill."""
    model, params = _port(kind, 2)
    toks = torch.tensor(_prompts(model, 1, 70))
    logits, cache = model.prefill(params, toks, cache_len=70)
    none, again = model.prefill(params, toks, cache_len=70, logits=False)
    assert none is None and logits.shape == (1, model.cfg.vocab_size)
    for c, a in zip(cache, again):
        assert c.keys() == a.keys()
        assert all(torch.equal(c[k], a[k]) for k in c)


# ------------------------------------------- the same decisions as the JAX engine
_REF: dict = {}


def _shared(kind: str):
    """The reference's (model config, params) and the port's params on the
    same weights: the tiny llama3-8b config or the expert-free MLA one."""
    if kind not in _REF:
        if kind == "gqa":
            cfg = dataclasses.replace(ref_get_config("llama3-8b").reduced(),
                                      dtype="float32", n_layers=2,
                                      d_model=64, vocab_size=256)
        else:
            cfg = dataclasses.replace(
                ref_get_config("deepseek-v3-671b").reduced(),
                dtype="float32", **EXPERT_FREE)
        params = jax.jit(build_model(cfg).init)(jax.random.key(0))
        pcfg = ModelConfig(**dataclasses.asdict(cfg))
        pparams = params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                                  device="cpu")
        _REF[kind] = cfg, params, pcfg, pparams
    return _REF[kind]


def _decisions(engine, stats) -> dict:
    def other(e):
        return (e["kind"], e.get("round"), e.get("request"))
    events = list(engine.events)
    return {
        "preempt": [(e["request"], e["for_request"], e["round"],
                     e["n_tokens"], e["pages_freed"])
                    for e in events if e["kind"] == "preempt"],
        "other": [other(e) for e in events if e["kind"] != "preempt"],
        "requests": {rid: (o.status, o.n_preempted, len(o.tokens))
                     for rid, o in stats["outputs"].items()},
        "rounds": stats["rounds"],
        "n_preemptions": stats["n_preemptions"]}


# (kind, kv_bits, prompt, budgets, prefill_chunk, prefill_attn, slots,
#  pages, pages per request, priorities, deadlines in rounds, faults)
_CASES = {
    "gqa-kv8-whole": ("gqa", 8, 60, [8, 12, 9, 10, 8, 11, 12, 9], None,
                      "exact", 4, 4, 2, {5: 1, 7: 1}, {6: 3.0}, {}),
    "gqa-kv2-chunked-exact": (
        "gqa", 2, 150, [8, 12, 6, 10, 7, 12, 9, 5], 64, "exact", 3, 6, 3,
        {4: 1}, {2: 2.0, 7: 4.0},
        {(3, "burst"): 1, (4, "admit"): 1, (2, "ingest"): 1,
         (9, "retire"): 1, (12, "burst"): 4}),
    "mla-kv8-chunked-paged": (
        "mla", 8, 150, [9, 6, 12, 8, 11, 7, 10, 12], 64, "paged", 4, 6, 3,
        {3: 1, 6: 2}, {5: 6.0}, {(6, "burst"): 1}),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_same_scheduling_decisions_as_the_reference(case):
    """Both engines on the same weights and trace, greedy with no EOS, with
    a clock that reads the engine's round: the same preemptions (victim,
    beneficiary, round, tokens held, free pages), the same other events in
    order (deadlines, faults, retries), the same status, preemption count
    and token count for every request, and the same number of rounds.
    Every case mixes priorities and a deadline under a pool of half the hot
    demand or less; the GQA chunked case adds faults at every stage."""
    (kind, kv_bits, t, budgets, chunk, attn, slots, pages, max_pages, prio,
     deadline, plan) = _CASES[case]
    cfg, params, pcfg, pparams = _shared(kind)
    n = len(budgets)
    prompts = np.random.default_rng(4).integers(
        2, cfg.vocab_size, (n, t)).tolist()
    got = {}
    for side in ("ref", "port"):
        if side == "ref":
            model, p = build_model(dataclasses.replace(
                cfg, kv_bits=kv_bits)), params
            Eng, SP, SR, fault = (RefEngine, RefSamplingParams,
                                  RefServeRequest, ref_fault)
            trace, drive = ref_poisson_trace, ref_run_trace
        else:
            model = Model(dataclasses.replace(pcfg, kv_bits=kv_bits), "cpu")
            p = pparams
            Eng, SP, SR, fault = (Engine, SamplingParams, ServeRequest,
                                  port_fault)
            trace, drive = poisson_trace, run_trace
        reqs = [SR(tokens=prompts[i], max_new_tokens=budgets[i],
                   sampling=SP(priority=prio.get(i, 0),
                               deadline_s=deadline.get(i, 0.0)))
                for i in range(n)]
        engine = Eng(model, p, max_slots=slots, n_pages=pages,
                     max_pages_per_request=max_pages, burst_steps=4,
                     prefill_chunk=chunk, prefill_attn=attn,
                     fault_plan=fault.FaultPlan(dict(plan)),
                     retry=fault.RetryPolicy(max_restarts=2, backoff_s=0.0))
        engine._now = lambda e=engine: float(e._round)
        stats = drive(engine, trace(reqs, rate=2.0, seed=3))
        got[side] = _decisions(engine, stats)
    assert got["port"] == got["ref"]
    assert got["port"]["n_preemptions"] >= 1
    assert len(got["port"]["other"]) >= 1 + len(plan)
