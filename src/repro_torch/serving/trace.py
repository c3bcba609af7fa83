"""Arrival traces for the engine: Poisson arrivals in scheduling-round
units, and a driver that submits on schedule, steps the engine to
completion and summarizes latency, time to first token and throughput."""
from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    step: int        # scheduling round at which the request arrives
    request: object  # ServeRequest


def poisson_trace(requests, rate: float, seed: int = 0) -> list[TraceEvent]:
    """Poisson arrivals: exponential inter-arrival times at ``rate``
    requests per scheduling round (an arrival time floors to the round in
    which the engine first sees it)."""
    rng = np.random.default_rng(seed)
    t, events = 0.0, []
    for req in requests:
        t += rng.exponential(1.0 / rate)
        events.append(TraceEvent(step=int(t), request=req))
    return events


def run_trace(engine, trace) -> dict:
    """Drive ``engine`` through ``trace`` until every request has finished,
    then check that every page came back (as ``Engine.drain`` does).  Returns the outputs by
    request id, wall-clock latency and time-to-first-token p50/p99 over
    the requests that finished ``ok``, emitted tokens, sustained tokens/s,
    the engine's cumulative admission time and a status histogram."""
    events = sorted(trace, key=lambda e: e.step)
    outputs, i, round_ix = [], 0, 0
    t0 = time.time()
    while i < len(events) or engine.busy:
        while i < len(events) and events[i].step <= round_ix:
            engine.submit(events[i].request)
            i += 1
        outputs.extend(engine.step())
        round_ix += 1
    wall = time.time() - t0
    engine.pools.assert_quiescent()
    done = [o for o in outputs if o.finished_ok]
    lats = np.array([o.latency for o in done]) if done else np.zeros(1)
    ttfts = np.array([o.ttft for o in done]) if done else np.zeros(1)
    n_tok = sum(len(o.tokens) for o in outputs)
    statuses: dict = {}
    for o in outputs:
        statuses[o.status] = statuses.get(o.status, 0) + 1
    return {
        "outputs": {o.request_id: o for o in outputs},
        "n_requests": len(outputs),
        "n_tokens": n_tok,
        "wall_s": wall,
        "sustained_tok_s": n_tok / max(wall, 1e-9),
        "p50_latency_s": float(np.percentile(lats, 50)),
        "p99_latency_s": float(np.percentile(lats, 99)),
        "ttft_p50_s": float(np.percentile(ttfts, 50)),
        "ttft_p99_s": float(np.percentile(ttfts, 99)),
        "admission_stall_s": float(engine.admission_stall_s),
        "rounds": round_ix,
        "statuses": statuses,
    }
