"""Arrival traces for the engine: Poisson arrivals in scheduling-round
units, and a driver that submits on schedule, records a submission that
backpressure refuses as shed, steps the engine to completion and
summarizes latency, time to first token, throughput and the overload
counters (preemptions, shed, deadline-expired and failed requests)."""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.serving.engine import EngineSaturated, RequestOutput


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


def _status_group(status: str) -> str:
    """``preempted_N`` in one group; every other status is its own."""
    return "preempted" if status.startswith("preempted") else status


def run_trace(engine, trace) -> dict:
    """Drive ``engine`` through ``trace`` until every request has ended,
    then check that every page came back (as ``Engine.drain`` does).

    Each event is submitted at its round; a submission refused by
    backpressure (:class:`EngineSaturated`) becomes an output with status
    ``shed`` and a negative id, so every submission ends in exactly one
    output.  Returns the outputs by request id, wall-clock latency p50/p99
    over the requests that finished (``ok`` or ``preempted_N``), time to
    first token p50/p99 over the same (over every output that drew a first
    token where none finished), emitted tokens, sustained tokens/s, the
    engine's cumulative admission time, the overload counters
    (``n_preemptions`` events, ``n_preempted_requests``, and the terminal
    ``n_shed``, ``n_deadline`` and ``n_failed``), a status histogram and
    latency percentiles per status group."""
    events = sorted(trace, key=lambda e: e.step)
    outputs, i, round_ix, n_shed = [], 0, 0, 0
    t0 = time.time()
    while i < len(events) or engine.busy:
        while i < len(events) and events[i].step <= round_ix:
            try:
                engine.submit(events[i].request)
            except EngineSaturated:
                n_shed += 1
                now = time.time()
                outputs.append(RequestOutput(
                    request_id=-n_shed, tokens=[],
                    prompt_len=len(events[i].request.tokens),
                    submit_time=now, finish_time=now, status="shed"))
            i += 1
        outputs.extend(engine.step())
        round_ix += 1
    wall = time.time() - t0
    engine.pools.assert_quiescent()
    done = [o for o in outputs if o.finished_ok]
    lats = np.array([o.latency for o in done]) if done else np.zeros(1)
    ttfts = ([o.ttft for o in done if o.first_token_time > 0]
             or [o.ttft for o in outputs if o.first_token_time > 0])
    ttfts = np.array(ttfts) if ttfts else np.zeros(1)
    n_tok = sum(len(o.tokens) for o in outputs)
    statuses: dict = {}
    groups: dict = {}
    for o in outputs:
        statuses[o.status] = statuses.get(o.status, 0) + 1
        groups.setdefault(_status_group(o.status), []).append(o.latency)
    per_status = {
        g: {"n": len(ls),
            "p50_latency_s": float(np.percentile(ls, 50)),
            "p99_latency_s": float(np.percentile(ls, 99))}
        for g, ls in sorted(groups.items())}
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
        "n_preemptions": int(engine.n_preemptions),
        "n_preempted_requests": sum(1 for o in outputs if o.n_preempted),
        "n_shed": statuses.get("shed", 0),
        "n_deadline": statuses.get("deadline_exceeded", 0),
        "n_failed": statuses.get("failed", 0),
        "statuses": statuses,
        "per_status": per_status,
    }
