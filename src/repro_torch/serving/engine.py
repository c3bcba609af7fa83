"""Continuous-batching serve engine over block-paged quantized KV pools.

Requests arrive (``submit``), prefill into freshly allocated pages, join
the running decode batch at the next scheduling round (``step``), and
retire as soon as they reach EOS or their token budget, releasing their
pages for the next admission.  Decode runs in bursts: ``burst_steps``
paged decode steps whose per-slot state (token, position, emitted count,
liveness) stays on the device, so the host reads back once per burst.  A
slot that finishes mid-burst deactivates in place and its later appends go
to the trash page, as the reference's scan does.  With ``loop="graph"``
(the default, the counterpart of the reference's jitted ``_burst_fn``) a
burst is one CUDA graph over the engine's pools, which never move: the
slot rows are copied into static inputs and the graph is replayed; one
graph for greedy bursts and one for sampled ones, both captured when the
engine is built, on all-inactive slots (their appends go to the trash
page), so no request's time includes a capture (``capture_s``).  On the
CPU the same burst runs over the same static inputs without a graph.
``loop="python"`` launches each step from Python (the debug loop; the same
tokens bit for bit).

Determinism: a request's tokens equal the ones ``launch.serve.generate``
gives for its prompt alone at batch 1 with the same ``SamplingParams``
(token ``j`` is drawn from ``serving.sampling`` keyed by (seed, j); token
0 comes from the prefill logits), and the paged attention equals the flat
cache's at tile = page.  Pages for the whole request (prompt +
``max_new_tokens``) are reserved at admission, so a running request never
meets the allocator.  With ``prefill_chunk=N`` a prompt is ingested in
page-aligned chunks, one chunk per ingesting slot per round, between
decode bursts: ``prefill_attn="exact"`` replays the whole-prompt prefill
through transient fp prefix buffers (same tokens), ``"paged"`` reads the
earlier chunks back from their quantized pages through the extend kernel
(no buffer, lossy).

Overload policy:

* Preemption and requeue.  When the request at the head of the queue
  cannot be admitted (no free pages, or every slot held while a request
  of strictly lower priority runs), the engine evicts the lowest-priority,
  youngest eligible running request: its pages go back to the free list,
  its emitted tokens are kept, and it is queued again under its own id.
  On re-admission its prompt is ingested again the way it was admitted
  (whole, or in the same chunks), which rebuilds its pages bit for bit,
  and its emitted tokens are replayed: each burst step of the replay feeds
  the original input token at the original position and takes the
  original output token in place of a fresh draw.  The (seed, token
  index) stream then resumes at the next index, so the final stream is
  bitwise the one of a run that was never preempted.  The burst always
  runs all ``max_slots`` rows, so a row's bits do not depend on what the
  other slots hold.
* Deadlines and priorities.  ``SamplingParams.deadline_s`` ends a request
  that is queued (no tokens) or running (partial tokens) with status
  ``deadline_exceeded``; ``priority`` orders admission (higher first, then
  by id) and bounds who may be evicted.
* Backpressure.  ``queue_depth`` bounds the queue and ``admit_watermark``
  the outstanding page demand; ``submit`` then raises
  :class:`EngineSaturated` with a retry-after hint, the pool occupancy and
  the queue length instead of queueing without bound.
* Fault injection and the watchdog.  ``fault_plan`` arms ``(round,
  stage)`` failures (``runtime.fault.SERVE_STAGES``), checked before each
  stage's device work.  A failed burst is retried under ``retry`` from the
  same inputs, so its tokens do not change; a request whose admission or
  ingest fails ends ``failed`` alone; a failed retire waits one round.
  Only ``retry.recoverable`` errors are caught: a CUDA error propagates.
  A busy engine that makes no progress for ``watchdog_rounds`` rounds
  emits a ``stuck_round`` event, and raises :class:`EngineStuck` at twice
  that.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Optional

import torch

from repro_torch.runtime.fault import EventLog, RetryPolicy
from repro_torch.runtime.graphs import LOOPS, Replay
from repro_torch.serving.paged import PagedPools
from repro_torch.serving.sampling import sample_tokens

def decode_burst(model, params, pools: list, ins: dict, n: int,
                sampled: bool) -> tuple:
    """``n`` paged decode steps of every slot from the burst inputs ``ins``
    (device tensors, named as ``Engine._burst_rows`` names the slot rows
    and the replay pair), pools written in place.
    At a step where ``fmask`` is set a slot takes the ``forced`` token in
    place of its draw (a preempted request's replay).  Returns the final
    (tok, pos, nem, act) and the (n, slots) tokens (-1 where inactive) and
    emitted mask.  A module function, so that a graph of it refers to the
    model, the params and the pools but not to the engine."""
    tok, pos, nem, act = ins["tok"], ins["pos"], ins["nem"], ins["act"]
    toks, emitted = [], []
    for i in range(n):
        logits = model.paged_decode_step(params, pools, ins["tbl"], tok, pos,
                                         act)
        nxt = sample_tokens(logits, ins["temp"], ins["seeds"], nem,
                            sampled=sampled)
        nxt = torch.where(ins["fmask"][i], ins["forced"][i], nxt)
        done = act & ((nxt == ins["eos"]) | (nem + 1 >= ins["max_new"]))
        toks.append(torch.where(act, nxt, -1))
        emitted.append(act)
        nem = nem + act.long()
        pos = pos + act.long()
        tok = nxt[:, None]
        act = act & ~done
    return tok, pos, nem, act, torch.stack(toks), torch.stack(emitted)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Greedy at ``temperature == 0``, else sampled from ``logits /
    temperature`` on the (seed, token index) stream; ``eos_token`` stops a
    request early when drawn (-1: never).  ``priority`` orders admission
    (higher first, first come first within a level) and bounds preemption:
    a request evicts only strictly lower priority for a slot, and lower or
    equal but younger for pages.  ``deadline_s`` (0: none) ends the request
    with status ``deadline_exceeded`` once that many seconds have passed
    since ``submit``, queued or running."""
    temperature: float = 0.0
    seed: int = 0
    eos_token: int = -1
    priority: int = 0
    deadline_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """Prompt token ids, a token budget and sampling params."""
    tokens: tuple
    max_new_tokens: int
    sampling: SamplingParams = SamplingParams()

    def __post_init__(self):
        object.__setattr__(self, "tokens", tuple(int(t) for t in self.tokens))
        if not self.tokens:
            raise ValueError("ServeRequest needs at least one prompt token")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")


@dataclasses.dataclass
class RequestOutput:
    """Terminal record of one request.  ``status``: ``ok`` (finished, never
    preempted), ``preempted_N`` (finished after N preemptions, tokens the
    same), ``deadline_exceeded`` (partial tokens), ``failed`` (isolated by a
    fault) or ``shed`` (refused at submit; made by ``run_trace``, never by
    the engine)."""
    request_id: int
    tokens: list
    prompt_len: int
    submit_time: float
    finish_time: float
    first_token_time: float = 0.0
    status: str = "ok"
    n_preempted: int = 0

    @property
    def latency(self) -> float:
        return self.finish_time - self.submit_time

    @property
    def ttft(self) -> float:
        """Submit to the round that drew token 0 from the prefill."""
        return self.first_token_time - self.submit_time

    @property
    def finished_ok(self) -> bool:
        """Budget or EOS reached, preempted on the way or not."""
        return self.status == "ok" or self.status.startswith("preempted")


class EngineSaturated(RuntimeError):
    """``submit`` refused by backpressure (``queue_depth`` or
    ``admit_watermark``).  Carries ``retry_after_s`` (from the engine's
    service-time estimate), ``occupancy`` (live page fraction) and
    ``queued``; ``run_trace`` records such a request as ``shed``."""


class EngineStuck(RuntimeError):
    """The watchdog saw no progress for twice ``watchdog_rounds`` rounds
    while the engine was busy: ``drain()`` fails instead of spinning."""


@dataclasses.dataclass
class _QueueEntry:
    """A queued request; ``resume`` holds the tokens it had emitted when it
    was preempted (at least token 0), None for a fresh submission."""
    rid: int
    req: ServeRequest
    resume: Optional[list] = None

    @property
    def key(self):
        # highest priority first, then by id: a preempted request keeps its
        # id, so it comes back ahead of same-priority later submissions
        return (-self.req.sampling.priority, self.rid)


class Engine:
    """``submit()`` requests, drive rounds with ``step()`` or run them to
    completion with ``drain()``.  A round expires deadlines, admits queued
    requests into free slots (preempting when the head cannot fit),
    advances every ingesting slot by one prompt chunk, runs one decode
    burst over the live slots and retires the finished."""

    def __init__(self, model, params, *, max_slots: int = 4,
                 n_pages: int = 64, max_pages_per_request: int = 8,
                 burst_steps: int = 8, prefill_chunk: Optional[int] = None,
                 prefill_attn: str = "exact",
                 queue_depth: Optional[int] = None,
                 admit_watermark: Optional[float] = None,
                 fault_plan=None, retry: Optional[RetryPolicy] = None,
                 watchdog_rounds: int = 256, on_event=None,
                 loop: str = "graph"):
        bad = sorted(set(model.cfg.layer_kinds()) - {"attn"})
        if bad or model.cfg.attn_kind not in ("gqa", "mla"):
            raise ValueError(
                f"paged serving supports attn/mla mixers, model has "
                f"{bad or [model.cfg.attn_kind]} — ssm/cross-attention "
                f"state is per-slot, not per-page; serve such models "
                f"through launch.serve.generate")
        if model.cfg.family == "encdec":
            raise ValueError(
                "paged serving does not support cross-attention caches "
                "(media/encoder KV is request-global, not paged); use "
                "launch.serve.generate")
        if prefill_attn not in ("exact", "paged"):
            raise ValueError(f"prefill_attn must be 'exact' or 'paged', got "
                             f"{prefill_attn!r}")
        if loop not in LOOPS:
            raise ValueError(f"loop must be one of {LOOPS}, got {loop!r}")
        self.model = model
        self.params = params
        self.pools = PagedPools(model, n_pages)  # checks kv_bits
        self.page = self.pools.page
        self.max_slots = max_slots
        self.max_pages = max_pages_per_request
        self.burst_steps = burst_steps
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(
                    f"prefill_chunk must be >= 1, got {prefill_chunk}")
            # page-aligned chunks: a kv2 scale group never straddles two
            prefill_chunk = -(-prefill_chunk // self.page) * self.page
        self.prefill_chunk = prefill_chunk
        self.prefill_attn = prefill_attn
        self.device = model.device
        self.queue_depth = queue_depth
        self.admit_watermark = admit_watermark
        self.fault_plan = fault_plan
        self.retry = retry if retry is not None else RetryPolicy()
        self.watchdog_rounds = watchdog_rounds
        self.events = EventLog(on_event, verbose=False)
        self._now = time.time  # the request clock; tests patch it

        # per-slot state: host rows, uploaded with each burst
        b = max_slots
        self.tbl = torch.zeros((b, self.max_pages), dtype=torch.int32)
        self.tok = torch.zeros((b, 1), dtype=torch.int64)
        self.pos = torch.zeros((b,), dtype=torch.int64)
        self.nem = torch.zeros((b,), dtype=torch.int64)
        self.act = torch.zeros((b,), dtype=torch.bool)
        self.temp = torch.zeros((b,), dtype=torch.float32)
        self.seeds = torch.zeros((b,), dtype=torch.int64)
        self.eos = torch.full((b,), -1, dtype=torch.int64)
        self.max_new = torch.ones((b,), dtype=torch.int64)

        self._queue: list[_QueueEntry] = []
        self._next_rid = 0
        self._slot_rid: list = [None] * b
        self._slot_pages: list = [None] * b
        self._slot_tokens: list = [None] * b
        self._slot_req: list = [None] * b
        self._ingest: list = [None] * b   # chunked-prefill progress
        self._replay: list = [None] * b   # tokens still to replay
        self._slot_base = [0] * b         # tokens held at (re-)admission
        self._submit_time: dict = {}
        self._first_token_time: dict = {}
        self._n_preempted: dict = {}
        self._round = 0
        self._idle_rounds = 0
        self._progress = False
        self._service_ema: Optional[float] = None  # of finished latencies
        self.n_preemptions = 0
        self.admission_stall_s = 0.0

        # the burst: static device inputs and one region each for greedy
        # and sampled bursts, captured here on the all-inactive rows above
        self.loop = loop
        self.graphs: dict = {}
        self.capture_s = 0.0
        if loop == "graph":
            R = burst_steps
            self._static = {name: a.to(self.device, copy=True)
                            for name, a in self._burst_rows().items()}
            for sampled in (False, True):
                args = (model, params, self.pools.pools, self._static)
                self.graphs[sampled] = Replay(
                    lambda a=args, s=sampled: decode_burst(*a, R, s),
                    self.device, params=params,
                    warm_up=lambda a=args, s=sampled: decode_burst(*a, 1, s))
                self.capture_s += self.graphs[sampled].ready()

    # ------------------------------------------------------------------ API
    def submit(self, request: ServeRequest) -> int:
        """Queue a request and return its id; admission happens at the next
        ``step()``.  A request that can never fit is refused here, and
        backpressure refuses with :class:`EngineSaturated`."""
        need = self._pages_for(request)
        sizing = self.pools.sizing(len(request.tokens),
                                   request.max_new_tokens)
        if need > self.max_pages:
            raise ValueError(
                f"request needs {sizing} but the page table holds "
                f"{self.max_pages} per request — raise "
                "max_pages_per_request or split the request")
        if need > self.pools.n_pages:
            raise self.pools.exhausted(
                need, have=self.pools.n_pages,
                context=f" (submit: {sizing} can never fit)")
        queued = len(self._queue)
        if self.queue_depth is not None and queued >= self.queue_depth:
            occ, hint = self.pools.occupancy(), self._retry_after()
            raise self._saturated(
                f"engine saturated: {queued} queued at queue_depth="
                f"{self.queue_depth}, pool occupancy {occ:.0%} — "
                f"retry after ~{hint:.2f}s", hint, occ, queued)
        if self.admit_watermark is not None:
            cap = self.admit_watermark * self.pools.n_pages
            demand = ((self.pools.n_pages - self.pools.free_pages())
                      + sum(self._pages_for(e.req) for e in self._queue)
                      + need)
            if demand > cap:
                occ, hint = self.pools.occupancy(), self._retry_after()
                raise self._saturated(
                    f"engine saturated: outstanding demand of {demand} "
                    f"pages exceeds the admit watermark ({cap:.0f} = "
                    f"{self.admit_watermark:g} x {self.pools.n_pages} "
                    f"pages), pool occupancy {occ:.0%} — retry after "
                    f"~{hint:.2f}s", hint, occ, queued)
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_QueueEntry(rid, request))
        self._submit_time[rid] = self._now()
        return rid

    def load(self) -> dict:
        """Free pages, pool occupancy, queued and running requests."""
        return {"free_pages": self.pools.free_pages(),
                "occupancy": self.pools.occupancy(),
                "queued": len(self._queue),
                "running": sum(r is not None for r in self._slot_rid)}

    def step(self) -> list:
        """One scheduling round; returns the requests that reached a
        terminal status in it."""
        self._round += 1
        self._progress = False
        outs = self._expire_deadlines()
        t0 = time.time()
        self._admit(outs)
        self._advance_ingest(outs)
        self.admission_stall_s += time.time() - t0
        if bool(self.act.any()):
            self._burst_guarded(outs)
        outs.extend(self._retire_guarded())
        self._watchdog()
        return outs

    @property
    def busy(self) -> bool:
        """A request is queued, ingesting, decoding, or finished and not yet
        retired (a retire fault defers retirement by one round)."""
        return (bool(self._queue) or bool(self.act.any())
                or any(r is not None for r in self._slot_rid))

    def drain(self) -> list:
        """Step until every submitted request has finished, then check that
        every page is back on the free list."""
        out = []
        while self.busy:
            out.extend(self.step())
        self.pools.assert_quiescent()
        return out

    # ------------------------------------------------------------ internals
    def _pages_for(self, req: ServeRequest) -> int:
        return -(-(len(req.tokens) + req.max_new_tokens) // self.page)

    def _saturated(self, msg: str, hint: float, occ: float,
                   queued: int) -> EngineSaturated:
        err = EngineSaturated(msg)
        err.retry_after_s, err.occupancy, err.queued = hint, occ, queued
        return err

    def _retry_after(self) -> float:
        """The service time of a request (EMA of finished latencies, 0.1 s
        before the first) times the requests ahead, over the slots."""
        ema = self._service_ema if self._service_ema is not None else 0.1
        return ema * (len(self._queue) + 1) / self.max_slots

    def _check_fault(self, stage: str) -> None:
        if self.fault_plan is not None:
            self.fault_plan.check(self._round, stage)

    def _expire_deadlines(self) -> list:
        now = self._now()

        def expired(rid, req):
            d = req.sampling.deadline_s
            return d > 0 and now - self._submit_time[rid] > d

        outs, keep = [], []
        for ent in self._queue:
            if expired(ent.rid, ent.req):
                outs.append(self._finish(ent.rid, ent.req,
                                         list(ent.resume or []),
                                         "deadline_exceeded"))
            else:
                keep.append(ent)
        self._queue = keep
        for s in range(self.max_slots):
            rid = self._slot_rid[s]
            if rid is not None and expired(rid, self._slot_req[s]):
                outs.append(self._fail_slot(s, "deadline_exceeded"))
        if outs:
            self._progress = True
        return outs

    # ------------------------------------------------------------ admission
    def _admit(self, outs: list) -> None:
        while self._queue:
            ent = min(self._queue, key=lambda e: e.key)
            need = self._pages_for(ent.req)
            slot = next((s for s in range(self.max_slots)
                         if self._slot_rid[s] is None), None)
            if slot is None:
                # only a strict priority inversion takes a slot: equal
                # priorities keep theirs
                victims = self._victims(ent, strict=True)
                if not victims or not self._fits_after(need, victims):
                    return
                slot = victims[0]
                self._preempt(slot, ent.rid)
            if need > self.pools.free_pages():
                if not self._preempt_to_fit(need, ent):
                    if any(r is not None for r in self._slot_rid):
                        return  # wait for a retirement to free pages
                    # nothing runs and it still does not fit: raise the
                    # allocator's sizing error
                    self.pools.alloc(need, context=f" (request {ent.rid})")
            self._queue.remove(ent)
            held = list(ent.resume or [])[:ent.req.max_new_tokens]
            try:
                self._check_fault("admit")
                ids = self.pools.alloc(need, context=f" (request {ent.rid})")
            except Exception as e:
                if not self.retry.is_recoverable(e):
                    raise
                outs.append(self._finish(ent.rid, ent.req, held, "failed",
                                         error=repr(e)))
                continue
            try:
                if ent.resume is not None:
                    self._start_resume(slot, ent, ids)
                elif (self.prefill_chunk is not None
                        and len(ent.req.tokens) > self.prefill_chunk):
                    self._start_chunked(slot, ent.rid, ent.req, ids)
                else:
                    self._start(slot, ent.rid, ent.req, ids)
            except Exception as e:
                if not self.retry.is_recoverable(e):
                    raise
                # a poisoned request: free its pages and slot, fail it alone
                self.pools.release(ids)
                self._clear_slot(slot)
                outs.append(self._finish(ent.rid, ent.req, held, "failed",
                                         error=repr(e)))
                continue
            self._progress = True

    def _victims(self, ent: _QueueEntry, *, strict: bool) -> list:
        """Slots that may be preempted to admit ``ent``, best victim first
        (lowest priority, then youngest).  A slot qualifies once it has
        decoded at least one fresh token since its (re-)admission, so every
        admission makes progress before it can be evicted and preemption
        cannot livelock.  ``strict``: the victim's priority must be lower
        (a slot); else lower or equal (pages)."""
        eprio = ent.req.sampling.priority
        out = []
        for s in range(self.max_slots):
            rid = self._slot_rid[s]
            if rid is None or self._ingest[s] is not None:
                continue
            if len(self._slot_tokens[s]) - self._slot_base[s] < 1:
                continue
            vprio = self._slot_req[s].sampling.priority
            if vprio < eprio or (not strict and vprio == eprio):
                out.append((vprio, -rid, s))
        return [s for _, _, s in sorted(out)]

    def _fits_after(self, need: int, victims: list) -> bool:
        have = self.pools.free_pages()
        have += sum(len(self._slot_pages[s]) for s in victims)
        return need <= have

    def _preempt_to_fit(self, need: int, ent: _QueueEntry) -> bool:
        """Preempt eligible victims, best first, until ``need`` pages are
        free; preempt nobody (False) when all of them would not do."""
        victims = self._victims(ent, strict=False)
        if not self._fits_after(need, victims):
            return False
        for s in victims:
            if need <= self.pools.free_pages():
                break
            self._preempt(s, ent.rid)
        return True

    def _preempt(self, slot: int, for_rid: int) -> None:
        """Evict the request in ``slot``: free its pages, keep its emitted
        tokens and queue it again under its own id."""
        rid = self._slot_rid[slot]
        req = self._slot_req[slot]
        tokens = list(self._slot_tokens[slot])
        self.pools.release(self._slot_pages[slot])
        self._clear_slot(slot)
        self._n_preempted[rid] = self._n_preempted.get(rid, 0) + 1
        self.n_preemptions += 1
        self._queue.append(_QueueEntry(rid, req, resume=tokens))
        self.events.emit("preempt", request=rid, for_request=for_rid,
                         round=self._round, n_tokens=len(tokens),
                         pages_freed=self.pools.free_pages())

    def _start(self, slot: int, rid: int, req: ServeRequest, ids) -> None:
        """Whole-prompt admission: batch-1 prefill, its cache written into
        the slot's first pages, token 0 drawn from its logits."""
        t = len(req.tokens)
        prompt = torch.tensor([req.tokens], device=self.device)
        logits, cache = self.model.prefill(self.params, prompt, cache_len=t)
        n_pp = -(-self.model._cache_len(t) // self.page)
        self.pools.write_prefill(cache, ids[:n_pp])
        tok0 = self._sample_token0(logits, req.sampling)
        self._claim_slot(slot, rid, req, ids)
        self._arm_decode(slot, req, tok0)

    def _start_resume(self, slot: int, ent: _QueueEntry, ids) -> None:
        """Admit a preempted request again: ingest its prompt as at its
        first admission (the same pages, bit for bit; no head product for a
        whole prompt), then replay its emitted tokens in the bursts."""
        req, t = ent.req, len(ent.req.tokens)
        if self.prefill_chunk is not None and t > self.prefill_chunk:
            self._start_chunked(slot, ent.rid, req, ids, resume=ent.resume)
            return
        prompt = torch.tensor([req.tokens], device=self.device)
        _, cache = self.model.prefill(self.params, prompt, cache_len=t,
                                      logits=False)
        n_pp = -(-self.model._cache_len(t) // self.page)
        self.pools.write_prefill(cache, ids[:n_pp])
        self._claim_slot(slot, ent.rid, req, ids)
        self._arm_resume(slot, req, ent.resume)

    def _start_chunked(self, slot: int, rid: int, req: ServeRequest, ids,
                       resume: Optional[list] = None) -> None:
        """Claim a slot for chunk-by-chunk ingestion: pages reserved, no
        compute yet.  ``_advance_ingest`` moves it one chunk a round; the
        slot stays inactive until its last chunk draws token 0 or, for a
        resume, arms the replay."""
        self._claim_slot(slot, rid, req, ids)
        state = (self.model.init_ingest(len(req.tokens))
                 if self.prefill_attn == "exact" else None)
        self._ingest[slot] = {"start": 0, "state": state, "resume": resume}

    def _claim_slot(self, slot: int, rid: int, req: ServeRequest,
                    ids: list) -> None:
        self._slot_rid[slot] = rid
        self._slot_pages[slot] = ids
        self._slot_tokens[slot] = []
        self._slot_req[slot] = req
        self._slot_base[slot] = 0
        self.tbl[slot] = 0
        self.tbl[slot, :len(ids)] = torch.tensor(ids, dtype=torch.int32)

    def _clear_slot(self, slot: int) -> None:
        self._slot_rid[slot] = self._slot_pages[slot] = None
        self._slot_tokens[slot] = self._slot_req[slot] = None
        self._ingest[slot] = self._replay[slot] = None
        self._slot_base[slot] = 0
        self.act[slot] = False

    def _advance_ingest(self, outs: list) -> None:
        """Advance every ingesting slot by ONE prompt chunk."""
        for s in range(self.max_slots):
            ing = self._ingest[s]
            if ing is None:
                continue
            try:
                self._check_fault("ingest")
            except Exception as e:
                if not self.retry.is_recoverable(e):
                    raise
                outs.append(self._fail_slot(s, "failed", error=repr(e)))
                continue
            req = self._slot_req[s]
            t = len(req.tokens)
            start = ing["start"]
            n = min(self.prefill_chunk, t - start)
            last = start + n >= t
            chunk = torch.tensor([req.tokens[start:start + n]],
                                 device=self.device)
            pages = self._slot_pages[s]
            tbl = None
            if ing["state"] is None:
                tbl = torch.tensor(pages[:start // self.page],
                                   dtype=torch.int32, device=self.device)
            logits, cc = self.model.paged_extend_step(
                self.params, chunk, start, ing["state"], t_total=t,
                last=last, pools=self.pools.pools, page_tbl=tbl)
            first = start // self.page
            self.pools.write_prefill(cc, pages[first:first + -(-n // self.page)])
            self._progress = True
            if not last:
                ing["start"] = start + n
                continue
            self._ingest[s] = None
            if ing["resume"] is not None:
                self._arm_resume(s, req, ing["resume"])
            else:
                self._arm_decode(s, req,
                                 self._sample_token0(logits, req.sampling))

    def _sample_token0(self, logits, sp: SamplingParams) -> int:
        """Token 0 from the prefill logits: the draw ``generate`` makes at
        (seed, 0)."""
        return int(sample_tokens(
            logits, torch.full((1,), sp.temperature, device=self.device),
            torch.full((1,), sp.seed, device=self.device),
            torch.zeros((1,), dtype=torch.int64, device=self.device),
            sampled=sp.temperature > 0)[0])

    def _arm_sampling(self, slot: int, req: ServeRequest) -> None:
        sp = req.sampling
        self.pos[slot] = len(req.tokens)
        self.nem[slot] = 1
        self.temp[slot] = sp.temperature
        self.seeds[slot] = sp.seed
        self.eos[slot] = sp.eos_token
        self.max_new[slot] = req.max_new_tokens

    def _arm_decode(self, slot: int, req: ServeRequest, tok0: int) -> None:
        """Record token 0 and arm the slot's decode rows (inactive at once
        when token 0 already ends the request)."""
        self._first_token_time[self._slot_rid[slot]] = self._now()
        self._slot_tokens[slot] = [tok0]
        # token 0 is admission work: the slot may be preempted only after a
        # burst has decoded a fresh token
        self._slot_base[slot] = 1
        self._arm_sampling(slot, req)
        self.tok[slot, 0] = tok0
        self.act[slot] = not (req.max_new_tokens == 1
                              or tok0 == req.sampling.eos_token)

    def _arm_resume(self, slot: int, req: ServeRequest,
                    tokens: list) -> None:
        """Arm decode to continue a preempted stream: the slot enters the
        burst as if it had just drawn token 0 (input ``tokens[0]`` at the
        prompt's end, ``nem = 1``) with ``tokens[1:]`` queued as forced
        outputs.  Once they are replayed ``nem`` is ``len(tokens)`` and the
        next draw is (seed, len(tokens)), where the stream stopped."""
        self._slot_tokens[slot] = list(tokens)
        self._slot_base[slot] = len(tokens)
        self._replay[slot] = collections.deque(tokens[1:]) or None
        self._arm_sampling(slot, req)
        self.tok[slot, 0] = tokens[0]
        self.act[slot] = True

    # --------------------------------------------------------------- decode
    def _burst_guarded(self, outs: list) -> None:
        """The burst under the retry policy.  An injected fault fires before
        any device work, so a retry runs the same burst on the same pools
        and rows; past ``max_restarts`` the decoding requests fail and the
        engine serves on."""
        attempt = 0
        while True:
            try:
                self._check_fault("burst")
                self._burst()
                return
            except Exception as e:
                if not self.retry.is_recoverable(e):
                    raise
                attempt += 1
                if attempt > self.retry.max_restarts:
                    self.events.emit("burst_poisoned", round=self._round,
                                     attempts=attempt, error=repr(e))
                    for s in range(self.max_slots):
                        if (self._slot_rid[s] is not None
                                and self._ingest[s] is None):
                            outs.append(self._fail_slot(s, "failed",
                                                        error=repr(e)))
                    return
                back = self.retry.backoff(attempt)
                self.events.emit("burst_retry", round=self._round,
                                 attempt=attempt, backoff_s=back,
                                 error=repr(e))
                if back:
                    time.sleep(back)

    def _burst_rows(self) -> dict:
        """The host rows of the next burst: the slot state (page table,
        token, position, emitted count, liveness, sampling, EOS, budget)
        and ``forced``/``fmask`` (steps, slots), the replayed tokens (at a
        masked step the slot takes the forced token in place of its draw).
        All of fixed shape."""
        R, b = self.burst_steps, self.max_slots
        forced = torch.zeros((R, b), dtype=torch.int64)
        fmask = torch.zeros((R, b), dtype=torch.bool)
        for s in range(b):
            q = self._replay[s]
            if q:
                k = min(R, len(q))
                forced[:k, s] = torch.tensor(list(itertools.islice(q, k)))
                fmask[:k, s] = True
        return {"tbl": self.tbl, "tok": self.tok, "pos": self.pos,
                "nem": self.nem, "act": self.act, "temp": self.temp,
                "seeds": self.seeds, "eos": self.eos,
                "max_new": self.max_new, "forced": forced, "fmask": fmask}

    def _burst(self) -> None:
        """``burst_steps`` paged decode steps with the slot state on the
        device (``decode_burst``, a graph replay with ``loop="graph"``); one
        read-back at the end."""
        rows = self._burst_rows()
        consumed = rows["fmask"].sum(0).tolist()  # replayed, per slot
        sampled = bool((self.temp > 0).any())
        if self.loop == "graph":
            for name, a in rows.items():
                self._static[name].copy_(a)
            out = self.graphs[sampled].run()
        else:
            ins = {name: a.to(self.device) for name, a in rows.items()}
            out = decode_burst(self.model, self.params, self.pools.pools,
                               ins, self.burst_steps, sampled)
        tok, pos, nem, act, toks, emitted = (a.cpu() for a in out)
        self.tok, self.pos, self.nem, self.act = tok, pos, nem, act
        if bool(emitted.any()):
            self._progress = True  # a replay advancing is progress too
        for s in range(self.max_slots):
            if self._slot_rid[s] is None or self._ingest[s] is not None:
                continue
            k = consumed[s]
            if k:  # the first k emissions replay tokens already held
                for _ in range(k):
                    self._replay[s].popleft()
                if not self._replay[s]:
                    self._replay[s] = None
            self._slot_tokens[s].extend(
                int(t) for t in toks[emitted[:, s], s][k:])

    # --------------------------------------------------------------- retire
    def _retire_guarded(self) -> list:
        try:
            self._check_fault("retire")
        except Exception as e:
            if not self.retry.is_recoverable(e):
                raise
            # retirement is host bookkeeping and idempotent: the finished
            # slots stay one more round
            self.events.emit("retire_deferred", round=self._round,
                             error=repr(e))
            return []
        return self._retire()

    def _retire(self) -> list:
        finished = []
        for s in range(self.max_slots):
            rid = self._slot_rid[s]
            if rid is None or bool(self.act[s]) or self._ingest[s] is not None:
                continue
            self.pools.release(self._slot_pages[s])
            req = self._slot_req[s]
            toks = self._slot_tokens[s][:req.max_new_tokens]
            self._clear_slot(s)
            finished.append(self._finish(rid, req, toks, "ok"))
        return finished

    def _fail_slot(self, slot: int, status: str,
                   error: Optional[str] = None) -> RequestOutput:
        """End the request in ``slot`` with a status other than ok: free its
        pages, clear the slot, keep the tokens it has."""
        rid = self._slot_rid[slot]
        req = self._slot_req[slot]
        toks = list(self._slot_tokens[slot] or [])[:req.max_new_tokens]
        self.pools.release(self._slot_pages[slot])
        self._clear_slot(slot)
        return self._finish(rid, req, toks, status, error=error)

    def _finish(self, rid: int, req: ServeRequest, tokens: list,
                status: str, error: Optional[str] = None) -> RequestOutput:
        """The terminal record of ``rid``: every request ends here once."""
        n_pre = self._n_preempted.pop(rid, 0)
        if status == "ok" and n_pre:
            status = f"preempted_{n_pre}"
        out = RequestOutput(
            request_id=rid,
            tokens=tokens,
            prompt_len=len(req.tokens),
            submit_time=self._submit_time.pop(rid),
            finish_time=self._now(),
            first_token_time=self._first_token_time.pop(rid, 0.0),
            status=status,
            n_preempted=n_pre)
        if out.finished_ok:
            lat = out.latency
            self._service_ema = (lat if self._service_ema is None
                                 else 0.7 * self._service_ema + 0.3 * lat)
        else:
            self.events.emit("request_" + status, request=rid,
                             round=self._round, n_tokens=len(tokens),
                             **({"error": error} if error else {}))
        self._progress = True
        return out

    # ------------------------------------------------------------- watchdog
    def _watchdog(self) -> None:
        """A busy engine must make progress every round (a token decoded, a
        chunk ingested, a request admitted or ended).  ``watchdog_rounds``
        idle rounds emit ``stuck_round``; twice that raises
        :class:`EngineStuck`."""
        if not self.busy or self._progress:
            self._idle_rounds = 0
            return
        self._idle_rounds += 1
        if self._idle_rounds == self.watchdog_rounds:
            self.events.emit("stuck_round", round=self._round,
                             idle_rounds=self._idle_rounds,
                             queued=len(self._queue),
                             free_pages=self.pools.free_pages())
        if self._idle_rounds >= 2 * self.watchdog_rounds:
            raise EngineStuck(
                f"no scheduling progress for {self._idle_rounds} rounds "
                f"(round {self._round}: {len(self._queue)} queued, "
                f"{self.pools.free_pages()} of {self.pools.n_pages} pages "
                "free) — the engine is wedged; see the stuck_round event")
