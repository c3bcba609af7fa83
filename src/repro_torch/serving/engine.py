"""Continuous-batching serve engine over block-paged quantized KV pools.

Requests arrive (``submit``), prefill into freshly allocated pages, join
the running decode batch at the next scheduling round (``step``), and
retire as soon as they reach EOS or their token budget, releasing their
pages for the next admission.  Decode runs in bursts: ``burst_steps``
paged decode steps in a Python loop whose per-slot state (token, position,
emitted count, liveness) stays on the device, so the host reads back once
per burst.  A slot that finishes mid-burst deactivates in place and its
later appends go to the trash page, as the reference's scan does.

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

The reference's overload policy (preemption with replay, deadlines,
priorities, backpressure), fault injection and watchdog are not part of
this engine yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.serving.paged import PagedPools
from repro_torch.serving.sampling import sample_tokens


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Greedy at ``temperature == 0``, else sampled from ``logits /
    temperature`` on the (seed, token index) stream; ``eos_token`` stops a
    request early when drawn (-1: never)."""
    temperature: float = 0.0
    seed: int = 0
    eos_token: int = -1


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
    """Terminal record of one request."""
    request_id: int
    tokens: list
    prompt_len: int
    submit_time: float
    finish_time: float
    first_token_time: float = 0.0
    status: str = "ok"

    @property
    def latency(self) -> float:
        return self.finish_time - self.submit_time

    @property
    def ttft(self) -> float:
        """Submit to the round that drew token 0 from the prefill."""
        return self.first_token_time - self.submit_time

    @property
    def finished_ok(self) -> bool:
        return self.status == "ok"


class Engine:
    """``submit()`` requests, drive rounds with ``step()`` or run them to
    completion with ``drain()``.  A round admits queued requests into free
    slots, advances every ingesting slot by one prompt chunk, runs one
    decode burst over the live slots and retires the finished."""

    def __init__(self, model, params, *, max_slots: int = 4,
                 n_pages: int = 64, max_pages_per_request: int = 8,
                 burst_steps: int = 8, prefill_chunk: Optional[int] = None,
                 prefill_attn: str = "exact"):
        if model.cfg.attn_kind not in ("gqa", "mla"):
            raise ValueError(
                f"paged serving supports GQA and MLA attention, model has "
                f"{model.cfg.attn_kind!r}; serve it through "
                f"launch.serve.generate")
        if prefill_attn not in ("exact", "paged"):
            raise ValueError(f"prefill_attn must be 'exact' or 'paged', got "
                             f"{prefill_attn!r}")
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

        self._queue: list[tuple[int, ServeRequest]] = []
        self._next_rid = 0
        self._slot_rid: list = [None] * b
        self._slot_pages: list = [None] * b
        self._slot_tokens: list = [None] * b
        self._slot_req: list = [None] * b
        self._ingest: list = [None] * b   # chunked-prefill progress
        self._submit_time: dict = {}
        self._first_token_time: dict = {}
        self.admission_stall_s = 0.0

    # ------------------------------------------------------------------ API
    def submit(self, request: ServeRequest) -> int:
        """Queue a request and return its id; admission happens at the next
        ``step()``.  A request that can never fit is rejected here."""
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
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, request))
        self._submit_time[rid] = time.time()
        return rid

    def step(self) -> list:
        """One scheduling round; returns the requests that finished in it."""
        t0 = time.time()
        self._admit()
        self._advance_ingest()
        self.admission_stall_s += time.time() - t0
        if bool(self.act.any()):
            self._burst()
        return self._retire()

    @property
    def busy(self) -> bool:
        return bool(self._queue) or any(r is not None for r in self._slot_rid)

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

    def _admit(self) -> None:
        while self._queue:
            slot = next((s for s in range(self.max_slots)
                         if self._slot_rid[s] is None), None)
            if slot is None:
                return
            rid, req = self._queue[0]
            need = self._pages_for(req)
            if need > self.pools.free_pages():
                return  # wait for a retirement to free pages
            self._queue.pop(0)
            ids = self.pools.alloc(need, context=f" (request {rid})")
            self._claim_slot(slot, rid, req, ids)
            if (self.prefill_chunk is not None
                    and len(req.tokens) > self.prefill_chunk):
                state = (self.model.init_ingest(len(req.tokens))
                         if self.prefill_attn == "exact" else None)
                self._ingest[slot] = {"start": 0, "state": state}
            else:
                self._start(slot, req)

    def _claim_slot(self, slot: int, rid: int, req: ServeRequest,
                    ids: list) -> None:
        self._slot_rid[slot] = rid
        self._slot_pages[slot] = ids
        self._slot_tokens[slot] = []
        self._slot_req[slot] = req
        self.tbl[slot] = 0
        self.tbl[slot, :len(ids)] = torch.tensor(ids, dtype=torch.int32)

    def _start(self, slot: int, req: ServeRequest) -> None:
        """Whole-prompt admission: batch-1 prefill, its cache written into
        the slot's first pages, token 0 drawn from its logits."""
        t = len(req.tokens)
        prompt = torch.tensor([req.tokens], device=self.device)
        logits, cache = self.model.prefill(self.params, prompt, cache_len=t)
        n_pp = -(-self.model._cache_len(t) // self.page)
        self.pools.write_prefill(cache, self._slot_pages[slot][:n_pp])
        self._arm_decode(slot, req, logits)

    def _advance_ingest(self) -> None:
        """Advance every ingesting slot by ONE prompt chunk."""
        for s in range(self.max_slots):
            ing = self._ingest[s]
            if ing is None:
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
            if last:
                self._ingest[s] = None
                self._arm_decode(s, req, logits)
            else:
                ing["start"] = start + n

    def _arm_decode(self, slot: int, req: ServeRequest, logits) -> None:
        """Draw token 0 from the prefill logits and arm the slot's decode
        rows (inactive at once when token 0 already ends the request)."""
        sp = req.sampling
        rid = self._slot_rid[slot]
        tok0 = int(sample_tokens(
            logits, torch.full((1,), sp.temperature, device=self.device),
            torch.full((1,), sp.seed, device=self.device),
            torch.zeros((1,), dtype=torch.int64, device=self.device),
            sampled=sp.temperature > 0)[0])
        self._first_token_time[rid] = time.time()
        self._slot_tokens[slot] = [tok0]
        self.tok[slot, 0] = tok0
        self.pos[slot] = len(req.tokens)
        self.nem[slot] = 1
        self.act[slot] = not (req.max_new_tokens == 1 or tok0 == sp.eos_token)
        self.temp[slot] = sp.temperature
        self.seeds[slot] = sp.seed
        self.eos[slot] = sp.eos_token
        self.max_new[slot] = req.max_new_tokens

    def _burst(self) -> None:
        """``burst_steps`` paged decode steps with the slot state on the
        device; one read-back at the end."""
        dev = self.device
        tbl = self.tbl.to(dev)
        tok, pos, nem, act = (self.tok.to(dev), self.pos.to(dev),
                              self.nem.to(dev), self.act.to(dev))
        temp, seeds = self.temp.to(dev), self.seeds.to(dev)
        eos, max_new = self.eos.to(dev), self.max_new.to(dev)
        sampled = bool((self.temp > 0).any())
        toks, emitted = [], []
        for _ in range(self.burst_steps):
            logits = self.model.paged_decode_step(
                self.params, self.pools.pools, tbl, tok, pos, act)
            nxt = sample_tokens(logits, temp, seeds, nem, sampled=sampled)
            done = act & ((nxt == eos) | (nem + 1 >= max_new))
            toks.append(torch.where(act, nxt, -1))
            emitted.append(act)
            nem = nem + act.long()
            pos = pos + act.long()
            tok = nxt[:, None]
            act = act & ~done
        self.tok, self.pos = tok.cpu(), pos.cpu()
        self.nem, self.act = nem.cpu(), act.cpu()
        toks = torch.stack(toks).cpu()
        emitted = torch.stack(emitted).cpu()
        for s in range(self.max_slots):
            if self._slot_rid[s] is None or self._ingest[s] is not None:
                continue
            self._slot_tokens[s].extend(
                int(t) for t in toks[emitted[:, s], s])

    def _retire(self) -> list:
        finished = []
        for s in range(self.max_slots):
            rid = self._slot_rid[s]
            if rid is None or bool(self.act[s]) or self._ingest[s] is not None:
                continue
            req = self._slot_req[s]
            self.pools.release(self._slot_pages[s])
            finished.append(RequestOutput(
                request_id=rid,
                tokens=self._slot_tokens[s][:req.max_new_tokens],
                prompt_len=len(req.tokens),
                submit_time=self._submit_time.pop(rid),
                finish_time=time.time(),
                first_token_time=self._first_token_time.pop(rid)))
            self._slot_rid[s] = self._slot_pages[s] = None
            self._slot_tokens[s] = self._slot_req[s] = None
        return finished
