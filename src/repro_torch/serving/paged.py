"""Block-paged quantized KV storage: per-layer code and scale pools, a
free-list allocator, and the prefill -> pages write.

A page holds the codec's ``page_tokens`` (= ``cfg.kv_chunk``) tokens, so a
kv2 scale group never straddles a page and one page is one tile of the
paged kernels.  Every layer's pools have the same ``n_pages``: one page id
addresses that page in every layer, which is why one page table per
request serves the whole stack.

Page 0 is the trash page: inactive engine slots append there, and unused
page-table entries point at it.  The kernels never read a row past a
request's position, so trash and stale entries never reach a result.

Unlike the reference, whose free stack lives on the device, the free list
here is a host-side Python list: allocation happens only at admission and
retirement, between decode bursts, where the host is in charge anyway.
The pools themselves live on the device and are written in place.
"""
from __future__ import annotations

import torch


class PageAllocatorExhausted(RuntimeError):
    """The pool cannot satisfy an allocation; carries ``need``, ``have``,
    ``occupancy`` and ``retry_after_s`` (None unless the raiser knows when
    pages will free) for programmatic callers."""


class PageAccountingError(RuntimeError):
    """Double free, trash-page release, or a page leak after a drain: the
    free list no longer matches the pages handed out, which would alias
    pages across live requests on a later allocation."""


class PagedPools:
    """Shared paged KV pools and their allocator for one model.

    ``n_pages`` counts allocatable pages; one trash page (id 0) is added.
    ``pools`` is a list of per-layer dicts with the entries of the layer's
    own cache (``model.init_cache``) and a page axis in place of the batch
    and sequence axes: GQA ``{"k", "ks", "v", "vs"}`` of shapes (n_pages +
    1, page, KV, w) and (n_pages + 1, page // chunk, KV); MLA ``{"c",
    "cs", "r", "rs"}`` of shapes (n_pages + 1, page, w) and (n_pages + 1,
    page // chunk)."""

    def __init__(self, model, n_pages: int):
        codec = model.codec
        if not codec.quantized:
            raise ValueError(
                "paged serving stores quantized codes — build the model "
                "with kv_bits=8 or kv_bits=2 (kv_bits=0 has no code/scale "
                "layout to page; use launch.serve.generate instead)")
        self.model = model
        self.codec = codec
        self.page = codec.page_tokens
        self.n_pages = n_pages
        layer = model.init_cache(1, self.page)
        total = n_pages + 1  # + trash page 0
        self.pools = [{key: torch.zeros((total,) + a.shape[1:], dtype=a.dtype,
                                        device=a.device)
                       for key, a in c.items()} for c in layer]
        self._free = list(range(n_pages, 0, -1))  # a stack: pop() = 1 first
        self._live: set[int] = set()

    def free_pages(self) -> int:
        return len(self._free)

    def occupancy(self) -> float:
        """Live fraction of the pool (0.0 empty .. 1.0 full)."""
        return 1.0 - self.free_pages() / self.n_pages

    def resident_bytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for c in self.pools for a in c.values())

    def page_bytes(self) -> int:
        return self.resident_bytes() // (self.n_pages + 1)

    def sizing(self, prompt_len: int, max_new: int) -> str:
        """One sentence of request sizing math, shared by the engine's
        errors and the allocator's."""
        need = -(-(prompt_len + max_new) // self.page)
        return (f"{prompt_len} prompt + {max_new} new tokens at "
                f"{self.page}/page = {need} pages")

    def exhausted(self, n: int, *, context: str = "",
                  have: int | None = None,
                  retry_after_s: float | None = None
                  ) -> PageAllocatorExhausted:
        """The actionable error for an allocation of ``n`` pages that cannot
        be met — raised by ``alloc``, and by ``Engine.submit`` (with
        ``have`` the pool's capacity) for a request that can never fit.
        The message carries the live occupancy, and a retry-after sentence
        when the caller passes ``retry_after_s`` (kept as an attribute
        too)."""
        have = self.free_pages() if have is None else have
        occ = 1.0 - have / self.n_pages
        hint = (f"  Retry after ~{retry_after_s:.2f}s."
                if retry_after_s is not None else "")
        err = PageAllocatorExhausted(
            f"page allocator exhausted{context}: need {n} pages, "
            f"{have} of {self.n_pages} free (occupancy {occ:.0%}, page = "
            f"{self.page} tokens).  Retire requests, raise n_pages (one "
            f"page is ~{self.page_bytes() / 1e3:.1f}KB across all layers), "
            f"or lower max_new_tokens/prompt lengths.{hint}")
        err.need, err.have, err.occupancy = n, have, occ
        err.retry_after_s = retry_after_s
        return err

    def alloc(self, n: int, *, context: str = "") -> list[int]:
        """Reserve ``n`` pages (freshly released pages first)."""
        if n > self.free_pages():
            raise self.exhausted(n, context=context)
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            if i in self._live or i == 0:  # pragma: no cover - drift guard
                raise PageAccountingError(
                    f"allocator handed out page {i}, which is "
                    f"{'the trash page' if i == 0 else 'already live'}")
            self._live.add(i)
        return ids

    def release(self, ids) -> None:
        ids = [int(i) for i in ids]
        for i in ids:
            if i == 0:
                raise PageAccountingError(
                    "attempt to release the reserved trash page (id 0)")
            if i not in self._live:
                raise PageAccountingError(
                    f"double free: page {i} is not live "
                    f"({self.free_pages()} of {self.n_pages} already free)")
        if len(set(ids)) != len(ids):
            raise PageAccountingError(
                f"duplicate page ids in one release: {sorted(ids)}")
        self._live.difference_update(ids)
        self._free.extend(reversed(ids))

    def assert_quiescent(self) -> None:
        """Every allocated page is back on the free list (``Engine.drain``
        calls this after the last retirement)."""
        if self._live or self.free_pages() != self.n_pages:
            live = sorted(self._live)
            raise PageAccountingError(
                f"page leak after drain: {self.free_pages()} of "
                f"{self.n_pages} pages free, {len(live)} still marked "
                f"live: {live[:16]}{'...' if len(live) > 16 else ''}")

    def write_prefill(self, cache: list[dict], ids) -> None:
        """Write a batch-1 prefill cache (per-layer entries of S rows, S a
        page multiple) into pages ``ids``, codes to codes."""
        idx = torch.as_tensor(list(ids), dtype=torch.long,
                              device=self.model.device)
        n = idx.numel()
        for pool, c in zip(self.pools, cache):
            for key, a in c.items():
                pool[key][idx] = a[0].reshape((n, -1) + a.shape[2:]).to(
                    pool[key].dtype)
