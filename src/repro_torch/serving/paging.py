"""Paged KV-cache bookkeeping: page allocator, refcounts, prefix registry.

The port's copy of the JAX package's `repro.serving.paging`, kept whole
(numpy only, so it runs the same on any host); the port imports nothing of
the JAX package, and `tests/test_torch_paging.py` holds the two equal.

The serving engine's paged KV layout (`ServingEngine(kv_layout="paged")`)
splits the cache into fixed-size pages of ``page_size`` tokens living in one
shared device pool; every decode slot and admission-lane row holds a *page
table* (a short list of physical page ids) instead of a dense ``max_len``
allocation. This module is the host-side brain of that layout:

* a **free list** of physical pages, recycled across slot retire/refill and
  admission-lane parking (splicing a parked row into a decode slot moves a
  page list between host records — zero device copies);
* **refcounts** per page, so shared-prefix pages outlive individual readers
  and are returned to the free list only when the last reader retires;
* a **prefix registry**: prompts register their full prompt pages under a
  token-chain key (and, at prompt completion, a frozen snapshot of the final
  partial page), and later admissions whose prompt starts with a registered
  chain map those pages instead of re-prefilling them. A reader that must
  *write* into a matched page — its prompt diverges inside the page, or
  generation appends to it — gets a **copy-on-write fork**: a fresh page is
  allocated and the shared content copied, so registered pages are immutable
  (the write path never touches a page with more than one reference).

Allocation policy is full reservation: `admit` allocates every page a
request can touch (prompt + clamped decode budget) up front, so the decode
loop never allocates mid-flight and free-list exhaustion surfaces only at
admission, where the engine can simply defer the request. Device-side data
movement (the COW copies) is returned to the caller as ``(src, dst)`` page
id pairs; the allocator itself never touches device memory.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

NULL_PAGE = 0  # physical page 0 is reserved: dead/pad rows point (and
# scribble) here; real rows never receive it, and gathers through it are
# masked by `layers.page_valid_mask`.


class PageCacheFull(RuntimeError):
    """Raised when an allocation cannot be satisfied even after evicting
    every reclaimable prefix-registry entry."""


@dataclasses.dataclass
class _PrefixEntry:
    """One registered page of a prompt-prefix chain (or a frozen snapshot
    of a final partial page)."""

    page: int
    n_tokens: int            # tokens of the chain this entry completes
    last_hit: int = 0        # LRU clock for eviction


@dataclasses.dataclass
class Admission:
    """What `PageAllocator.admit` hands the engine for one request."""

    pages: list[int]         # physical pages covering the row's capacity
    base: int                # prompt tokens already cached (skip prefill)
    copies: list[tuple[int, int]]  # device page copies (src, dst) to apply


class PageAllocator:
    """Host-side page bookkeeping for the paged KV cache.

    ``num_pages`` counts physical pages including the reserved null page;
    ``page_size`` is tokens per page. All methods are O(pages touched);
    nothing here allocates device memory.
    """

    def __init__(self, num_pages: int, page_size: int, *,
                 prefix_cache: bool = True):
        """Build an allocator over ``num_pages`` physical pages (page 0 is
        reserved as the null/scratch page and never handed out)."""
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.prefix_cache = prefix_cache
        self.refs = np.zeros(self.num_pages, np.int32)
        self.refs[NULL_PAGE] = 1                     # permanently resident
        self._free: list[int] = list(range(self.num_pages - 1, 0, -1))
        # full-page chains: key = tokens[:k*page_size].tobytes() -> entry
        # holding the k-th page; partial tails: key = full-chain bytes ->
        # (tail token bytes, entry) holding a frozen snapshot page
        self._chains: dict[bytes, _PrefixEntry] = {}
        self._partials: dict[bytes, tuple[bytes, _PrefixEntry]] = {}
        self._clock = 0
        # pages parked aside by `squeeze` (simulated external pressure):
        # neither free nor referenced until `unsqueeze` returns them
        self._squeezed: list[int] = []
        self.stats = {
            "allocs": 0, "frees": 0, "cow_forks": 0, "evictions": 0,
            "prefix_hits": 0, "prefix_hit_tokens": 0, "peak_in_use": 0,
            "squeezed": 0, "registry_sheds": 0,
        }

    # ------------------------------------------------------------------
    # core alloc/free
    # ------------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        """Pages immediately available without evicting registry entries."""
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Pages currently referenced (excluding the null page)."""
        return self.num_pages - 1 - len(self._free)

    def _take(self) -> int:
        if not self._free:
            raise PageCacheFull(
                f"page pool exhausted ({self.num_pages - 1} usable pages)")
        p = self._free.pop()
        assert self.refs[p] == 0
        self.refs[p] = 1
        self.stats["allocs"] += 1
        self.stats["peak_in_use"] = max(self.stats["peak_in_use"],
                                        self.in_use)
        return p

    def alloc(self, n: int = 1) -> list[int]:
        """Allocate ``n`` fresh pages (refcount 1 each), evicting
        reclaimable prefix-registry entries if the free list runs dry.
        Raises `PageCacheFull` — after rolling back the partial grab — if
        the pool cannot satisfy the request."""
        if len(self._free) < n:
            self._evict(n - len(self._free))
        if len(self._free) < n:
            raise PageCacheFull(
                f"need {n} pages, {len(self._free)} free of "
                f"{self.num_pages - 1} usable")
        return [self._take() for _ in range(n)]

    def retain(self, pages: list[int]) -> None:
        """Add one reference to each page (a new reader of shared pages)."""
        for p in pages:
            assert p != NULL_PAGE and self.refs[p] > 0
            self.refs[p] += 1

    def release(self, pages: list[int]) -> None:
        """Drop one reference per page; pages reaching zero return to the
        free list (the last-reader-retires contract)."""
        for p in pages:
            if p == NULL_PAGE:
                continue
            assert self.refs[p] > 0, f"double free of page {p}"
            self.refs[p] -= 1
            if self.refs[p] == 0:
                self._free.append(p)
                self.stats["frees"] += 1

    # ------------------------------------------------------------------
    # prefix registry
    # ------------------------------------------------------------------
    def _key(self, tokens: np.ndarray, n: int) -> bytes:
        return np.ascontiguousarray(tokens[:n], np.int32).tobytes()

    def _evict(self, need: int) -> None:
        """Drop LRU registry entries whose page only the registry holds
        (evicting shared entries would reclaim nothing) until ``need``
        pages were freed or no reclaimable entry remains."""
        freed = 0
        order = sorted(
            [(e.last_hit, k, None) for k, e in self._chains.items()
             if self.refs[e.page] == 1]
            + [(e.last_hit, k, t) for k, (t, e) in self._partials.items()
               if self.refs[e.page] == 1])
        for _, key, tail in order:
            if freed >= need:
                break
            entry = (self._partials.pop(key)[1] if tail is not None
                     else self._chains.pop(key))
            self.release([entry.page])
            self.stats["evictions"] += 1
            freed += 1

    def match(self, prompt: np.ndarray) -> tuple[list[int], int]:
        """Longest registered prefix of ``prompt``: full-page chain walk,
        then an optional partial tail. Returns (shared pages, tokens
        covered) WITHOUT retaining — `admit` does the bookkeeping."""
        if not self.prefix_cache:
            return [], 0
        T = self.page_size
        pages: list[int] = []
        k = 0
        while (k + 1) * T <= len(prompt):
            e = self._chains.get(self._key(prompt, (k + 1) * T))
            if e is None:
                break
            self._clock += 1
            e.last_hit = self._clock
            pages.append(e.page)
            k += 1
        covered = k * T
        part = self._partials.get(self._key(prompt, covered))
        if part is not None:
            tail, e = part
            n_tail = e.n_tokens - covered
            if (covered + n_tail <= len(prompt)
                    and self._key(prompt[covered:], n_tail) == tail):
                self._clock += 1
                e.last_hit = self._clock
                pages.append(e.page)
                covered = e.n_tokens
        return pages, covered

    # ------------------------------------------------------------------
    # engine-facing operations
    # ------------------------------------------------------------------
    def admit(self, prompt: np.ndarray, budget: int, *,
              prefix_rows: int = 0, reuse: bool = True) -> Admission:
        """Reserve a request's full page capacity (prompt + ``budget``
        generated tokens), reusing registered shared-prefix pages.

        The returned ``base`` is how many leading prompt tokens are already
        cached (always <= len(prompt) - 1, so the final prompt token is
        recomputed and its logits can seed sampling). Any matched page the
        row will *write* into — the page containing ``base`` — is forked
        copy-on-write; ``copies`` lists the device page copies to apply.
        Raises `PageCacheFull` with no state change when the pool cannot
        cover the reservation.

        ``prefix_rows`` reserves extra leading cache rows written by an
        admission hook ahead of the prompt (e.g. a VLM patch prefix);
        ``reuse=False`` skips prefix matching entirely — admit-family rows
        carry modality-dependent cache content, so token-keyed sharing
        would be unsound (``base`` stays 0).
        """
        T = self.page_size
        plen = len(prompt)
        n_total = max(1, math.ceil(
            (int(prefix_rows) + plen + max(budget, 1)) / T))
        if not reuse:
            owned = self.alloc(n_total)
            return Admission(pages=owned, base=0, copies=[])
        shared, covered = self.match(prompt)
        base = min(covered, plen - 1)
        # the page holding position `base` gets written -> must be owned
        n_keep = min(len(shared), base // T)
        fork_src = shared[n_keep] if n_keep < len(shared) else None
        n_own = n_total - n_keep
        if len(self._free) < n_own:
            self._evict(n_own - len(self._free))
            # eviction may have dropped the entries we just matched; the
            # conservative re-match keeps bookkeeping consistent
            shared, covered = self.match(prompt)
            base = min(covered, plen - 1)
            n_keep = min(len(shared), base // T)
            fork_src = shared[n_keep] if n_keep < len(shared) else None
            n_own = n_total - n_keep
        owned = self.alloc(n_own)                     # raises if short
        kept = shared[:n_keep]
        self.retain(kept)
        copies: list[tuple[int, int]] = []
        if fork_src is not None:
            copies.append((int(fork_src), int(owned[0])))
            self.stats["cow_forks"] += 1
        if base > 0:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] += base
        return Admission(pages=kept + owned, base=base, copies=copies)

    def register(self, prompt: np.ndarray, pages: list[int],
                 written: int) -> list[tuple[int, int]]:
        """Register the prompt pages a row has fully cached so far.

        Every full page covered by ``written`` prompt tokens joins the
        chain registry (idempotent; the registry takes one reference per
        new entry). When the whole prompt is cached and ends mid-page, a
        frozen *snapshot* of the partial page is registered instead of the
        live page — the row keeps appending generated tokens to its own
        copy — which costs one device page copy, returned as (src, dst).
        Registration is best-effort: pool exhaustion skips the snapshot
        rather than failing admission-critical allocation paths.
        """
        if not self.prefix_cache:
            return []
        T = self.page_size
        plen = len(prompt)
        for j in range(min(written, plen) // T):
            key = self._key(prompt, (j + 1) * T)
            if key in self._chains:
                continue
            self._clock += 1
            self.retain([pages[j]])
            self._chains[key] = _PrefixEntry(
                page=pages[j], n_tokens=(j + 1) * T, last_hit=self._clock)
        copies: list[tuple[int, int]] = []
        if written >= plen and plen % T:
            k = plen // T
            key = self._key(prompt, k * T)
            if key not in self._partials:
                try:
                    (snap,) = self.alloc(1)
                except PageCacheFull:
                    return copies
                self._clock += 1
                copies.append((int(pages[k]), int(snap)))
                self._partials[key] = (
                    self._key(prompt[k * T:], plen - k * T),
                    _PrefixEntry(page=snap, n_tokens=plen,
                                 last_hit=self._clock))
        return copies

    # ------------------------------------------------------------------
    # degraded modes: pool pressure + registry shedding
    # ------------------------------------------------------------------
    def squeeze(self, n: int) -> int:
        """Remove up to `n` pages from the free list, modelling external
        pool pressure (another tenant, a chaos fault) — the pages are
        parked aside, not freed, and `unsqueeze` returns them. Returns
        how many were actually taken (the free list may be shorter)."""
        take = min(int(n), len(self._free))
        for _ in range(take):
            self._squeezed.append(self._free.pop())
        self.stats["squeezed"] = len(self._squeezed)
        return take

    def unsqueeze(self) -> int:
        """Return every squeezed page to the free list (pressure
        relieved). Returns the count returned."""
        n = len(self._squeezed)
        self._free.extend(self._squeezed)
        self._squeezed.clear()
        self.stats["squeezed"] = 0
        return n

    def shed_registry(self) -> int:
        """Drop EVERY shared-prefix registry entry, releasing the
        registry's reference on each page: sole-owner pages return to
        the free list immediately, shared ones when their last reader
        retires. This is the engine's first response to sustained pool
        pressure — the registry is a latency cache, and shedding it can
        never change token streams (prefix reuse only skips recompute of
        identical KV rows). Returns the number of entries dropped."""
        entries = ([e for e in self._chains.values()]
                   + [e for _, e in self._partials.values()])
        self._chains.clear()
        self._partials.clear()
        for e in entries:
            self.release([e.page])
        self.stats["registry_sheds"] += len(entries)
        return len(entries)

    def report(self) -> dict:
        """Allocator counters for the engine's serving report."""
        return {
            "num_pages": self.num_pages - 1,
            "page_size": self.page_size,
            "pages_in_use": int(self.in_use),
            "pages_free": int(self.free_pages),
            "registry_entries": len(self._chains) + len(self._partials),
            **{k: int(v) for k, v in self.stats.items()},
        }
