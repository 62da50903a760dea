"""Paged KV-cache slot manager: block-granular page accounting with
admission control (port of ``repro.runtime.kv_pages``).

The serving loop's KV memory is modelled as a pool of fixed-size *pages*
(``page_size`` token slots each).  A request reserves its worst-case
footprint — ``ceil((prompt + gen) / page_size)`` pages — at admission, so
the loop can never run out mid-decode: when the pool cannot cover a request
it stays *queued* (or is *rejected* up front when its footprint exceeds the
whole pool), and pages return to the pool the moment a request completes.

Accounting is strict: ``alloc`` raises :class:`PagesExhausted` when the
pool cannot cover the footprint (nothing is partially allocated) and
:class:`PageAccountingError` on double admission; ``free`` raises
:class:`PageAccountingError` for a request that holds no pages;
``assert_quiescent`` proves the pool drained.  ``alloc`` consults the
``kv.alloc`` fault-injection point (``runtime/faults.py``): a ``raise``
there is a transient allocator failure that allocates nothing.
"""

from __future__ import annotations

import dataclasses

from repro_torch.runtime import faults


class PagesExhausted(RuntimeError):
    """Not enough free pages for the request's footprint (transient:
    queue and retry when pages are reclaimed)."""


class PageAccountingError(RuntimeError):
    """A page-ledger invariant was violated (double-alloc, double-free,
    or a leak) — always a serving-runtime bug, never a load condition."""


@dataclasses.dataclass(frozen=True)
class PageAllocation:
    """One request's page reservation."""

    rid: int
    pages: tuple[int, ...]
    tokens: int


class PagePool:
    """Fixed pool of KV pages with an exactly-once alloc/free ledger."""

    def __init__(self, total_pages: int, page_size: int):
        if total_pages < 1 or page_size < 1:
            raise ValueError(
                f"pool wants >=1 pages of >=1 tokens, got "
                f"{total_pages} x {page_size}")
        self.total_pages = total_pages
        self.page_size = page_size
        self._free: list[int] = list(range(total_pages - 1, -1, -1))
        self._held: dict[int, PageAllocation] = {}   # rid -> allocation
        self.high_water = 0
        self.allocs = 0
        self.frees = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.total_pages - len(self._free)

    def pages_for(self, tokens: int) -> int:
        """Footprint in pages of a ``tokens``-long sequence."""
        return max(1, -(-tokens // self.page_size))

    def fits(self, tokens: int) -> bool:
        """Could this request EVER be admitted?  False means reject
        outright (footprint exceeds the whole pool)."""
        return self.pages_for(tokens) <= self.total_pages

    def alloc(self, rid: int, tokens: int) -> PageAllocation:
        """Reserve the full footprint for request ``rid`` atomically."""
        if rid in self._held:
            raise PageAccountingError(
                f"request {rid} already holds {len(self._held[rid].pages)} "
                f"pages (double admission)")
        faults.maybe_inject(faults.KV_ALLOC)
        need = self.pages_for(tokens)
        if need > len(self._free):
            raise PagesExhausted(
                f"request {rid} needs {need} pages, {len(self._free)} free")
        pages = tuple(self._free.pop() for _ in range(need))
        alloc = PageAllocation(rid=rid, pages=pages, tokens=tokens)
        self._held[rid] = alloc
        self.allocs += 1
        self.high_water = max(self.high_water, self.used_pages)
        return alloc

    def free(self, rid: int) -> int:
        """Reclaim request ``rid``'s pages.  Exactly-once: freeing a
        request that holds nothing raises."""
        alloc = self._held.pop(rid, None)
        if alloc is None:
            raise PageAccountingError(
                f"request {rid} holds no pages (double free?)")
        self._free.extend(alloc.pages)
        self.frees += 1
        return len(alloc.pages)

    def holds(self, rid: int) -> bool:
        return rid in self._held

    def assert_quiescent(self) -> None:
        """Every page back in the pool, no request holding any, and the
        free list duplicate-free — the end-of-run ledger proof."""
        if self._held:
            raise PageAccountingError(
                f"pages leaked by requests {sorted(self._held)}")
        if sorted(self._free) != list(range(self.total_pages)):
            raise PageAccountingError(
                f"free list corrupt: {len(self._free)} entries, "
                f"{len(set(self._free))} unique, want {self.total_pages}")

    def stats(self) -> dict:
        return {"total_pages": self.total_pages,
                "page_size": self.page_size,
                "free_pages": self.free_pages,
                "high_water_pages": self.high_water,
                "allocs": self.allocs, "frees": self.frees}
