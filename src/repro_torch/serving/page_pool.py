"""Host-side page-pool allocator for the paged KV cache (docs/SERVING.md).

The DEVICE side of the paged cache is a per-layer tensor pool
(``models/attention.py::paged_kv_cache_def``); this module owns the HOST
metadata: which physical pages are free, how many holders reference each
page, and the copy-on-write bookkeeping that lets N requests (best-of-N
fan-out, prefix-cache snapshots) map the same physical prefix pages.

A "page" here is a PHYSICAL page id valid across every pool leaf of
every layer — including, under ``kv_dtype="int8"``, the float32 scale
sidecar pools that ride next to the int8 K/V payload.  Refcounts, COW
copies, snapshot pins and per-page nbytes all operate on that id, so
scales travel with their pages through every lifecycle event without
this module knowing the cache dtype.

Invariants (checked by :meth:`PagePool.check`):
  * every page is either on the free list (refcount 0) or held
    (refcount >= 1) — never both;
  * a page's refcount equals the number of holders (request page tables
    + prefix-cache snapshots) — decref of the last holder frees it;
  * WRITES require unique ownership: the engine only scatters into pages
    with refcount 1 (``needs_cow`` tells it when to copy first).

The allocator is deliberately dumb about WHAT to do on exhaustion —
``alloc`` just returns None; eviction of prefix-cache entries and
preemption of victim requests are scheduling policy and live in
serving/engine.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable, List, Optional

PyTree = Any


class PagePool:
    """Free-list + refcount allocator over ``num_pages`` physical pages."""

    def __init__(self, num_pages: int, page_size: int):
        assert num_pages > 0 and page_size > 0
        self.num_pages = num_pages
        self.page_size = page_size
        self.refcount = [0] * num_pages
        # LIFO free list, low page ids handed out first (pop from end)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self.stats = {"allocs": 0, "frees": 0, "cow_copies": 0,
                      "alloc_failures": 0, "peak_in_use": 0,
                      "tail_truncates": 0}

    # ------------------------------------------------------------- queries

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def needs_cow(self, page: int) -> bool:
        """True when a write into ``page`` must copy first (shared)."""
        return self.refcount[page] > 1

    def utilization(self) -> float:
        """Fraction of physical pages currently held (0.0-1.0).  The
        engine's resident-KV accounting scales the pool's device bytes by
        this — allocated pool capacity is not residency."""
        return self.used_pages / self.num_pages

    # ----------------------------------------------------------- lifecycle

    def alloc(self) -> Optional[int]:
        """Grab a free page (refcount 1) or None when exhausted."""
        if not self._free:
            self.stats["alloc_failures"] += 1
            return None
        page = self._free.pop()
        assert self.refcount[page] == 0, "free page with live refs"
        self.refcount[page] = 1
        self.stats["allocs"] += 1
        self.stats["peak_in_use"] = max(self.stats["peak_in_use"],
                                        self.used_pages)
        return page

    def incref(self, pages: Iterable[int]) -> None:
        for p in pages:
            assert self.refcount[p] > 0, f"incref of free page {p}"
            self.refcount[p] += 1

    def decref(self, pages: Iterable[int]) -> None:
        """Drop one reference per page; last holder's drop frees it."""
        for p in pages:
            assert self.refcount[p] > 0, f"decref of free page {p}"
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)
                self.stats["frees"] += 1

    def truncate_tail(self, table_row, keep_pages: int) -> int:
        """Roll back a page-table TAIL: drop this holder's reference on
        every mapped page at logical index >= ``keep_pages`` and unmap it
        (set -1) in ``table_row`` (a mutable [NP] int array).  Returns the
        number of pages released.

        This is the speculative-decode rollback primitive: a failed
        verify leaves pages that were mapped for drafted-but-rejected
        positions; truncating the tail restores the pool invariant that
        every mapped page backs committed (or about-to-be-written)
        tokens.  Pages shared with a snapshot (refcount > 1) merely lose
        this table's reference — the pin keeps them alive.
        """
        released = 0
        for lpage in range(keep_pages, len(table_row)):
            pg = int(table_row[lpage])
            if pg >= 0:
                self.decref([pg])
                table_row[lpage] = -1
                released += 1
        self.stats["tail_truncates"] += released
        return released

    # ----------------------------------------------------------- integrity

    def check(self) -> None:
        """Assert the free-list/refcount invariants (tests, debugging)."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate page on free list"
        for p in range(self.num_pages):
            if p in free:
                assert self.refcount[p] == 0, f"free page {p} has refs"
            else:
                assert self.refcount[p] > 0, f"lost page {p}"


@dataclass
class PagedSnapshot:
    """A prefix-cache entry payload in paged mode: PINNED page references
    instead of a copied cache PyTree.  Publishing one is O(1) — increfs on
    the pages covering the first ``n_tokens`` positions — and reusing one
    maps those same physical pages into the new request's page table.
    ``recurrent`` carries the dense per-request state of mamba/RG-LRU
    layers (hybrid models), which has no paged representation; None for
    attention-pure models."""

    pages: List[int]
    n_tokens: int
    recurrent: Optional[PyTree] = None
    nbytes: int = 0
    meta: dict = field(default_factory=dict)
