"""Token-prefix KV cache — the paper's prompt caching (port of
``repro/serving/prefix_cache.py``).

Entries are keyed by the exact token sequence and hold one of two payload
kinds:

  * DENSE snapshots: a copy of per-layer cache tensors (nested dicts,
    lists and tuples of tensors — the port's cache structure).
  * PAGE-REFERENCE snapshots (paged engines): a
    :class:`repro_torch.serving.page_pool.PagedSnapshot` pinning the
    physical pages that hold the prefix (O(1) insert, zero copy).  The
    cache never touches device memory for these — refcounts are released
    through the entry's ``on_evict`` callback when it is evicted or
    replaced.

Lookup returns the longest stored entry that prefix-matches a new prompt:
full-entry hits are always reusable; PARTIAL hits (stored sequence
diverges after position p) are reusable only for attention-pure models,
truncated to a page-aligned boundary <= p.  Recurrent state summarizes the
entire stored prefix, so partial reuse is impossible for SSM/hybrid
stages — the cache enforces exact-boundary semantics for them.

Besides round-completion snapshots, the chunked-prefill scheduler inserts
PARTIAL-PREFIX snapshots at page-aligned chunk boundaries
(``insert_boundary``), so concurrent same-prompt requests hit before the
first request finishes.

The reference walks its caches with ``jax.tree_util``; here
``tree_leaves`` and ``tree_map_with_key`` walk nested dicts, lists and
tuples of tensors.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.serving.page_pool import PagedSnapshot

RECURRENT_KINDS = {"mamba", "rglru"}


def config_is_recurrent(model_cfg) -> bool:
    """Does this architecture carry mamba/RG-LRU state?  (Such state
    summarizes its whole prefix, which forbids partial and exact-length
    cache reuse — see PrefixCache.lookup.)"""
    pattern = getattr(model_cfg, "block_pattern", ()) or ()
    return bool(set(pattern) & RECURRENT_KINDS)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Tensors of a nested dict/list/tuple, in traversal order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def tree_map_with_key(fn: Callable[[Optional[str], Any], Any], tree: Any,
                      key: Optional[str] = None) -> Any:
    """Rebuild a nested dict/list/tuple applying ``fn(dict_key, leaf)`` to
    every leaf; ``dict_key`` is the nearest enclosing dict key."""
    if isinstance(tree, dict):
        return {k: tree_map_with_key(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_key(fn, v, key) for v in tree)
    return fn(key, tree)


@dataclass
class Entry:
    tokens: Tuple[int, ...]
    cache: Any                     # B=1 dense snapshot OR PagedSnapshot
    on_evict: Optional[Callable[[], None]] = None
    last_used: float = field(default_factory=time.monotonic)
    hits: int = 0

    @property
    def nbytes(self) -> int:
        if isinstance(self.cache, PagedSnapshot):
            return self.cache.nbytes
        return sum(x.numel() * x.element_size()
                   for x in tree_leaves(self.cache))


def _common_prefix(a: Tuple[int, ...], b: Tuple[int, ...]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def truncate_attention_cache(cache: Any, keep_len: int) -> Any:
    """Mask out cached tokens at positions >= keep_len (attention-only)."""
    return tree_map_with_key(
        lambda k, x: torch.where(x < keep_len, x, -1) if k == "tok" else x,
        cache)


@dataclass
class LookupResult:
    cached_len: int
    cache: Optional[Any]           # dense tree copy OR raw PagedSnapshot
    kind: str                      # "miss" | "full" | "partial"


class PrefixCache:
    """LRU prefix cache over conversation caches."""

    def __init__(self, page_size: int = 256, max_entries: int = 64,
                 recurrent: Optional[bool] = None, model_cfg=None):
        self.page_size = page_size
        self.max_entries = max_entries
        # model has mamba/rglru stages: derived from the architecture's
        # block pattern unless a test overrides it explicitly
        self.recurrent = (config_is_recurrent(model_cfg)
                          if recurrent is None else recurrent)
        self.entries: Dict[Tuple[int, ...], Entry] = {}
        # bumped on EVERY entry-set mutation (insert, replace, eviction);
        # pollers (Engine._fast_forward) compare it to skip scans
        self.version = 0
        self.stats = {"hits": 0, "partial_hits": 0, "misses": 0,
                      "evictions": 0, "tokens_saved": 0,
                      "boundary_snapshots": 0}

    def lookup(self, tokens: List[int], min_len: int = 0,
               record_miss: bool = True, peek: bool = False) -> LookupResult:
        """Longest usable stored prefix of ``tokens``.

        ``min_len``: only return (and only count in stats) an entry
        strictly longer than this — the engine's in-flight fast-forward
        passes its current prefill progress (with ``record_miss=False``)
        so repeated per-tick polling does not inflate the statistics.

        ``peek``: length estimate only — no hit/miss stats, no LRU
        refresh, no cache payload.
        """
        key = tuple(tokens)
        best: Optional[Tuple[int, Entry, str]] = None
        for k, e in self.entries.items():
            p = _common_prefix(key, k)
            if p == len(k) and p > 0:
                # stored sequence is itself a prefix of the new prompt.
                # Recurrent caches: an EXACT-length match is unusable —
                # the stored state already summarizes the last prompt
                # token, which generation must process live.
                if self.recurrent and p == len(key):
                    continue
                if best is None or p > best[0]:
                    best = (p, e, "full")
            elif not self.recurrent and p >= self.page_size:
                cut = (p // self.page_size) * self.page_size
                if best is None or cut > best[0]:
                    best = (cut, e, "partial")
        if best is None or best[0] <= min_len:
            # a candidate too short to use is still a miss for this
            # lookup: hits + partial_hits + misses == recorded lookups
            if record_miss and not peek:
                self.stats["misses"] += 1
            return LookupResult(0, None, "miss")
        plen, entry, kind = best
        if peek:
            return LookupResult(plen, None, kind)
        entry.last_used = time.monotonic()
        entry.hits += 1
        self.stats["hits" if kind == "full" else "partial_hits"] += 1
        self.stats["tokens_saved"] += plen - min_len
        cache = entry.cache
        if isinstance(cache, PagedSnapshot):
            # page references: the engine adopts pages (incref) itself and
            # truncates partial hits by adopting plen // page_size pages
            return LookupResult(plen, cache, kind)
        if kind == "partial":
            cache = truncate_attention_cache(cache, plen)
        # copy leaves so the caller can mutate its cache freely
        cache = tree_map_with_key(
            lambda _, x: x.clone() if isinstance(x, torch.Tensor) else x,
            cache)
        return LookupResult(plen, cache, kind)

    def insert(self, tokens: List[int], cache: Any,
               on_evict: Optional[Callable[[], None]] = None) -> None:
        key = tuple(tokens)
        self.version += 1
        if key in self.entries:
            old = self.entries[key]
            if old.on_evict is not None:
                old.on_evict()            # release replaced payload's pins
            old.cache = cache
            old.on_evict = on_evict
            old.last_used = time.monotonic()
            return
        if len(self.entries) >= self.max_entries:
            victim = min(self.entries.values(), key=lambda e: e.last_used)
            self._evict(victim)
        self.entries[key] = Entry(key, cache, on_evict)

    def _evict(self, entry: Entry) -> None:
        del self.entries[entry.tokens]
        if entry.on_evict is not None:
            entry.on_evict()
        self.stats["evictions"] += 1
        self.version += 1       # evictions mutate the entry set too

    def evict_lru(self) -> bool:
        """Evict the least-recently-used entry (page-pool pressure relief
        for paged engines).  Returns False when the cache is empty."""
        if not self.entries:
            return False
        victim = min(self.entries.values(), key=lambda e: e.last_used)
        self._evict(victim)
        return True

    def wants_boundary(self, tokens: List[int]) -> bool:
        """Should the engine snapshot this partial prefix?  Page-aligned
        boundaries only, and never one that is already stored."""
        return (len(tokens) > 0 and len(tokens) % self.page_size == 0
                and tuple(tokens) not in self.entries)

    def insert_boundary(self, tokens: List[int], cache: Any,
                        on_evict: Optional[Callable[[], None]] = None
                        ) -> None:
        """Insert a mid-prefill partial-prefix snapshot (chunk boundary)."""
        if tuple(tokens) in self.entries:
            if on_evict is not None:
                on_evict()                # duplicate publication: unpin
            return                        # boundary already stored; keep LRU age
        self.stats["boundary_snapshots"] += 1
        self.insert(list(tokens), cache, on_evict)

    @property
    def nbytes(self) -> int:
        """Resident bytes pinned by the cache.  Paged entries share
        physical pages, so each physical page is counted ONCE across
        entries."""
        total = 0
        seen: set = set()
        for e in self.entries.values():
            c = e.cache
            if isinstance(c, PagedSnapshot):
                fresh = [p for p in c.pages if p >= 0 and p not in seen]
                seen.update(fresh)
                total += (len(fresh) * c.meta.get("page_nbytes", 0)
                          + c.meta.get("rec_nbytes", 0))
            else:
                total += e.nbytes
        return total

    def stats_snapshot(self) -> dict:
        """One flat dict for reporting (launch/serve.py, Engine.stats):
        the hit/miss counters plus current entry count and pinned bytes."""
        out = dict(self.stats)
        out["entries"] = len(self.entries)
        out["pinned_bytes"] = self.nbytes
        return out
