"""Fleet router: prefix-affinity dispatch across N engine replicas
(docs/SERVING.md#fleet-routing).

"Millions of users" is a distribution, not a batch: this module drives a
:mod:`repro_torch.serving.trace` workload across N replicas behind one
:class:`Router`, converting the engine's per-request admission control
into end-to-end capacity planning.  Two replica kinds share the same
router-facing protocol:

  * :class:`EngineReplica` — a real :class:`repro_torch.serving.engine.Engine`
    on the smoke model (launch/serve.py ``--replicas``), driven by
    cooperative ``step()`` pumping with wall-clock TTFT measurement;
  * :class:`SimulatedReplica` — a discrete-event model (slots, prefill/
    decode token rates) wrapped around REAL :class:`PrefixCache` and
    :class:`PagePool` instances, so fleet sweeps to 64+ replicas on the
    CI box exercise exactly the cache/pool accounting the live engine
    uses — hit-rate stats, LRU eviction, snapshot page pins, refcounts —
    and ``PagePool.check()`` / zero-leak assertions mean the same thing
    in simulation as in anger.

ROUTING.  ``affinity`` hashes each prompt's FIRST PAGE (the trace's
group prefixes are page-aligned, so the first page identifies the
shared-prefix group) to a home replica: every group member lands where
the group's prefix snapshot already lives, so fleet-wide prefix-cache
hit rate approaches the single-replica rate instead of diluting 1/N.
Two pressure valves keep affinity from starving under skew:

  * SPILLOVER — when the home replica is saturated (slots full and its
    queue at least ``spill_queue_depth`` deep), the request goes to the
    least-loaded replica instead (counted in ``Router.spillovers``);
  * WORK STEALING — an idle replica (no active work, empty queue) takes
    the TAIL of the longest backlog (the newest, least-affinity-valuable
    entry; counted in ``Router.steals``).

``round_robin`` ships alongside as the A/B baseline (same spill/steal
machinery available, no cache awareness).  Routing is deterministic:
same trace + same RouterConfig -> identical per-replica assignment
(pinned by tests/test_fleet.py).

SIMULATED SCHEDULING mirrors the engine's policies: admission allocates
pages for prompt + first token (adopting page-aligned prefix-cache
snapshot pages by incref, exactly like ``Engine._adopt_snapshot``);
decode allocates pages as the output crosses page boundaries; pool
exhaustion first evicts prefix-cache LRU entries, then preempts the
YOUNGEST strictly-younger active request (requeued at the front, replay
billed as prefill — FIFO, a late arrival never steals pages from an
earlier one); deadline checks use the engine's ``DEADLINE_EPS`` at both
admission ("slo" rejection pricing the remaining budget) and queue
expiry ("timeout").  Completions publish a page-aligned prompt-prefix
snapshot into the replica's cache, pinning pages until LRU eviction.
"""
from __future__ import annotations

import time
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.page_pool import PagePool, PagedSnapshot
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.request import DEADLINE_EPS, Request
from repro_torch.serving.trace import TraceRequest


def affinity_key(prompt, page_size: int) -> int:
    """Stable hash of the prompt's first page.  Prompts sharing a
    page-aligned prefix (one cache-reuse unit) hash identically, so the
    router can send them to the replica whose PrefixCache owns the
    snapshot.  crc32 over the raw token bytes: deterministic across
    processes and runs (unlike Python's seeded hash())."""
    first = np.asarray(prompt[:page_size], np.int64)
    return zlib.crc32(first.tobytes())


# ---------------------------------------------------------------------------
# work items + completion records
# ---------------------------------------------------------------------------


@dataclass
class _Work:
    """Router-side mutable wrapper of a TraceRequest: carries replay
    state across preemptions and steals (the trace itself is frozen)."""
    treq: TraceRequest
    done_tokens: int = 0            # output tokens committed pre-preemption
    preemptions: int = 0
    first_token_s: Optional[float] = None


@dataclass
class _Flight:
    """One admitted request inside a SimulatedReplica."""
    work: _Work
    admit_seq: int
    t_admit: float
    cached_len: int                 # page-aligned snapshot adoption
    pages: List[int]
    prefill_end_s: float            # first token commits here
    finish_s: float

    def committed_out(self, t: float, decode_tok_s: float) -> int:
        """Output tokens committed by time t (capacity-unaware)."""
        if t < self.prefill_end_s:
            return 0
        total = self.work.treq.max_new_tokens
        k = self.work.done_tokens + 1 + int(
            (t - self.prefill_end_s) * decode_tok_s + 1e-9)
        return min(total, k)

    def token_time(self, k: int, decode_tok_s: float) -> float:
        """Commit time of output token k (1-based, k > done_tokens)."""
        if k <= self.work.done_tokens + 1:
            return self.prefill_end_s
        return (self.prefill_end_s
                + (k - self.work.done_tokens - 1) / decode_tok_s)


# ---------------------------------------------------------------------------
# simulated replica
# ---------------------------------------------------------------------------


class SimulatedReplica:
    """Discrete-event engine replica: real PrefixCache + PagePool, with
    service times from per-replica prefill/decode token rates."""

    is_live = False

    def __init__(self, rid: int, page_size: int = 16, num_pages: int = 96,
                 n_slots: int = 4, prefill_tok_s: float = 1500.0,
                 decode_tok_s: float = 120.0, cache_entries: int = 6):
        self.rid = rid
        self.page_size = page_size
        self.n_slots = n_slots
        self.prefill_tok_s = prefill_tok_s
        self.decode_tok_s = decode_tok_s
        self.pool = PagePool(num_pages, page_size)
        self.cache = PrefixCache(page_size, max_entries=cache_entries,
                                 recurrent=False)
        self.queue: deque[_Work] = deque()
        self.active: List[_Flight] = []
        self.counters = {"admitted": 0, "completed": 0, "timeouts": 0,
                         "slo_rejections": 0, "preemptions": 0, "late": 0}
        self.completions: List[Dict[str, Any]] = []
        self._admit_seq = 0

    # ------------------------------------------------------ router protocol

    def load(self) -> int:
        return len(self.active) + len(self.queue)

    def saturated(self, spill_depth: int) -> bool:
        return (len(self.active) >= self.n_slots
                and len(self.queue) >= spill_depth)

    def idle(self) -> bool:
        return not self.active and not self.queue

    def submit(self, treq: TraceRequest, now: float) -> None:
        self.submit_work(_Work(treq), now)

    def submit_work(self, work: _Work, now: float) -> None:
        self.queue.append(work)
        self._admit_ready(now)

    def steal_one(self) -> Optional[_Work]:
        """Yield the newest queued item to an idle thief — the tail has
        waited least and loses the least affinity value by moving."""
        return self.queue.pop() if self.queue else None

    def cache_stats(self) -> Dict[str, Any]:
        return self.cache.stats_snapshot()

    def release_cache(self) -> int:
        """Evict every cache entry (dropping its page pins), verify pool
        invariants, and return the pages still held — 0 after a drained
        run means no page leaked anywhere in the lifecycle."""
        while self.cache.evict_lru():
            pass
        self.pool.check()
        return self.pool.used_pages

    # --------------------------------------------------------- event engine

    def next_event(self) -> Optional[Tuple[float, int, int]]:
        """Earliest pending (time, kind, admit_seq): kind 0 = completion,
        kind 1 = page-growth demand.  Completion sorts first at equal
        times so freed pages can satisfy page demands without needless
        preemption."""
        best = None
        for fl in self.active:
            for ev in ((fl.finish_s, 0, fl.admit_seq),
                       self._page_event(fl)):
                if ev is not None and (best is None or ev < best):
                    best = ev
        return best

    def advance_until(self, t: float) -> None:
        """Process every event with timestamp <= t, in order."""
        while True:
            ev = self.next_event()
            if ev is None or ev[0] > t + 1e-12:
                return
            when, kind, seq = ev
            fl = next(f for f in self.active if f.admit_seq == seq)
            if kind == 0:
                self._finish(fl)
            else:
                self._grow_pages(fl, when)
            self._admit_ready(when)

    # ------------------------------------------------------------ internals

    def _page_event(self, fl: _Flight) -> Optional[Tuple[float, int, int]]:
        cap = len(fl.pages) * self.page_size
        P = len(fl.work.treq.prompt)
        if cap >= P + fl.work.treq.max_new_tokens:
            return None
        # the first output token that would overflow current page backing
        k = cap - P + 1
        return (fl.token_time(k, self.decode_tok_s), 1, fl.admit_seq)

    def _alloc_page(self, asker: Optional[_Flight]) -> Optional[int]:
        """Engine._alloc_page policy: free list, then prefix-cache LRU
        eviction, then FIFO preemption of a strictly-younger flight."""
        while True:
            pg = self.pool.alloc()
            if pg is not None:
                return pg
            if self.cache.evict_lru():
                continue
            if self._preempt_younger(asker):
                continue
            return None

    def _preempt_younger(self, asker: Optional[_Flight]) -> bool:
        pseq = asker.admit_seq if asker is not None else self._admit_seq + 1
        cands = [f for f in self.active if f.admit_seq > pseq]
        if not cands:
            return False
        self._preempt(max(cands, key=lambda f: f.admit_seq),
                      self._now_hint)
        return True

    def _preempt(self, fl: _Flight, t: float) -> None:
        """Release the flight's pages and requeue it at the FRONT with
        its committed progress carried in _Work (replay = prefill of
        prompt + done_tokens, engine-style)."""
        done = min(fl.committed_out(t, self.decode_tok_s),
                   len(fl.pages) * self.page_size
                   - len(fl.work.treq.prompt),
                   fl.work.treq.max_new_tokens - 1)
        done = max(done, 0)
        if done >= 1:
            fl.work.first_token_s = (fl.prefill_end_s
                                     if fl.work.first_token_s is None
                                     else fl.work.first_token_s)
        fl.work.done_tokens = done
        fl.work.preemptions += 1
        self.counters["preemptions"] += 1
        self.pool.decref(fl.pages)
        self.active.remove(fl)
        self.queue.appendleft(fl.work)

    def _grow_pages(self, fl: _Flight, t: float) -> None:
        self._now_hint = t
        pg = self._alloc_page(asker=fl)
        if pg is None:
            # nothing reclaimable below this flight: it waits its turn
            self._preempt(fl, t)
        else:
            fl.pages.append(pg)

    def _admit_ready(self, now: float) -> None:
        while self.queue and len(self.active) < self.n_slots:
            work = self.queue.popleft()
            if not self._admit(work, now):
                self.queue.appendleft(work)     # page-starved: wait
                return

    def _record(self, work: _Work, reason: str, ok: bool,
                ttft: Optional[float], latency: Optional[float],
                cached: int) -> None:
        self.completions.append({
            "idx": work.treq.idx, "rid": self.rid,
            "klass": work.treq.slo_class, "reason": reason, "ok": ok,
            "ttft_s": ttft, "latency_s": latency, "cached": cached,
            "preemptions": work.preemptions})

    def _admit(self, work: _Work, now: float) -> bool:
        """Admission at time ``now``.  True = the work item was consumed
        (admitted OR finalized); False = page-starved, caller requeues."""
        self._now_hint = now
        treq = work.treq
        wait = now - treq.arrival_s
        deadline = treq.slo.max_latency_s
        # queue-expiry sweep (engine _enforce_deadlines analogue)
        if deadline is not None and wait > deadline + DEADLINE_EPS:
            self.counters["timeouts"] += 1
            self._record(work, "timeout", False, None, None, 0)
            return True
        ps = self.page_size
        # min_len = one page: shorter candidates are unusable (adoption
        # is page-aligned), and counting them as misses keeps the fleet
        # hit-rate denominator equal to recorded lookups
        res = self.cache.lookup(list(treq.prompt), min_len=ps - 1)
        cut = (min(res.cached_len, len(treq.prompt) - 1) // ps) * ps
        adopted: List[int] = []
        if cut > 0 and isinstance(res.cache, PagedSnapshot):
            adopted = [int(p) for p in res.cache.pages[:cut // ps]]
            self.pool.incref(adopted)
        else:
            cut = 0
        # SLO admission pricing (engine _slo_reject analogue): remaining
        # deadline budget must fund predicted prefill + decode
        fresh = len(treq.prompt) + work.done_tokens - cut
        service = (fresh / self.prefill_tok_s
                   + max(treq.max_new_tokens - work.done_tokens - 1, 0)
                   / self.decode_tok_s)
        if (deadline is not None
                and wait + service > deadline + DEADLINE_EPS
                and work.preemptions == 0):
            # preempted replays are exempt, like the engine: their work
            # already happened and must be resumed
            if adopted:
                self.pool.decref(adopted)
            self.counters["slo_rejections"] += 1
            self._record(work, "slo", False, None, None, 0)
            return True
        # back prompt + first token with pages (decode pages grow later);
        # a request whose FULL footprint exceeds the pool would self-
        # preempt at the same watermark forever, so reject that config
        assert (len(treq.prompt) + treq.max_new_tokens
                <= self.pool.num_pages * ps), \
            "request footprint exceeds the replica's page pool"
        need_tokens = len(treq.prompt) + work.done_tokens + 1
        need = -(-need_tokens // ps) - len(adopted)
        pages = list(adopted)
        for _ in range(need):
            pg = self._alloc_page(asker=None)
            if pg is None:
                self.pool.decref(pages)
                return False
            pages.append(pg)
        self._admit_seq += 1
        prefill_end = now + fresh / self.prefill_tok_s
        finish = prefill_end + max(
            treq.max_new_tokens - work.done_tokens - 1, 0) / self.decode_tok_s
        self.counters["admitted"] += 1
        self.active.append(_Flight(
            work=work, admit_seq=self._admit_seq, t_admit=now,
            cached_len=cut, pages=pages, prefill_end_s=prefill_end,
            finish_s=finish))
        return True

    def _finish(self, fl: _Flight) -> None:
        work, treq = fl.work, fl.work.treq
        first = (work.first_token_s if work.first_token_s is not None
                 else fl.prefill_end_s)
        ttft = first - treq.arrival_s
        latency = fl.finish_s - treq.arrival_s
        deadline = treq.slo.max_latency_s
        late = deadline is not None and latency > deadline + DEADLINE_EPS
        if late:
            self.counters["late"] += 1
        ok = not late and ttft <= treq.ttft_slo_s + DEADLINE_EPS
        self.counters["completed"] += 1
        self._record(work, "late" if late else "ok", ok, ttft, latency,
                     fl.cached_len)
        # publish the page-aligned prompt-prefix snapshot (the shared
        # group prefix is a prefix of it, so future group members hit)
        ps = self.page_size
        snap_len = (len(treq.prompt) // ps) * ps
        if snap_len > 0:
            snap_pages = [int(p) for p in fl.pages[:snap_len // ps]]
            self.pool.incref(snap_pages)
            self.cache.insert(
                list(treq.prompt[:snap_len]),
                PagedSnapshot(pages=snap_pages, n_tokens=snap_len,
                              nbytes=len(snap_pages),
                              meta={"page_nbytes": 1}),
                on_evict=lambda pgs=tuple(snap_pages): self.pool.decref(pgs))
        self.pool.decref(fl.pages)
        self.active.remove(fl)

    _now_hint: float = 0.0


# ---------------------------------------------------------------------------
# live replica (real Engine)
# ---------------------------------------------------------------------------


class EngineReplica:
    """A real Engine behind the router protocol.  The router keeps the
    backlog on ITS side (stealable) and feeds the engine only while free
    slots outnumber the engine's internal queue, so spillover and
    stealing see true occupancy.  Time is wall clock; TTFT is measured
    at the first observed output token during pumping."""

    is_live = True

    def __init__(self, rid: int, engine):
        self.rid = rid
        self.engine = engine
        self.backlog: deque[_Work] = deque()
        self.counters = {"admitted": 0, "completed": 0, "timeouts": 0,
                         "slo_rejections": 0, "preemptions": 0, "late": 0}
        self.completions: List[Dict[str, Any]] = []
        self._inflight: Dict[int, Tuple[_Work, float]] = {}   # uid -> work

    def load(self) -> int:
        return len(self.backlog) + len(self.engine.requests)

    def saturated(self, spill_depth: int) -> bool:
        free = sum(s is None for s in self.engine.slots)
        return free == 0 and self.load() >= spill_depth

    def idle(self) -> bool:
        return not self.backlog and not self.engine.requests

    def submit(self, treq: TraceRequest, now: float) -> None:
        self.submit_work(_Work(treq), now)

    def submit_work(self, work: _Work, now: float) -> None:
        self.backlog.append(work)

    def steal_one(self) -> Optional[_Work]:
        return self.backlog.pop() if self.backlog else None

    def cache_stats(self) -> Dict[str, Any]:
        pc = self.engine.prefix_cache
        return pc.stats_snapshot() if pc is not None else {}

    def release_cache(self) -> int:
        pc = self.engine.prefix_cache
        if pc is not None:
            while pc.evict_lru():
                pass
        if self.engine.paged:
            self.engine.pool.check()
            return self.engine.pool.used_pages
        return 0

    def pump(self) -> bool:
        """One cooperative tick: feed backlog into free slots, advance
        the engine one step, harvest first tokens + completions.
        Returns True while this replica still has work."""
        eng = self.engine
        while self.backlog and (sum(s is None for s in eng.slots)
                                > len(eng.queue)):
            work = self.backlog.popleft()
            req = Request(prompt=list(work.treq.prompt),
                          max_new_tokens=work.treq.max_new_tokens,
                          eos_id=None,
                          max_latency_s=work.treq.slo.max_latency_s)
            eng.submit(req)
            self.counters["admitted"] += 1
            self._inflight[req.uid] = (work, time.perf_counter())
        if not eng.requests:
            return bool(self.backlog)
        eng.step()
        now = time.perf_counter()
        for slot_req in eng.slots:
            if slot_req is None or not slot_req.output:
                continue
            entry = self._inflight.get(slot_req.uid)
            if entry is not None and entry[0].first_token_s is None:
                entry[0].first_token_s = now
        done = list(eng.finished)
        eng.finished.clear()
        for req in done:
            work, t0 = self._inflight.pop(req.uid)
            ttft = (work.first_token_s - t0
                    if work.first_token_s is not None else None)
            ok = req.stop_reason in ("max_tokens", "eos", "budget")
            if req.stop_reason == "timeout":
                self.counters["timeouts"] += 1
            elif req.stop_reason == "slo":
                self.counters["slo_rejections"] += 1
            else:
                self.counters["completed"] += 1
            work.preemptions = req.preemptions
            self.completions.append({
                "idx": work.treq.idx, "rid": self.rid,
                "klass": work.treq.slo_class,
                "reason": req.stop_reason, "ok": ok,
                "ttft_s": ttft, "latency_s": now - t0,
                "cached": req.cached_len,
                "preemptions": req.preemptions})
        self.counters["preemptions"] = eng.model_steps["preemptions"]
        return bool(self.backlog) or bool(eng.requests)


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------


@dataclass
class RouterConfig:
    policy: str = "affinity"        # "affinity" | "round_robin"
    page_size: int = 16             # affinity-hash page boundary; must
    #                                 match the trace + replica page size
    spill_queue_depth: int = 4      # home backlog depth that triggers
    #                                 spillover to the least-loaded replica
    #                                 (shallower spills protect TTFT but
    #                                 dilute affinity; 4 won the sweep in
    #                                 benchmarks/fleet.py)
    work_steal: bool = True


@dataclass
class FleetReport:
    policy: str
    n_replicas: int
    completions: List[Dict[str, Any]]
    assignments: List[Tuple[int, int]]      # (trace idx, replica id)
    spillovers: int
    steals: int
    cache_stats: Dict[str, int]
    counters: Dict[str, int]

    def _ttfts(self) -> List[float]:
        return [c["ttft_s"] for c in self.completions
                if c["ttft_s"] is not None]

    def ttft_p(self, q: float) -> float:
        xs = self._ttfts()
        return float(np.percentile(np.asarray(xs), q)) if xs else 0.0

    def goodput(self) -> float:
        """Fraction of ALL trace requests that completed inside both
        their TTFT target and SLO deadline."""
        if not self.completions:
            return 0.0
        return sum(c["ok"] for c in self.completions) / len(self.completions)

    def hit_rate(self) -> float:
        """Fleet prefix-cache hit rate over recorded lookups.  The
        denominator is hits + partial_hits + misses — which is only the
        true lookup count because min_len-filtered lookups count as
        misses (prefix_cache.py)."""
        h = self.cache_stats.get("hits", 0)
        p = self.cache_stats.get("partial_hits", 0)
        m = self.cache_stats.get("misses", 0)
        return (h + p) / max(h + p + m, 1)

    def summary(self) -> Dict[str, Any]:
        return {
            "policy": self.policy, "n_replicas": self.n_replicas,
            "requests": len(self.completions),
            "p50_ttft_ms": round(self.ttft_p(50) * 1e3, 2),
            "p99_ttft_ms": round(self.ttft_p(99) * 1e3, 2),
            "goodput": round(self.goodput(), 4),
            "prefix_hit_rate": round(self.hit_rate(), 4),
            "preemptions": self.counters.get("preemptions", 0),
            "slo_rejections": self.counters.get("slo_rejections", 0),
            "timeouts": self.counters.get("timeouts", 0),
            "spillovers": self.spillovers, "steals": self.steals,
        }


class Router:
    """Dispatch a trace across replicas; see module docstring."""

    def __init__(self, replicas: List[Any], cfg: Optional[RouterConfig]
                 = None):
        assert replicas, "router needs at least one replica"
        self.replicas = list(replicas)
        self.cfg = cfg or RouterConfig()
        assert self.cfg.policy in ("affinity", "round_robin")
        self.assignments: List[Tuple[int, int]] = []
        self.spillovers = 0
        self.steals = 0
        self._rr = 0

    # ------------------------------------------------------------- routing

    def route(self, treq: TraceRequest) -> int:
        n = len(self.replicas)
        if self.cfg.policy == "round_robin":
            rid = self._rr % n
            self._rr += 1
            return rid
        home = affinity_key(treq.prompt, self.cfg.page_size) % n
        if not self.replicas[home].saturated(self.cfg.spill_queue_depth):
            return home
        self.spillovers += 1
        return min(range(n), key=lambda i: (self.replicas[i].load(), i))

    def _steal(self, now: float) -> None:
        if not self.cfg.work_steal:
            return
        for thief in self.replicas:
            while thief.idle():
                victim = max(
                    (r for r in self.replicas if r is not thief),
                    key=lambda r: (len(r.queue) if not r.is_live
                                   else len(r.backlog), -r.rid),
                    default=None)
                qlen = (0 if victim is None else
                        len(victim.queue if not victim.is_live
                            else victim.backlog))
                if qlen == 0:
                    break
                work = victim.steal_one()
                self.steals += 1
                thief.submit_work(work, now)
                if thief.is_live:
                    break               # live admission happens in pump()

    # -------------------------------------------------------- drive loops

    def run_trace(self, trace: List[TraceRequest]) -> FleetReport:
        if self.replicas[0].is_live:
            return self._run_live(trace)
        for treq in trace:
            self._advance_all(treq.arrival_s)
            rid = self.route(treq)
            self.assignments.append((treq.idx, rid))
            self.replicas[rid].submit(treq, treq.arrival_s)
            self._steal(treq.arrival_s)
        self._advance_all(None)
        return self._report()

    def _advance_all(self, now: Optional[float]) -> None:
        """Process fleet events in global time order up to ``now``
        (None = drain everything)."""
        while True:
            best = None
            for i, r in enumerate(self.replicas):
                ev = r.next_event()
                if ev is not None and (best is None or (ev, i) < best):
                    best = (ev, i)
            if best is None:
                return
            (when, _, _), i = best
            if now is not None and when > now:
                return
            self.replicas[i].advance_until(when)
            self._steal(when)

    def _run_live(self, trace: List[TraceRequest]) -> FleetReport:
        """Live engines replay the trace in arrival ORDER as fast as the
        hardware serves it (wall-pacing a CPU smoke fleet would measure
        sleep, not serving); routing still sees true live occupancy."""
        for treq in trace:
            rid = self.route(treq)
            self.assignments.append((treq.idx, rid))
            self.replicas[rid].submit(treq, time.perf_counter())
            for r in self.replicas:
                r.pump()
        busy = True
        while busy:
            self._steal(time.perf_counter())
            busy = False
            for r in self.replicas:
                busy = r.pump() or busy
        return self._report()

    # ------------------------------------------------------------ reporting

    def _report(self) -> FleetReport:
        cache: Dict[str, int] = {}
        counters: Dict[str, int] = {}
        completions: List[Dict[str, Any]] = []
        for r in self.replicas:
            for k, v in r.cache_stats().items():
                if isinstance(v, (int, float)):
                    cache[k] = cache.get(k, 0) + v
            for k, v in r.counters.items():
                counters[k] = counters.get(k, 0) + v
            completions.extend(r.completions)
        completions.sort(key=lambda c: c["idx"])
        return FleetReport(
            policy=self.cfg.policy, n_replicas=len(self.replicas),
            completions=completions, assignments=list(self.assignments),
            spillovers=self.spillovers, steals=self.steals,
            cache_stats=cache, counters=counters)

    def shutdown_check(self) -> int:
        """Release every replica's cache pins and return total leaked
        pages (must be 0 after a drained run)."""
        return sum(r.release_cache() for r in self.replicas)
