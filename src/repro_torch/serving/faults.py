"""Deterministic fault injection for the serving/routing stack.

A :class:`FaultPlan` is a seeded schedule of :class:`FaultSpec` entries,
each bound to a named *site* — a point in the engine or backend that asks
the plan "do you fire here?" every time it passes.  The answer is a pure
function of ``(seed, schedule, opportunity index)``: two engines driven by
clones of the same plan over the same workload inject byte-identical
faults, which is what lets the chaos soak assert bit-for-bit
reproducibility.  A plan whose specs all have ``rate=0`` is a strict
no-op: ``fire`` never triggers and the corruption helpers return their
inputs unchanged, so a rate-0 plan is byte-identical to running without
the layer (pinned by ``tests/test_faults.py``).

Sites consumed by the engine (`serving/engine.py`):

- ``engine.crash``    — simulated process crash at a step boundary; the
  engine preempts every in-flight row and replays from prefix-cache
  snapshots + ``billed_prefill`` watermarks (no double billing).
- ``engine.latency``  — latency spike; advances the plan's virtual clock
  by ``payload["delay_s"]`` so deadline enforcement sees the stall
  without the test suite ever sleeping.
- ``engine.logits``   — overwrites one live row's logits with NaN
  (``payload["value"]="inf"`` for +inf) before sampling; exercises the
  NaN quarantine / bounded-replay path.
- ``engine.stuck``    — marks one decoding row stuck: its commits are
  suppressed so the row makes no progress; exercises the stall detector.

Sites consumed by the backend (`core/reflection.py`):

- ``backend.transient`` — per-request transient failure in
  ``complete_many``; the request finishes with stop_reason ``"error"``
  while the rest of the batch completes (and the routed loop retries it
  with SLO-priced backoff).
- ``backend.garbage``   — corrupts one round's output text (truncate or
  replace with noise); the reflection loop must absorb it as a bad
  round, not an exception.

One opportunity = one ``fire(site)`` call.  Per spec, an opportunity at
index ``n`` is eligible when ``n >= start`` and fewer than ``max_fires``
fires have happened; an eligible opportunity fires when the spec's own
seeded stream draws ``u < rate``.  ``rate=1.0, start=k, max_fires=1``
therefore fires exactly once, at the k-th opportunity — the idiom for
scheduling a single mid-run crash.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

__all__ = [
    "TransientBackendError",
    "VirtualClock",
    "FaultSpec",
    "FaultPlan",
]


class TransientBackendError(RuntimeError):
    """A backend call failed in a way that is worth retrying."""


class VirtualClock:
    """Deterministic monotonic clock for deadline tests.

    Callable like ``time.monotonic``; ``tick()`` advances by a fixed
    per-engine-step quantum and ``advance()`` models a latency spike.
    Nothing in the chaos suite ever sleeps.
    """

    def __init__(self, start: float = 0.0, tick_s: float = 0.0):
        self._now = float(start)
        self.tick_s = float(tick_s)

    def __call__(self) -> float:
        return self._now

    def advance(self, dt: float) -> None:
        assert dt >= 0.0, "clock is monotonic"
        self._now += float(dt)

    def tick(self) -> None:
        self._now += self.tick_s


@dataclass(frozen=True)
class FaultSpec:
    """One fault source bound to a named site.

    ``kind`` is descriptive (it names the failure mode in stats/traces);
    behavior is determined by which site consumes the spec and by
    ``payload`` (e.g. ``{"delay_s": 0.5}`` for latency spikes,
    ``{"value": "inf"}`` for Inf instead of NaN logits,
    ``{"mode": "garbage"}`` for noise instead of truncation).
    """

    site: str
    kind: str = "fault"
    rate: float = 0.0
    start: int = 0
    max_fires: Optional[int] = None
    payload: Mapping[str, Any] = field(default_factory=dict)


class FaultPlan:
    """Seeded, replayable fault schedule over named sites."""

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0,
                 clock: Optional[Any] = None):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = int(seed)
        self.clock = clock if clock is not None else VirtualClock()
        self._opportunities: Dict[str, int] = {}
        self._fires = [0] * len(self.specs)
        self._rngs = [
            np.random.default_rng(
                [self.seed, i, zlib.crc32(sp.site.encode())])
            for i, sp in enumerate(self.specs)
        ]
        # Separate stream for choices made *after* a fire (victim row,
        # garbage bytes) so they never perturb the fire schedule itself.
        self._pick_rng = np.random.default_rng([self.seed, 0x9E3779B9])
        self.stats: Dict[str, int] = {}

    # -- lifecycle ---------------------------------------------------------

    def clone(self) -> "FaultPlan":
        """Fresh plan with the same schedule: replays identically."""
        clock = self.clock
        if isinstance(clock, VirtualClock):
            clock = VirtualClock(tick_s=clock.tick_s)
        return FaultPlan(self.specs, seed=self.seed, clock=clock)

    @property
    def fired_total(self) -> int:
        return sum(self.stats.values())

    # -- core decision -----------------------------------------------------

    def fire(self, site: str) -> Optional[FaultSpec]:
        """Record one opportunity at ``site``; return the spec that fires.

        At most one spec fires per opportunity (first match in spec
        order).  Pure function of the plan's seed and the sequence of
        ``fire`` calls made so far.
        """
        n = self._opportunities.get(site, 0)
        self._opportunities[site] = n + 1
        for i, sp in enumerate(self.specs):
            if sp.site != site or sp.rate <= 0.0:
                continue
            if n < sp.start:
                continue
            if sp.max_fires is not None and self._fires[i] >= sp.max_fires:
                continue
            if float(self._rngs[i].random()) < sp.rate:
                self._fires[i] += 1
                self.stats[site] = self.stats.get(site, 0) + 1
                return sp
        return None

    def pick(self, n: int) -> int:
        """Deterministic victim index in ``[0, n)``."""
        assert n > 0
        return int(self._pick_rng.integers(n))

    # -- per-site helpers --------------------------------------------------

    def on_step(self) -> None:
        """Engine-step hook: advance virtual time, maybe spike latency."""
        if isinstance(self.clock, VirtualClock):
            self.clock.tick()
        sp = self.fire("engine.latency")
        if sp is not None and isinstance(self.clock, VirtualClock):
            self.clock.advance(float(sp.payload.get("delay_s", 1.0)))

    def corrupt_logits(self, site: str, logits, rows: Sequence[int]):
        """Overwrite one of ``rows`` with NaN/Inf logits on a fire.

        Returns ``logits`` unchanged (same object — no device work) when
        nothing fires, which is what keeps the rate-0 plan bit-exact.
        """
        if not rows:
            return logits
        sp = self.fire(site)
        if sp is None:
            return logits
        row = rows[self.pick(len(rows))]
        val = float("inf" if sp.payload.get("value") == "inf" else "nan")
        # a copy on the logits' device, as .at[].set makes: a captured
        # step's logits are its graph's static output
        out = logits.clone()
        out[row] = val
        return out

    def corrupt_text(self, site: str, text: str) -> str:
        """Truncate or garbage one round's output text on a fire."""
        sp = self.fire(site)
        if sp is None:
            return text
        if sp.payload.get("mode", "truncate") == "truncate":
            return text[: len(text) // 2]
        n = int(sp.payload.get("len", 12))
        return "".join(chr(33 + self._pick_rng.integers(94)) for _ in range(n))

    def raise_transient(self, site: str) -> None:
        """Raise :class:`TransientBackendError` on a fire (else no-op)."""
        sp = self.fire(site)
        if sp is not None:
            raise TransientBackendError(f"injected transient fault at {site}")
