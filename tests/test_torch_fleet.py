"""The port's fleet modules (``serving/trace.py``, ``serving/fleet.py``)
against the JAX package's.

* ``generate_trace`` gives an equal list for the same ``TraceConfig``;
* simulated routers over the same traces give equal summaries,
  assignments and completions, under both policies, with spillover,
  work stealing and page-pressure preemption in play;
* live fleets of two engines — the port's on the CPU and the JAX
  package's, on the same ``quick_fit_ramp`` weights — give equal
  assignments, completions apart from their times, and per-replica
  counters; no page leaks (``shutdown_check() == 0``);
* a live fleet of the port's engines with deadlines and SLO pricing on
  terminates every request;
* ``python -m repro_torch.launch.serve --replicas 2 --device cpu`` runs.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs.base import ServeConfig as JServeConfig
from repro.models.registry import build_model as jbuild
from repro.models.registry import get_smoke_config as jsmoke
from repro.serving import fleet as JFleet
from repro.serving import trace as JTrace
from repro.serving.engine import Engine as JEngine
from repro.train.quick_fit import quick_fit_ramp
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ServeConfig
from repro_torch.models.registry import build_model, get_smoke_config
from repro_torch.serving import fleet as Fleet
from repro_torch.serving import trace as Trace
from repro_torch.serving.engine import Engine

SRC = Path(__file__).resolve().parents[1] / "src"
TIMES = ("ttft_s", "latency_s")
TRACES = [dict(n_requests=64, seed=5),
          dict(n_requests=150, seed=7),
          dict(n_requests=40, seed=1, mean_rate=500.0, diurnal_amp=0.0,
               domain_mix=(("math", 1.0),), groups_per_domain=1),
          dict(n_requests=12, seed=4, mean_rate=400.0, diurnal_amp=0.0,
               out_tokens=(40, 48)),
          dict(n_requests=64, seed=3, mean_rate=40.0, vocab=512,
               page_size=16)]


@pytest.fixture(scope="module")
def fitted():
    """reflect_demo_100m's smoke model on fitted weights, in both
    packages."""
    jm = jbuild(jsmoke("reflect_demo_100m").replace(dtype="float32"))
    params = quick_fit_ramp(jm, jm.init(jax.random.PRNGKey(0)), steps=60,
                            max_steps=60)
    m = build_model(get_smoke_config("reflect_demo_100m").replace(
        dtype="float32"))
    m.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, m


def _plain(trace):
    return [dataclasses.asdict(t) for t in trace]


@pytest.mark.parametrize("kw", TRACES,
                         ids=["seed5", "seed7", "burst", "long", "smoke"])
def test_trace_matches_reference(kw):
    """Equal traces (SLOs compared as values: the classes differ), the
    same per-class objectives and the same group prefixes."""
    want = JTrace.generate_trace(JTrace.TraceConfig(**kw))
    got = Trace.generate_trace(Trace.TraceConfig(**kw))
    assert _plain(got) == _plain(want)
    assert got == Trace.generate_trace(Trace.TraceConfig(**kw))
    assert ({k: dataclasses.asdict(v) for k, v in Trace.SLO_CLASSES.items()}
            == {k: dataclasses.asdict(v)
                for k, v in JTrace.SLO_CLASSES.items()})
    assert Trace.TTFT_TARGET_S == JTrace.TTFT_TARGET_S
    for t in got[:8]:
        assert (Fleet.affinity_key(t.prompt, 16)
                == JFleet.affinity_key(t.prompt, 16))


def _simulated(pkg, trace_kw, policy, n_replicas=4, router_kw=None,
               **rep_kw):
    """One package's simulated fleet over one trace: its report, the
    pages left after the caches are released, and its counters."""
    T, Fl = (JTrace, JFleet) if pkg == "jax" else (Trace, Fleet)
    trace = T.generate_trace(T.TraceConfig(**trace_kw))
    router = Fl.Router([Fl.SimulatedReplica(i, **rep_kw)
                        for i in range(n_replicas)],
                       Fl.RouterConfig(policy=policy, **(router_kw or {})))
    report = router.run_trace(trace)
    return (report.summary(), report.assignments, report.completions,
            report.cache_stats, report.counters, router.shutdown_check())


@pytest.mark.parametrize("policy", ["affinity", "round_robin"])
@pytest.mark.parametrize("case", [
    (TRACES[1], {}, {}),
    (TRACES[2], dict(work_steal=False), {}),
    (TRACES[2], dict(spill_queue_depth=10**6), {}),
    (TRACES[3], {}, dict(num_pages=24, n_slots=3, cache_entries=2)),
    (TRACES[4], {}, {})], ids=["mixed", "spill", "steal", "pressure",
                                "smoke"])
def test_simulated_router_matches_reference(policy, case):
    trace_kw, router_kw, rep_kw = case
    n = 1 if rep_kw else (2 if router_kw else 4)
    want = _simulated("jax", trace_kw, policy, n, router_kw, **rep_kw)
    got = _simulated("port", trace_kw, policy, n, router_kw, **rep_kw)
    assert got == want
    assert got[-1] == 0
    assert got[0]["requests"] == trace_kw["n_requests"]


def _live(pkg, weights, policy, n_requests=10, **scfg_kw):
    """A live two-replica fleet of one package's engines over a small
    trace: (assignments, completions without their times, per-replica
    counters, leaked pages, summary)."""
    jm, params, m = weights
    T, Fl = (JTrace, JFleet) if pkg == "jax" else (Trace, Fleet)
    scfg = dict(max_batch=2, max_seq=256, page_size=16, **scfg_kw)
    engines = [JEngine(jm, params, JServeConfig(**scfg)) if pkg == "jax"
               else Engine(m, ServeConfig(**scfg), device="cpu")
               for _ in range(2)]
    trace = T.generate_trace(T.TraceConfig(
        n_requests=n_requests, seed=3, mean_rate=50.0,
        vocab=m.cfg.vocab_size, out_tokens=(4, 6)))
    router = Fl.Router([Fl.EngineReplica(i, e)
                        for i, e in enumerate(engines)],
                       Fl.RouterConfig(policy=policy))
    report = router.run_trace(trace)
    completions = [{k: v for k, v in c.items() if k not in TIMES}
                   for c in report.completions]
    snaps = [e.stats_snapshot() for e in engines]
    return (report.assignments, completions, snaps,
            router.shutdown_check(), report.summary(), report.completions)


@pytest.mark.parametrize("policy", ["affinity", "round_robin"])
def test_live_fleet_matches_jax(fitted, policy):
    want = _live("jax", fitted, policy)
    got = _live("port", fitted, policy)
    assert got[:4] == want[:4]
    assert got[3] == 0
    assert len(got[1]) == 10
    assert all(c["reason"] == "max_tokens" for c in got[1])
    assert all(c["ttft_s"] is not None and c["ttft_s"] >= 0
               for c in got[5])
    for snap in got[2]:
        assert snap["in_flight"] == 0 and snap["queued"] == 0


def test_live_fleet_with_deadlines_and_slo_pricing(fitted):
    """The port's replicas with deadlines on the wall clock and SLO
    pricing: every request ends with a stop reason, nothing leaks."""
    assignments, completions, _, leaked, summary, _ = _live(
        "port", fitted, "affinity", n_requests=12, enforce_deadlines=True,
        slo_price_model="nova_micro")
    assert len(completions) == len(assignments) == 12
    assert {c["reason"] for c in completions} <= {
        "max_tokens", "eos", "budget", "timeout", "slo"}
    assert leaked == 0
    assert summary["requests"] == 12


def test_serve_launcher_fleet_subprocess():
    """``python -m repro_torch.launch.serve --replicas 2 --device cpu``."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--replicas",
         "2", "--device", "cpu", "--policy", "round_robin",
         "--trace-requests", "6", "--max-new", "5"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "fleet: 2 replicas, policy=round_robin, 6 requests" in out.stdout
    assert "assignment: r0=3 r1=3" in out.stdout
    assert "leaked pages after cache release: 0" in out.stdout
