"""The port's engine on a device mesh (``Engine(mesh=)``,
``ServeConfig.mesh``).

On a 1x1 CPU mesh it serves the JAX ``Engine(mesh="1x1")``'s greedy
streams and bills on quick-fitted weights, paged and on rings, and
reports the reference's ``mesh``, ``n_devices`` and per-device resident
KV.  On a 1x2 mesh — two gloo ranks in two processes, each placing its
half of the heads, the vocabulary and the page pool — it serves the
single-device engine's streams bit for bit with the reference parity
test's options (paged, int8 KV, speculation, warm-up) and on rings, and
each device holds half the pool's used bytes.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ServeConfig as JServeConfig
from repro.models.registry import build_model as jbuild
from repro.models.registry import get_smoke_config as jsmoke
from repro.serving.engine import Engine as JEngine
from repro.serving.request import Request as JRequest
from repro.train.quick_fit import quick_fit_ramp, ramp_prompt
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ServeConfig
from repro_torch.models.registry import build_model, get_smoke_config
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, Status

ARCH = "reflect_demo_100m"
SRC = Path(__file__).resolve().parents[1] / "src"
STEP_KEYS = ("prefill_tokens", "extend_tokens", "decode_tokens",
             "mixed_steps", "verify_steps", "spec_drafted", "spec_accepted",
             "preemptions")
# the reference parity test's engine (tests/test_sharding_rules.py)
PARITY = dict(max_batch=4, max_seq=128, page_size=16, kv_dtype="int8",
              spec_decode=True, spec_tokens=4, aot_warmup=True)
JOIN_S = 120


@pytest.fixture(scope="module")
def fitted():
    """The JAX model on quick-fitted weights, and the port's on the same
    weights: fitted logits have real top-2 gaps."""
    jm = jbuild(jsmoke(ARCH).replace(dtype="float32"))
    params = quick_fit_ramp(jm, jm.init(jax.random.PRNGKey(0)), steps=60,
                            max_steps=60)
    m = build_model(get_smoke_config(ARCH).replace(dtype="float32"))
    m.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, m


def _serve(engine, request_cls, prompts, rounds, max_new):
    convos = [list(p) for p in prompts]
    reqs_all = []
    for _ in range(rounds):
        reqs = [request_cls(prompt=list(c), max_new_tokens=max_new,
                            eos_id=None) for c in convos]
        for r in reqs:
            engine.submit(r)
        engine.run()
        for c, r in zip(convos, reqs):
            c += r.output + [99, 98]
        reqs_all += reqs
    return reqs_all


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "ring"])
def test_mesh_1x1_matches_jax(fitted, paged):
    jm, params, m = fitted
    kw = dict(PARITY, max_batch=3, max_seq=160, page_size=8,
              prefill_chunk=16, prefill_token_budget=24, paged_kv=paged,
              aot_warmup=False, mesh="1x1")
    prompts = [ramp_prompt(10 + 9 * i, 22 + 5 * i) for i in range(4)]
    jeng = JEngine(jm, params, JServeConfig(**kw))
    jreqs = _serve(jeng, JRequest, prompts, rounds=2, max_new=10)
    eng = Engine(m, ServeConfig(**kw), device="cpu")
    reqs = _serve(eng, Request, prompts, rounds=2, max_new=10)

    assert all(r.status is Status.DONE for r in reqs)
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert ([dataclasses.asdict(r.usage) for r in reqs]
            == [dataclasses.asdict(r.usage) for r in jreqs])
    st, jst = eng.stats(), jeng.stats()
    assert {k: st[k] for k in STEP_KEYS} == {k: jst[k] for k in STEP_KEYS}
    for k in ("mesh", "n_devices", "resident_kv_bytes",
              "resident_kv_bytes_per_device"):
        assert st[k] == jst[k], k
    assert st["mesh"] == {"data": 1, "model": 1}
    assert st["verify_steps"] > 0 and st["prefix_cache"]["hits"] > 0
    # the caller's model is not placed: it still serves without a mesh
    assert not any(type(p).__name__ == "DTensor" for p in m.parameters())


CHILD = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ServeConfig
    from repro_torch.models.registry import build_model, get_smoke_config
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, Status
    from repro_torch.train.quick_fit import ramp_prompt

    rank, store, weights, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                 sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    m = build_model(get_smoke_config("reflect_demo_100m").replace(
        dtype="float32"))
    m.load_state_dict(torch.load(weights))
    kw = json.loads(sys.argv[5])
    res = {}
    for paged in (True, False):
        eng = Engine(m, ServeConfig(**kw, paged_kv=paged, mesh="1x2"),
                     device="cpu")
        convos = [ramp_prompt(10 + 9 * i, 22 + 5 * i) for i in range(3)]
        streams = []
        for _ in range(2):
            reqs = [Request(prompt=list(c), max_new_tokens=8, eos_id=None)
                    for c in convos]
            for r in reqs:
                eng.submit(r)
            eng.run()
            assert all(r.status is Status.DONE for r in reqs)
            streams += [r.output for r in reqs]
            for c, r in zip(convos, reqs):
                c += r.output + [99, 98]
        st = eng.stats()
        res["paged" if paged else "ring"] = {
            "streams": streams, "stats": {k: st[k] for k in (
                "mesh", "n_devices", "step_compiles", "verify_steps",
                "resident_kv_bytes", "resident_kv_bytes_per_device",
                "kv_pool_pages") if k in st},
            "pool_leaves": sum(len(c) for c in eng.cache
                               if "kp" in c)}
    json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")


def _single(m, paged):
    eng = Engine(m, ServeConfig(**PARITY, paged_kv=paged), device="cpu")
    convos = [ramp_prompt(10 + 9 * i, 22 + 5 * i) for i in range(3)]
    streams = []
    for _ in range(2):
        reqs = [Request(prompt=list(c), max_new_tokens=8, eos_id=None)
                for c in convos]
        for r in reqs:
            eng.submit(r)
        eng.run()
        streams += [r.output for r in reqs]
        for c, r in zip(convos, reqs):
            c += r.output + [99, 98]
    return streams, eng.stats()


def test_mesh_1x2_matches_single_device(fitted, tmp_path):
    """Two gloo ranks serve the single-device engine's streams, paged
    (int8 KV, speculation, warm-up: the reference parity test's engine)
    and on rings; each holds half the pool's used bytes.  Every join is
    bounded: a rank still running at the limit is killed and the test
    fails."""
    _, _, m = fitted
    weights = tmp_path / "weights.pt"
    torch.save(m.state_dict(), weights)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(r), str(tmp_path / "store"),
         str(weights), str(outs[r]), json.dumps(PARITY)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    deadline = time.monotonic() + JOIN_S
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank did not finish in {JOIN_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        x[-3000:] for x in logs)
    ranks = [json.loads(o.read_text()) for o in outs]
    assert ranks[0] == ranks[1]
    got = ranks[0]
    for mode, paged in (("paged", True), ("ring", False)):
        want, st = _single(m, paged)
        assert got[mode]["streams"] == want, mode
        meshed = got[mode]["stats"]
        assert meshed["mesh"] == {"data": 1, "model": 2}
        assert meshed["n_devices"] == 2 and meshed["step_compiles"] == 0
        assert meshed["verify_steps"] == st["verify_steps"] > 0
        assert meshed["resident_kv_bytes"] == st["resident_kv_bytes"]
    paged = got["paged"]
    # the pool's pages are split over the two ranks; the demo has no
    # dense per-slot state beside its pools (each leaf rounds down once)
    per_dev = paged["stats"]["resident_kv_bytes_per_device"]
    total = paged["stats"]["resident_kv_bytes"]
    assert abs(2 * per_dev - total) <= 2 * paged["pool_leaves"]
    assert paged["stats"]["kv_pool_pages"] % 2 == 0
