"""End-to-end serving demo on the PyTorch/CUDA port: the paper's
reflection-strategy grid through ``repro_torch``'s engine, with execution
feedback, prompt caching and speculative decoding.

    PYTHONPATH=src python examples/torch_reflection_serving.py [--full] [--aot]
    PYTHONPATH=src python examples/torch_reflection_serving.py --device cpu

The counterpart of ``examples/reflection_serving.py``: {0, 1, 3}
reflection rounds x {none, exec} feedback over 4 synthetic SQL tasks, a
fresh engine per strategy (``ServeConfig(max_batch=4, max_seq=1536,
page_size=32, spec_decode=True)``, 24 new tokens a round).  Every round
re-encodes the whole conversation as byte text — prompt, answer,
reflection instruction, feedback, the question again — and the rounds of
a task share a conversation, so later rounds read the earlier ones from
the prefix cache.

For each strategy it prints the bill (fresh input, cache reads, output
tokens, and dollars under the paper's nova_micro Bedrock price book), the
paper's MODELED API latency (``LatencyModel``: Bedrock figures, not this
device's) beside the wall time each round took on the serving device,
per round index the median and max over tasks, prefix-cache hits per
round, speculation accepted/drafted and ms per engine step.  Weights are
random from a seed, so answers — and accuracy — are noise.

Runs on the CUDA device unless ``--device cpu`` is given (then on the
smoke config); without a card the default raises.  ``--full`` serves
reflect_demo_100m at full width and depth (bf16 activations) instead of
the smoke config; ``--aot`` captures every serving step at startup
(``ServeConfig.aot_warmup``: CUDA graphs on a card).
"""
import argparse
import dataclasses
import itertools
import statistics
import time

import torch

from repro_torch.configs.base import ServeConfig
from repro_torch.core.accounting import CostModel, LatencyModel
from repro_torch.core.budget import InferenceStrategy
from repro_torch.core.feedback import ExecutionFeedback, NoFeedback
from repro_torch.core.reflection import EngineBackend, ReflectionController
from repro_torch.data.tasks import make_sql_tasks
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model, get_config, \
    get_smoke_config
from repro_torch.serving.engine import Engine

SERVE = dict(max_batch=4, max_seq=1536, page_size=32, spec_decode=True)
MAX_NEW = 24
GRID = ((0, "none"), (1, "none"), (1, "exec"), (3, "none"), (3, "exec"))
STEP_KINDS = ("mixed_steps", "decode_batch_steps", "verify_steps")


class TimedBackend(EngineBackend):
    """``EngineBackend`` that times each round on the host clock, the
    device synchronised on both sides, and counts the prefix-cache hits
    the round scored and its speculative drafts (accepted, drafted).
    ``walls``, ``hits`` and ``spec`` hold one list per task."""

    def __init__(self, engine, tokenizer, max_new_tokens):
        super().__init__(engine, tokenizer, max_new_tokens)
        self.walls, self.hits, self.spec = [], [], []

    def _sync(self):
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)

    def complete_many(self, *args, **kwargs):
        h0 = self.engine.prefix_cache.stats["hits"]
        self._sync()
        t0 = time.perf_counter()
        out = super().complete_many(*args, **kwargs)
        self._sync()
        self.walls[-1].append(time.perf_counter() - t0)
        self.hits[-1].append(self.engine.prefix_cache.stats["hits"] - h0)
        reqs = self.last_requests
        self.spec[-1].append((sum(r.spec_accepted for r in reqs),
                              sum(r.spec_drafted for r in reqs)))
        return out


@dataclasses.dataclass
class Served:
    """One strategy's run: a ReflectionResult, and round walls (s), prefix
    hits and speculation per round for each task; the engine's stats after
    it."""
    name: str
    results: list
    walls: list
    hits: list
    spec: list
    stats: dict


def serve_strategy(engine, rounds, feedback, tasks, router=None, slos=None):
    """The reflection loop of one strategy over ``tasks`` on ``engine``
    (fixed rounds, or routed when ``router`` is given, each task under its
    SLO from ``slos``)."""
    backend = TimedBackend(engine, ByteTokenizer(), MAX_NEW)
    ctrl = ReflectionController(
        InferenceStrategy(rounds, feedback=feedback),
        feedback=ExecutionFeedback() if feedback == "exec" else NoFeedback(),
        router=router)
    results = []
    for task, slo in zip(tasks, slos or [None] * len(tasks)):
        for per_task in (backend.walls, backend.hits, backend.spec):
            per_task.append([])
        results.append(ctrl.run_task(backend, task, slo))
    name = f"{'routed' if router else f'reflect{rounds}'}/{feedback}"
    return Served(name, results, backend.walls, backend.hits, backend.spec,
                  engine.stats())


def report(served, cost, lat, device_name):
    """Lines describing one strategy's run."""
    res = served.results
    fresh = sum(r.usage.input_tokens for r in res)
    cached = sum(r.usage.cache_read_tokens for r in res)
    out = sum(r.usage.output_tokens for r in res)
    dollars = sum(cost.cost(r.usage) for r in res)
    st = served.stats
    steps = sum(st[k] for k in STEP_KINDS)
    wall = sum(map(sum, served.walls))
    acc = sum(bool(r.final.correct) for r in res)
    lines = [
        f"{served.name:14s} fresh_in {fresh:6d}  cached {cached:6d}  out "
        f"{out:4d}  ${dollars:.6f} (paper's nova_micro prices)  accuracy "
        f"{acc}/{len(res)} (random weights: noise)",
        f"{'':14s} {steps} engine steps, {wall * 1e3 / max(steps, 1):.3f} "
        f"ms each on {device_name}; speculation {st['spec_accepted']}/"
        f"{st['spec_drafted']} drafts accepted in {st['verify_steps']} "
        f"verify steps; prefix hits per round "
        f"{[sum(h) for h in itertools.zip_longest(*served.hits, fillvalue=0)]}"]
    lines.append(
        f"{'':14s} per task: paper's modeled API latency (s) "
        f"{[round(lat.latency(r.usage), 3) for r in res]}, wall on "
        f"{device_name} (s) {[round(sum(w), 4) for w in served.walls]}")
    for i in range(max(len(w) for w in served.walls)):
        walls = [w[i] for w in served.walls if len(w) > i]
        modeled = [lat.latency(r.rounds[i].usage) for r in res
                   if len(r.rounds) > i]
        usage = [r.rounds[i].usage for r in res if len(r.rounds) > i]
        reads = sum(u.cache_read_tokens for u in usage)
        spec = [s[i] for s in served.spec if len(s) > i]
        lines.append(
            f"{'':14s} round {i}: modeled median "
            f"{statistics.median(modeled):.3f} s max {max(modeled):.3f} s "
            f"(paper); wall median {statistics.median(walls) * 1e3:.2f} ms "
            f"max {max(walls) * 1e3:.2f} ms ({device_name}); cache-read "
            f"share {reads / (reads + sum(u.input_tokens for u in usage)):.3f}"
            f"; speculation {sum(a for a, _ in spec)}/"
            f"{sum(d for _, d in spec)}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    ap.add_argument("--full", action="store_true",
                    help="reflect_demo_100m at full width and depth")
    ap.add_argument("--aot", action="store_true",
                    help="capture every serving step at startup")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_config("reflect_demo_100m") if args.full else
           get_smoke_config("reflect_demo_100m").replace(dtype="float32"))
    model = build_model(cfg).init(torch.Generator().manual_seed(0))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    tasks = make_sql_tasks(4, seed=0)
    cost = CostModel.for_model("nova_micro")
    lat = LatencyModel.for_model("nova_micro")
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"serving on {name}{' with captured steps' if args.aot else ''}")
    for rounds, fb in GRID:
        engine = Engine(model, ServeConfig(**SERVE, aot_warmup=args.aot),
                        device=device)
        served = serve_strategy(engine, rounds, fb, tasks)
        print("\n".join(report(served, cost, lat, name)))
    print("(random weights: accuracy is noise; the table demonstrates the "
          "port's reflection, caching and accounting machinery)")


if __name__ == "__main__":
    main()
