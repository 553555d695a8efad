"""Sweet-spot finder on the port: the paper's practitioner guidance as a
CLI, over ``repro_torch.core``.

Offline (default): evaluate the full (model x strategy) grid through the
calibrated simulator + accounting stack, print the Pareto frontier, and
select the best configuration under your ceilings:

    PYTHONPATH=src python examples/torch_sweet_spot.py --domain math500 \
        --max-latency 15 --max-cost 0.01

Online (--online): the same ceilings, decided PER REQUEST AT SERVE TIME
by the sweet-spot controller (core/controller.py) — replay a stream of
simulated requests, watch the per-round stop/reflect/escalate decisions,
and print the per-domain Pareto frontier the router learned online:

    PYTHONPATH=src python examples/torch_sweet_spot.py --domain flores --online

The counterpart of ``examples/sweet_spot.py``, printing what it prints.
It runs on the CPU with no model: the paper's simulator and router.  It
keeps its own copy of the reference benchmarks' grid evaluation
(``eval_domain`` below), as the port's benchmark scripts are still to
come.
"""
import argparse
from typing import Dict, List, Tuple

from repro_torch.core import quality_sim as QS
from repro_torch.core.budget import BudgetTier, InferenceStrategy
from repro_torch.core.pareto import (ConfigPoint, pareto_frontier,
                                     sweet_spot)
from repro_torch.core.reflection import evaluate_strategy

N_EXAMPLES = 2000


def eval_domain(domain: str, include_thinking: bool = True
                ) -> Tuple[List[ConfigPoint], Dict]:
    """Every (model x strategy) cell of one domain through the simulator
    and the accounting stack: reflection with 0, 1 and 3 rounds, and the
    thinking budgets where the model has them."""
    points: List[ConfigPoint] = []
    cells: Dict[Tuple[str, str], Dict] = {}
    for model in QS.MODELS:
        strategies = [InferenceStrategy(0), InferenceStrategy(1),
                      InferenceStrategy(3)]
        if include_thinking and "think" in QS.QUALITY[domain][model]:
            strategies += [InferenceStrategy(0, budget=BudgetTier.LOW),
                           InferenceStrategy(0, budget=BudgetTier.HIGH)]
        for s in strategies:
            r = evaluate_strategy(model, domain, s, N_EXAMPLES, seed=17)
            cells[(model, s.name)] = r
            points.append(ConfigPoint(
                name=f"{model}@{s.name}", model=model, strategy=s.name,
                accuracy=r["accuracy"], latency_s=r["latency_s"],
                cost_usd=r["cost_usd"]))
    return points, cells


def offline(args):
    points, _ = eval_domain(args.domain)
    front = pareto_frontier(points)
    print(f"== {args.domain}: accuracy-latency Pareto frontier ==")
    for p in front:
        print(f"  {p.name:28s} acc={p.accuracy:5.1f}  lat={p.latency_s:6.1f}s"
              f"  cost=${p.cost_usd:.4f}")

    best = sweet_spot(points, args.max_latency, args.max_cost)
    lat = f"{args.max_latency}s" if args.max_latency else "-"
    c = f"${args.max_cost}" if args.max_cost else "-"
    if best is None:
        print(f"\nno configuration satisfies latency<={lat}, cost<={c}")
    else:
        print(f"\nsweet spot under latency<={lat}, cost<={c}:")
        print(f"  -> {best.name}: acc={best.accuracy:.1f} "
              f"lat={best.latency_s:.1f}s cost=${best.cost_usd:.4f}")


def online(args):
    import numpy as np

    from repro_torch.core.accounting import CostModel, LatencyModel
    from repro_torch.core.controller import SLO, SweetSpotController
    from repro_torch.core.feedback import LLMJudgeFeedback
    from repro_torch.core.reflection import (ReflectionController,
                                             SimulatedBackend)

    model = args.model
    cm, lm = CostModel.for_model(model), LatencyModel.for_model(model)
    router = SweetSpotController(cm, lm)
    ctrl = ReflectionController(InferenceStrategy(3, feedback="judge"),
                                feedback=LLMJudgeFeedback(seed=0),
                                router=router)
    n = args.n
    traj = QS.simulate_trajectories(args.domain, model, n, 3, seed=7)
    sim = SimulatedBackend(model, args.domain, seed=3)
    rng = np.random.default_rng(11)
    slo = SLO(max_cost_usd=args.max_cost, max_latency_s=args.max_latency)
    accs, costs, rounds = [], [], []
    print(f"== {args.domain}/{model}: routing {n} requests online "
          f"(cost<={args.max_cost or '-'}, deadline<="
          f"{args.max_latency or '-'}) ==")
    for i in range(n):
        res = ctrl.route_simulated(sim, traj.correct[i], slo, rng)
        accs.append(bool(res.final.correct))
        costs.append(cm.cost(res.usage))
        rounds.append(res.rounds_run)
        if i < args.show or i == n - 1:
            path = " -> ".join(f"{d.action}[{d.reason}]" for d in res.trace)
            print(f"  req {i:3d}: rounds={res.rounds_run} "
                  f"${cm.cost(res.usage):.6f} {path}")
    print(f"\nrouted: acc={np.mean(accs)*100:.1f}% "
          f"mean_cost=${np.mean(costs):.6f} "
          f"mean_rounds={np.mean(rounds):.2f}")
    print("learned online frontier:")
    frontier = router.frontiers.get(args.domain)   # absent if every
    for p in (frontier.points if frontier else []):  # request was refused
        print(f"  {p.strategy:16s} acc={p.accuracy:5.1f} "
              f"cost=${p.cost_usd:.6f} lat={p.latency_s:5.1f}s "
              f"(n={p.meta.get('n')})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--domain", default="math500",
                    choices=["math500", "spider", "imdb", "flores"])
    ap.add_argument("--max-latency", type=float, default=None)
    ap.add_argument("--max-cost", type=float, default=None)
    ap.add_argument("--online", action="store_true",
                    help="route a simulated request stream through the "
                         "online sweet-spot controller instead of the "
                         "offline grid sweep")
    ap.add_argument("--model", default="nova_micro",
                    help="(--online) accounting/quality model key")
    ap.add_argument("--n", type=int, default=200,
                    help="(--online) number of requests to replay")
    ap.add_argument("--show", type=int, default=8,
                    help="(--online) per-request decision paths to print")
    args = ap.parse_args(argv)
    if args.online:
        online(args)
    else:
        offline(args)


if __name__ == "__main__":
    main()
