"""Quickstart on the PyTorch/CUDA port: build a model, serve a reflection
conversation, see the prompt cache + budget tiers + cost accounting in
action.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The counterpart of ``examples/quickstart.py``: the smoke ``qwen3_0_6b``
config in float32 on a paged engine (``ServeConfig(max_batch=4,
max_seq=384, page_size=16)``), three rounds of one conversation at
``BudgetTier.LOW``, each round re-encoding the question, the answer so far
and a request to reiterate it, billed at the paper's haiku35 prices.
Every round after the first reads the conversation's earlier rounds from
the prefix cache.  It prints the same lines as the reference example.

Runs on the CUDA device unless ``--device cpu`` is given; without a card
the default raises.  Weights are random from ``--seed`` (torch's
initialisation, so the text is noise and differs from the reference's).
"""
import argparse

import torch

from repro_torch.configs.base import ServeConfig
from repro_torch.core.accounting import CostModel
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model, get_smoke_config
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import BudgetTier, Request

QUESTION = "What is the answer to 2+2? Answer in <answer></answer> tags."
ROUNDS = 3


def build(seed: int = 0):
    """The example's model: the smoke qwen3_0_6b config in float32, its
    weights drawn from ``seed`` on the CPU."""
    torch.manual_seed(seed)
    return build_model(get_smoke_config("qwen3_0_6b").replace(
        dtype="float32"))


def converse(model, device) -> dict:
    """Serve the example's conversation on ``device``: the requests of the
    three rounds (their bills in ``usage``) and the engine's prefix-cache
    stats."""
    tok = ByteTokenizer()
    engine = Engine(model, ServeConfig(max_batch=4, max_seq=384,
                                       page_size=16), device=device)
    convo, reqs = QUESTION, []
    for _ in range(ROUNDS):
        req = Request(prompt=tok.encode(convo), max_new_tokens=16,
                      eos_id=None, budget=BudgetTier.LOW,
                      conversation_id="demo")
        engine.submit(req)
        engine.run()
        reqs.append(req)
        convo += (tok.decode(req.output) + " Please reiterate your answer. "
                  + QUESTION)
    return {"requests": reqs, "prefix_cache": dict(engine.prefix_cache.stats)}


def main(argv=None, model=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    run = converse(build(args.seed) if model is None else model, device)

    print("== reflection conversation through the engine ==")
    cost = CostModel.for_model("haiku35")
    total = 0.0
    for rnd, req in enumerate(run["requests"]):
        dollars = cost.cost(req.usage)
        total += dollars
        print(f"round {rnd}: fresh_in={req.usage.input_tokens:4d} "
              f"cache_read={req.usage.cache_read_tokens:4d} "
              f"out={req.usage.output_tokens:3d}  ${dollars:.6f}")

    stats = run["prefix_cache"]
    print(f"\nprefix cache: {stats['hits']} full + {stats['partial_hits']} "
          f"partial hits, {stats['tokens_saved']} prefill tokens saved")
    print(f"total conversation cost: ${total:.6f} (haiku35 pricing)")
    print("(random weights -> noise text; see examples/torch_train_100m.py)")
    return run


if __name__ == "__main__":
    main()
