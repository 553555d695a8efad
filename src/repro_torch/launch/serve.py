"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

The port of ``repro/launch/serve.py``'s single-engine path: one
``Engine``, ``--rounds`` reflection rounds over ``--requests``
conversations, each round's prompt being the previous prompt plus its
output plus the reflection suffix ``[99, 98]``; prints throughput and
prefix-cache statistics.  It serves the reduced (smoke) config of any
architecture in the port's registry (``models/registry.py``: dense,
MoE such as ``granite_moe_1b_a400m``, mamba and RG-LRU hybrids, the
VLM's text decoder ``internvl2_76b`` on the paged pool, and
``whisper_tiny``, which has no paged layout and so serves from rings)
with seeded random weights, as the reference does, and runs on the CUDA
device unless ``--device cpu`` is given.  ``--aot`` warms every serving
step before the first request (``ServeConfig.aot_warmup``: CUDA graphs
captured on a card, eager runs through the same buffers on the CPU) and
prints the startup time and the recompile tripwire.

``--mesh DxM`` serves mesh-placed (``ServeConfig.mesh``: parameters
tensor-parallel along 'model', the paged KV pool sharded by physical
page) and prints the reference's ``mesh ... (n dev, ...)`` line with the
resident KV on each device.  ``--mesh 1x1`` serves in this process, on
the card or with ``--device cpu``.  A mesh of D*M > 1 devices runs one
process a device on the CPU, under ``torchrun``, which starts the ranks
and gives them the group's address (rank 0 prints)::

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --device cpu --mesh 1x2

A mesh of more than one card raises ``NotImplementedError`` (ROADMAP A17).

``--replicas N`` serves a fleet instead of one engine, as the reference
does: N engines on ``--device`` behind the prefix-affinity router
(``serving/fleet.py``), replaying a seeded trace (``--trace-requests``
arrivals, ``serving/trace.py``) and printing the fleet report —
per-replica assignment counts, p50/p99 TTFT, goodput, the fleet's
prefix-hit rate, spillovers and steals.  ``--policy round_robin`` swaps
in the baseline; ``--aot`` captures each replica's steps.  The replicas
are pumped in turn on one device, so on one card the fleet measures
routing and queueing, not parallel replicas.
"""
import argparse
import os
import time

from repro_torch.models.registry import ARCH_IDS, EXTRA_ARCH_IDS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="reflect_demo_100m",
                    help="an architecture id of models/registry.py "
                    f"({', '.join(ARCH_IDS + EXTRA_ARCH_IDS)}) or its "
                    "public alias")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve mesh, e.g. 1x2 (data x model); D*M > 1 "
                    "under torchrun --nproc-per-node D*M, on the CPU")
    ap.add_argument("--aot", action="store_true",
                    help="warm every serving step at startup (CUDA "
                    "graphs on a card)")
    ap.add_argument("--replicas", type=int, default=0, metavar="N",
                    help="serve a fleet of N engines behind the router")
    ap.add_argument("--policy", default="affinity",
                    choices=("affinity", "round_robin"),
                    help="fleet routing policy (with --replicas)")
    ap.add_argument("--trace-requests", type=int, default=24,
                    help="trace arrivals to replay (with --replicas)")
    ap.add_argument("--trace-seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.base import ServeConfig
    from repro_torch.device import resolve_device
    from repro_torch.models.registry import build_model, get_smoke_config
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request

    device = resolve_device(args.device)
    if args.mesh and "WORLD_SIZE" in os.environ:
        # started by torchrun: join its group (its address is in the env)
        import torch.distributed as dist
        if not dist.is_initialized():
            dist.init_process_group(
                "nccl" if device.type == "cuda" else "gloo")
    say = print if int(os.environ.get("RANK", 0)) == 0 else (
        lambda *a, **k: None)
    cfg = get_smoke_config(args.arch).replace(dtype="float32")
    model = build_model(cfg).init(torch.Generator().manual_seed(0))

    if args.replicas > 0:
        serve_fleet(args, model, device)
        return

    t_init = time.perf_counter()
    engine = Engine(model,
                    ServeConfig(max_batch=4, max_seq=512, page_size=16,
                                prefix_cache=not args.no_prefix_cache,
                                mesh=args.mesh, aot_warmup=args.aot),
                    device=device)
    startup = time.perf_counter() - t_init

    convos = [[1] + list(range(10 + 7 * i, 30 + 7 * i))
              for i in range(args.requests)]
    t0 = time.perf_counter()
    for _ in range(args.rounds):
        reqs = [Request(prompt=list(c), max_new_tokens=args.max_new,
                        eos_id=None) for c in convos]
        for r in reqs:
            engine.submit(r)
        engine.run()
        for c, r in zip(convos, reqs):
            c += r.output + [99, 98]          # reflection suffix
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    st = engine.stats()
    say(f"{args.requests} requests x {args.rounds} rounds in {dt:.2f}s "
        f"on {device}")
    say(f"decode {st['decode_steps']} tok "
        f"({st['decode_steps']/dt:.1f} tok/s), prefill "
        f"{st['prefill_tokens']} tok, extend {st['extend_tokens']} tok "
        f"({st['prefill_chunks']} chunks, {st['mixed_steps']} mixed "
        f"steps, max {st['max_step_prefill_tokens']} prefill tok/step)")
    say(f"mesh {st['mesh'] or 'single-device'} ({st['n_devices']} dev, "
        f"attn_impl {st['attn_impl']}): resident KV "
        f"{st['resident_kv_bytes']} B total, "
        f"{st['resident_kv_bytes_per_device']} B/device "
        f"(pool {st.get('kv_pool_pages_used', 0)}/"
        f"{st.get('kv_pool_pages', 0)} pages)")
    say(f"startup {startup:.2f}s")
    if args.aot:
        say(f"aot warmup: {st['aot_warmed']} step shapes in "
            f"{st['startup_compile_s']:.2f}s; step_compiles "
            f"{st['step_compiles']} {st['step_compiles_by_fn']}")
    if engine.prefix_cache:
        say(f"prefix cache: {engine.prefix_cache.stats_snapshot()}")


def serve_fleet(args, model, device) -> None:
    """``--replicas``: the reference's fleet report, on ``device``."""
    from collections import Counter

    import torch

    from repro_torch.configs.base import ServeConfig
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.fleet import EngineReplica, Router, RouterConfig
    from repro_torch.serving.trace import TraceConfig, generate_trace

    scfg = ServeConfig(max_batch=4, max_seq=256, page_size=16,
                       prefix_cache=not args.no_prefix_cache,
                       mesh=args.mesh, aot_warmup=args.aot)
    t_init = time.perf_counter()
    replicas = [EngineReplica(i, Engine(model, scfg, device=device))
                for i in range(args.replicas)]
    startup = time.perf_counter() - t_init
    trace = generate_trace(TraceConfig(
        n_requests=args.trace_requests, seed=args.trace_seed,
        mean_rate=50.0, vocab=model.cfg.vocab_size,
        out_tokens=(4, args.max_new)))
    router = Router(replicas, RouterConfig(policy=args.policy))
    t0 = time.perf_counter()
    report = router.run_trace(trace)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    s = report.summary()
    per_rep = Counter(rid for _, rid in report.assignments)
    print(f"fleet: {args.replicas} replicas, policy={args.policy}, "
          f"{s['requests']} requests in {dt:.2f}s on {device} "
          f"(startup {startup:.2f}s)")
    print("  assignment: "
          + " ".join(f"r{i}={per_rep.get(i, 0)}"
                     for i in range(args.replicas))
          + f"  spillovers={s['spillovers']} steals={s['steals']}")
    print(f"  ttft p50={s['p50_ttft_ms']:.1f}ms "
          f"p99={s['p99_ttft_ms']:.1f}ms goodput={s['goodput']:.3f} "
          f"prefix_hit_rate={s['prefix_hit_rate']:.3f}")
    print(f"  preempt/slo/timeout: {s['preemptions']}"
          f"/{s['slo_rejections']}/{s['timeouts']}")
    leaked = router.shutdown_check()
    print(f"  leaked pages after cache release: {leaked}")
    for r in replicas:
        st = r.engine.stats_snapshot()
        pc = st.get("prefix_cache", {})
        print(f"  r{r.rid}: prefill={st['prefill_tokens']} "
              f"decode={st['decode_tokens']} "
              f"pre={st['preemptions']} "
              f"cache hits={pc.get('hits', 0)}"
              f"+{pc.get('partial_hits', 0)}p"
              f"/{pc.get('misses', 0)}m")
        if args.aot:
            print(f"  r{r.rid}: step_compiles "
                  f"{r.engine.stats()['step_compiles']}")


if __name__ == "__main__":
    main()
