"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

The port of ``repro/launch/serve.py``'s single-engine path: one
``Engine``, ``--rounds`` reflection rounds over ``--requests``
conversations, each round's prompt being the previous prompt plus its
output plus the reflection suffix ``[99, 98]``; prints throughput and
prefix-cache statistics.  It serves the reduced (smoke) config of any
architecture in the port's registry (``models/registry.py``: dense,
MoE such as ``granite_moe_1b_a400m``, mamba and RG-LRU hybrids) with
seeded random weights, as the reference does, and runs on the CUDA
device unless ``--device cpu`` is given.  ``--aot`` warms every serving
step before the first request (``ServeConfig.aot_warmup``: CUDA graphs
captured on a card, eager runs through the same buffers on the CPU) and
prints the startup time and the recompile tripwire.  ``--mesh`` and
``--replicas`` are accepted as in the reference and raise
``NotImplementedError``: meshes and fleets are not ported.
"""
import argparse
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
                    help="serve mesh (not ported: raises)")
    ap.add_argument("--aot", action="store_true",
                    help="warm every serving step at startup (CUDA "
                    "graphs on a card)")
    ap.add_argument("--replicas", type=int, default=0, metavar="N",
                    help="fleet of N engines (not ported: raises)")
    ap.add_argument("--policy", default="affinity",
                    choices=("affinity", "round_robin"))
    ap.add_argument("--trace-requests", type=int, default=24)
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

    if args.replicas > 0:
        raise NotImplementedError("fleet serving (--replicas) is not ported")
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch).replace(dtype="float32")
    model = build_model(cfg).init(torch.Generator().manual_seed(0))

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
    print(f"{args.requests} requests x {args.rounds} rounds in {dt:.2f}s "
          f"on {device}")
    print(f"decode {st['decode_steps']} tok "
          f"({st['decode_steps']/dt:.1f} tok/s), prefill "
          f"{st['prefill_tokens']} tok, extend {st['extend_tokens']} tok "
          f"({st['prefill_chunks']} chunks, {st['mixed_steps']} mixed "
          f"steps, max {st['max_step_prefill_tokens']} prefill tok/step)")
    print(f"attn_impl {st['attn_impl']}: resident KV "
          f"{st['resident_kv_bytes']} B "
          f"(pool {st['kv_pool_pages_used']}/{st['kv_pool_pages']} pages)")
    print(f"startup {startup:.2f}s")
    if args.aot:
        print(f"aot warmup: {st['aot_warmed']} step shapes in "
              f"{st['startup_compile_s']:.2f}s; step_compiles "
              f"{st['step_compiles']} {st['step_compiles_by_fn']}")
    if engine.prefix_cache:
        print(f"prefix cache: {engine.prefix_cache.stats_snapshot()}")


if __name__ == "__main__":
    main()
