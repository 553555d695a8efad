#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit on any error:

1. device  — the card's name and power limit; TF32 off for matmuls and
   cuDNN, so float32 comparisons are float32.
2. build   — compile the nine hand-written kernels from ``csrc/`` with
   nvcc (one process per source, in parallel) and print ``-Xptxas -v``.
3. kernels — ``[tuning]``: the backend key of the card and the entries
   the tuning table (``repro_torch/kernels/tuning_table.json``) holds for
   it; then each kernel against its plain PyTorch version at the main
   paths' shapes, then kernel and plain-version times from CUDA events
   (cold and warm L2) beside the least time the card could take (bytes
   over HBM rate against operations over peak rate):
   * paged decode and extend at reflect_demo_100m's shapes (q [8,4,3,64];
     extend Sx = 32 and 5; page size 16; scattered page tables with
     unmapped tails, positions mid-page, an empty batch slot, which gets
     the reference's mean of page 0's V; window None and 48) in float32,
     bfloat16 and int8 KV;
   * the same at recurrentgemma-9b's local attention (K 1, G 16, hd 256;
     decode and extend Sx = 32; window None, 48 and 2048), at
     granite-moe-1b-a400m's (K 8, G 2, hd 64; decode, extend Sx = 32 and
     5), at nemotron-4-340b's (K 8, G 12, hd 192; decode, extend Sx = 32
     and 5; window None and 48), and, checked only, at yi-6b's (K 4, G 8)
     and minitron-4b's (K 8, G 3) hd 128; each paged case logs its route
     (bf16 extend on the tensor cores), its tile and its split count with
     where it came from (the wrapper's ``split_plan``: the tuning table's
     entry for this card and shape, else ``cuda_lib.paged_splits``), and
     its record carries both (``splits``, ``splits_from``);
   * the mamba scan at falcon-mamba-7b's shapes ([8, 32 or 1, 8192],
     state 16, a per-(d, n) A and a per-d skip) with float32 and bfloat16
     x, and the RG-LRU scan at recurrentgemma-9b's ([8, 32 or 1, 4096],
     bit for bit), each with a nonzero h0 and pad lanes masked to the
     identity; and the RG-LRU scan at recurrentgemma-9b's full-sequence
     prefill, [4, 4096, 4096], bit for bit;
   * ring decode at reflect_demo_100m's shape (B 8, K 4, G 3, hd 64, C
     2048; rings wrapped past C, empty slots, slots ahead of pos, an
     empty row; window None and 48; float32, bfloat16, int8 and int8 with
     bfloat16 q), granite-moe-1b-a400m's (K 8, G 2),
     recurrentgemma-9b's (K 1, G 16, hd 256, window 2048) and
     nemotron-4-340b's (K 8, G 12, hd 192; every mode, window None and
     48);
   * flash attention at reflect_demo_100m's prefill (B 8, H 12, K 4, hd
     64, S 2048; window None and 48; float32 and bfloat16), at
     granite-moe-1b-a400m's (B 8, H 16, K 8, S 2048, bfloat16), at
     recurrentgemma-9b's (B 4, H 16, K 1, hd 256, S 4096, window 2048,
     bfloat16 and float32) and at a ragged S 1000 with per-row lengths;
     and in its bidirectional-prefix mode at whisper-tiny's encoder (B 8,
     H = K 6, S 1500, hd 64, prefix 1500: every frame attends every frame;
     bfloat16 and float32), at internvl2-76b's prefill (B 4, H 64, K 8, S
     2048, hd 128, prefix 256) and at a ragged S 1000 with prefix 300;
     and at nemotron-4-340b's prefill (B 4, H 96, K 8, S 2048, hd 192;
     bfloat16, window None and 48; float32 at B 1; a ragged S 1000);
   * the flash-attention backward kernel (``csrc/flash_attention_bwd.cu``)
     against ``flash_attention_bwd_ref`` at examples/torch_train_100m.py's
     shape (B 8, H 12, K 4, S 256, hd 64; bfloat16 and float32), at
     recurrentgemma-9b's local attention (B 1, H 16, K 1, S 4096, hd 256,
     window 2048; bfloat16 and float32), at a ragged S 1000 with an empty
     row, and at hd 32 and
     128 with a window and lengths (checked only), in the prefix mode at
     whisper's encoder in training (B 8, H 6, S 1500, prefix 1500;
     bfloat16 and float32) and at internvl2-76b's (B 1, H 64, K 8, S 2048,
     hd 128, prefix 256), the same bits on a
     second call; both dtypes take the lse of a forward launch made outside
     the timed call; timed beside its bound and SDPA's backward, with its
     device time by kernel; and the
     bf16 forward with its lse output against the forward without it, in
     turns, at the training shape;
   * the scans' backward kernels (``csrc/mamba_scan_bwd.cu``,
     ``csrc/rglru_scan_bwd.cu``) against ``mamba_scan_bwd_ref`` and
     ``rglru_scan_bwd_ref`` at the ``[train]`` runs' shapes: mamba
     [8, 256, 8192] N 16 with bf16 and float32 x (1e-4 absolute plus 1e-4
     of each gradient's largest magnitude), RG-LRU [8, 256, 4096] bit for
     bit; the same bits on a second call; timed beside their bounds (no
     PyTorch call computes either); the mamba backward on the tile states
     of one forward launch, with bf16 x its device time by kernel and the
     forward keeping those states against the forward without, in turns.
   The two attention kernels are also timed against one PyTorch call
   computing the same function, ``scaled_dot_product_attention`` with
   ``enable_gqa`` (causal, or a boolean mask for windows, lengths and ring
   tokens), in turns within one loop (kernel, library, library, kernel;
   medians and ranges of each); int8 rings have no such call.  Flash
   cases print their achieved TFLOP/s and ring decode its split count
   and its source (as the paged cases');
   float32 flash cases are bounded as 3xTF32 products (3 x FLOP at 495
   TFLOP/s), their FMA bound printed beside it.  The build prints the
   tensor-core instructions (HGMMA, HMMA) that ``cuobjdump -sass`` finds
   in each body of the flash and flash-backward libraries (bf16 and fp32)
   and in paged extend, each of whose product kernels must hold HGMMA;
   with the parent commit's checkout at ``build/parent`` (unpacked there
   by ``git archive``) it builds its kernels and fails unless the bf16
   flash bodies and the paged and ring-decode kernels compile to the
   parent's SASS (anonymous namespaces' hashes masked), every parent
   function present, a function only this tree has an hd-192
   instantiation.
   ``[quickstart]``: ``examples/torch_quickstart.py`` on the card (three
   rounds of one conversation on the smoke qwen3_0_6b, its lines
   printed): rounds 1 and 2 must read the cache, both paged kernels must
   launch, all in under 15 s.
4. serve   — four models through the port's ``Engine``, one after the
   other, each freed before the next: 8 conversations of a few hundred
   tokens, 3 reflection rounds with the suffix [99, 98], paged KV or ring
   caches, chunked prefill and the prefix cache; and the full-sequence
   entry points.  Launch counters are reset just before each run and
   read just after; every kernel of the run's path must have launched,
   and rounds 2 and 3 must hit the prefix cache.  Every serve runs twice
   on the same weights and prompts: eagerly, then with
   ``aot_warmup=True`` (each step shape captured as a CUDA graph at
   startup and replayed); the captured serve must give the eager serve's
   token streams, ``TokenUsage`` bills, step counters and kernel launches
   and run no step outside its captured shapes, and both print their
   wall and device time a step, tok/s, idle share, startup and peak
   memory.
   * reflect_demo_100m at full width and depth (12 layers, d_model 768,
     bf16 activations, fp32 parameters), with self-speculative decoding,
     then a shorter int8-KV run: paged decode and extend; the same two
     runs on ring caches (``paged_kv=False``): ring decode; then
     ``prefill`` of 8 prompts of 1500-2048 tokens (ragged lengths), 16
     greedy ``decode_step``s on the primed rings, and ``forward`` on
     [8, 2048]: flash attention and ring decode;
   * granite-moe-1b-a400m at full width and depth (24 MoE layers, 32
     experts top-8, d_model 1024, 16 q / 8 KV heads, 1.38 B fp32
     parameters, bf16 activations), paged with speculation: paged decode
     and extend at G 2; its profiled rounds give the MoE FFN's share of
     device time (eager: the ``moe_ffn`` calls' operators, split into
     expert ``bmm``, sorts, gathers and scatters, the rest); then
     ``prefill`` of [8, 2048] (rows of 2048 tokens route one group per
     row), 16 ``decode_step``s and ``forward``, whose aux loss must be
     finite and positive: flash attention and ring decode; then the
     logits check (2 layers) and a 1-layer engine check against the CPU
     (below; at 2 layers its CPU side took a minute of the script's time),
     the routers scaled by 8 so that a flipped expert is not a near tie,
     printing the smallest gap between the k-th and (k+1)-th router
     probability seen;
   * falcon-mamba-7b at full width and depth (64 mamba layers, d_model
     4096, fp32 parameters): the mamba scan;
   * recurrentgemma-9b at full width and depth (38 layers, 26 RG-LRU and
     12 local-attention, bf16 parameters): the RG-LRU scan and both paged
     kernels at hd 256; then on the same weights a ring serve (RG-LRU scan
     and ring decode), ``prefill`` of [4, 4096] (past the 2048-slot local
     ring, which wraps) and 16 ``decode_step``s: flash attention with
     window 2048, ring decode and the RG-LRU scan.
   Weights are random from a seeded CUDA generator.  After each fp serve
   a profiler summary of device time by kernel gives the idle share, and
   a check holds the model's logits on the card against the plain path on
   the CPU, through chunked paged prefill and through ``prefill`` and
   ring ``decode_step`` (the recurrent models at a cut depth; each model
   of the check is built once a device and dtype and walks both
   paths).
   ``[reflect]``: on the full-width demo model, the paper's reflection
   loop through ``repro_torch/core`` — the strategy grid of
   ``examples/torch_reflection_serving.py`` (0, 1 and 3 rounds x no or
   execution feedback, 4 SQL tasks, a fresh engine with captured steps
   each, 24 new tokens a round), then the routed loop (default
   ``ControllerConfig``, the last two tasks under a latency SLO), then
   reflect3/exec eagerly, which must give the captured run's responses,
   bills, step counters and launches; every reflection round must read
   the conversation from the cache, and each strategy prints its bill
   under the paper's price book, the paper's modeled API latency beside
   the card's wall a round, ms a step, speculation and prefix hits; the
   routed loop's engine prices SLOs with its router's book
   (``slo_price_model``) and prints its SLO rejections.
   ``[chaos]``: the demo serve's workload (3 rounds of 32 tokens) on a
   captured engine under a hostile fault plan on a virtual clock (NaN
   and inf logits, a stuck row, a crash, latency spikes; deadlines, the
   stall detector, NaN quarantine; two rows at temperature 0.7): every
   request must end with a known stop reason, no page may be left once
   the cache is released, an engine on ``plan.clone()`` must replay it
   exactly, and a rate-0 plan must give what no plan gives (streams,
   bills, launches), in turns, each serve's wall a step printed.
   ``[fleet]``: live fleets of captured demo replicas on the card
   replaying a 64-request trace (2 and 4 replicas, affinity and round
   robin, then 4 with deadlines and SLO pricing): 64 completions and no
   leaked page each; TTFT p50/p99, goodput, hit rate, wall, tok/s,
   assignments, startup, peak memory and launches printed.  A last
   check serves reflect_demo_100m at two layers in float32 (q/k
   softened) on the card with captured steps and on the CPU through the
   port's engine, token rounds and then reflect1/exec and the routed
   loop over 2 SQL tasks: token streams, bills, the loop's responses,
   decision traces and stop reasons must be identical, and the smallest
   top-1/top-2 logit gap sampled is printed; then both engines under
   clones of the hostile plan (streams, stop reasons, bills, traces,
   fault counters and fires identical), and the fleet trace through 2
   replicas of those two layers on the card and on the CPU (identical
   assignments, and completions apart from their times).
   whisper   — whisper-tiny at full width and depth (4 encoder and 4
   decoder layers, d_model 384, 1500 frames, vocab 51,865): ``[full]``
   ``prefill`` of [8, 448] tokens after seeded frames [8, 1500, 384], 16
   ring decode steps and ``forward`` (flash in the prefix mode for the
   encoder, P = 1500, causal for the decoder; ring decode); a ring serve
   (whisper has no paged layout and no verify step, so no speculation, as
   in the reference), eagerly and captured; one float32 step of the
   whole model on the card against the CPU (q/k softened x 0.125), and 20
   AdamW steps of 8 x 256 with seeded frames through ``launch/train.py``:
   the flash forward and backward launched once a layer (encoder layers
   included) and step.
   internvl2 — internvl2-76b's language backbone at full width, 8 of its
   80 layers (17.9 GB of bf16 weights): ``[full]`` ``prefill`` of [4,
   1792] tokens after 256 seeded patch embeddings (S 2048, prefix 256),
   16 decode steps from position 256 + length and ``forward`` with the
   patches; a paged serve of the text decoder, eagerly and captured (2
   rounds of 32); the logits check at 2 layers with 256 patches before
   the prompt of the full-sequence walk (q/k x 1/16).
   nemotron  — nemotron-4-340b at full width (d_model 18432, 96 q / 8 KV
   heads, hd 192, d_ff 73,728, vocab 256,000 untied), 4 of its 96 layers
   (46.5 GB of bf16 weights): ``[full]`` ``prefill`` of [4, 2048] with
   ragged lengths, 16 decode steps and a no-grad ``forward`` (flash and
   ring decode at hd 192); a paged serve with speculation, eagerly and
   captured (2 rounds of 32); the logits check at 1 layer (51.6 GB in
   fp32 on the card and on the host, q/k x 1/16; the sensitivity step
   perturbs the card's model in place; the host's memory is printed).
5. train   — training on the card (``[train]``):
   * one float32 loss and gradient of the full-width 2-layer demo on the
     card and on the CPU (loss to 1e-4 relative, gradient cosines at
     least 0.9999), and one bfloat16 loss and gradient of the same cut on
     the card through the flash kernels, against the forward kernel with
     the plain backward (random init) and against autograd of the plain
     version (q/k softened by 0.125): every gradient cosine at least
     0.999; on the random init the forward kernel's output at the first
     layer's q, k, v against the plain version (2e-2), and, printed, the
     kernels and a plain step with P rounded to bf16 against plain
     attention;
   * examples/torch_train_100m.py's run: full-width, full-depth
     reflect_demo_100m, 200 AdamW steps of 8 x 256 in bf16; the loss must
     be finite and fall (its ratio to the start is printed beside the
     reference example's 0.7, which this recipe does not reach at full
     width: PERF.md), the flash forward and backward launched once a
     layer and step, and the checkpoint must restore the weights; ms a
     step, tokens/s, peak memory;
   * ``quick_fit_ramp`` on the card on the 2-layer cut, then
     ``check_engine`` on those port-fitted weights (streams, bills and the
     reflection loop identical on the card and the CPU);
   * ``quick_fit_reflect`` on the 2-layer cut and a round-2 reflection
     serve with speculation, which must accept drafts and keep the
     streams it gives without speculation;
   * the recurrent families: one float32 loss and gradient of
     falcon-mamba-7b's and of recurrentgemma-9b's 2-layer full-width cuts
     (1 x 256) on the card and on the CPU (as the demo's: loss 1e-4
     relative, cosines at least 0.9999), through the scans' forward and
     backward kernels; 20 AdamW steps of 8 x 256 (bf16 activations, fp32
     parameters) of falcon-mamba-7b at full width and 4 layers and of
     recurrentgemma-9b at full width and 3 layers (rglru, rglru,
     rg_attn) through ``launch/train.py``: the loss must be finite and
     fall, and each scan and its backward launch once a layer and step
     (ms a step, tokens/s, peak memory, the card's name and power limit);
     and ``quick_fit_ramp`` of falcon-mamba-7b's 2-layer fp32 cut on the
     card at SGD lr 0.1 for its base 120 steps (the reference's 0.5
     collapses this cut's logits, and more steps at 0.1 do not bring its
     margin above 0), its margin printed, then ``check_engine`` on those
     weights.
   Each fitted model must have exact top-2 logit ties at no more than
   0.01 of the positions of random prompts (``tie_share``), so that an
   engine check on it compares the model, not tie-breaking.
   Then ring decode is read again in turns with SDPA (``[ring re-read]``).
   mesh      — ``[mesh]``: full-width reflect_demo_100m served by
   ``Engine(mesh="1x1")`` (parameters and page pools as DTensors on a
   one-rank NCCL mesh, the attention reads inside ``local_map``), paged
   with speculation, captured in fp and int8 KV and eagerly in fp, each
   beside the engine without a mesh in turns (none, mesh, mesh, none):
   streams, bills, step counters and launches must agree, both paged
   kernels must launch, the per-device resident KV must equal the whole;
   ms a step of each and what DTensor dispatch adds; a 1x2 mesh on the
   card must raise ``NotImplementedError``; the card's total memory
   beside ``launch/mesh.HBM_BYTES``.
   dryrun    — ``[dryrun]``: ``python -m repro_torch.launch.dryrun --mesh
   single`` (every arch x shape on the ``meta`` device, 16x16) runs in a
   CPU process (one thread, lowest priority) beside the card's phases
   from the end of the build; its lines are printed at the end, and it
   must end with ``all dry-runs passed``.
6. result  — a JSON line of kernel records, the card line, and last the
   JSON status line.

Exits non-zero without a result when no CUDA device is present, or when
the port's sources (``src/``, ``examples/``) are not next to this script.
"""
import contextlib
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12,       # dense tensor-core bf16
            torch.float32: 67e12}         # float32 outside tensor cores
# dense TF32 on the tensor cores: the fp32 flash kernels issue three TF32
# products for each fp32 one (3xTF32), so their bound is 3 x FLOP at this
# rate (an effective 165 TFLOP/s), with the FMA bound kept beside it
TF32_PER_S = 495e12
# exponentials: 16 special-function results a clock per SM (sm_90) on 132
# SMs at the 1.98 GHz boost clock
SFU_PER_S = 16 * 132 * 1.98e9
REPLACES = {"paged_decode": "src/repro/kernels/paged_attention.py:102",
            "paged_extend": "src/repro/kernels/paged_extend.py:121",
            "flash_attention": "src/repro/kernels/flash_attention.py:67",
            "decode_attention": "src/repro/kernels/decode_attention.py:87",
            "mamba_scan": "src/repro/kernels/mamba_scan.py:46",
            "rglru_scan": "src/repro/kernels/rglru_scan.py:31",
            # no Pallas counterparts: the XLA code JAX differentiates
            "flash_attention_bwd": "src/repro/models/attention.py:90",
            "mamba_scan_bwd": "src/repro/models/mamba.py:96",
            "rglru_scan_bwd": "src/repro/models/mamba.py:70"}
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu"
           for name in REPLACES}
STEP_KINDS = ("mixed_steps", "decode_batch_steps", "verify_steps")
STEP_KEYS = ("prefill_tokens", "extend_tokens", "decode_tokens",
             "decode_batch_steps", "mixed_steps", "verify_steps",
             "spec_drafted", "spec_accepted", "preemptions",
             "prefill_chunks")
# engine step kind -> its counter in Engine.stats()
STEP_COUNTERS = {"mixed": "mixed_steps", "decode": "decode_batch_steps",
                 "verify": "verify_steps"}


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------- 1. device

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    log(f"[device] allow_tf32: matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32}")
    return smi


# ---------------------------------------------------------------- 2. build

def phase_build():
    from repro_torch.kernels import cuda_lib
    t0 = time.perf_counter()
    logs = cuda_lib.build()
    log(f"[build] {len(logs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            if line.strip():
                log(f"[build] {name}: {line.strip()}")
    # each flash library's bodies by dtype (functions by their mangled
    # namespaces: flash_tc / tcb bf16, flash_tf32 / tfb fp32), and their
    # tensor-core instructions; every body must run on wgmma
    bodies = {"flash_attention": (("bf16", "8flash_tc"),
                                  ("fp32", "10flash_tf32")),
              "paged_extend": (("all", ""),),
              "flash_attention_bwd": (("bf16", "3tcb"), ("fp32", "3tfb"))}
    for name, kinds in bodies.items():
        fns = sass_functions(cuda_lib._library_path(name))
        for kind, prefix in kinds:
            mine = {f: body for f, body in fns.items() if prefix in f}
            counts = {op: sum(len(re.findall(rf"\b{op}\.", b))
                              for b in mine.values())
                      for op in ("HGMMA", "HMMA")}
            log(f"[build] {name} {kind} SASS: {len(mine)} functions, "
                f"{counts['HGMMA']} HGMMA, {counts['HMMA']} HMMA "
                "instructions")
            products = [f for f in mine if re.search(
                r"flash_tc_kernel|fwd_kernel|dkdv_kernel|dq_kernel|"
                r"paged_extend_tc", f)]
            no_tc = [f for f in products
                     if not re.search(r"\bHGMMA\.", mine[f])]
            if not products or no_tc:
                raise AssertionError(f"a {kind} {name} kernel has no wgmma "
                                     f"(HGMMA): {no_tc or 'none found'}")
    sass_vs_parent(cuda_lib)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        logs["flash_attention_bwd"])
    if not spills or any(s != ("0", "0") for s in spills):
        raise AssertionError("a flash backward kernel spills registers: "
                             f"{spills}")


def sass_functions(path) -> dict:
    """``cuobjdump -sass`` of a library: {function: its SASS}, anonymous
    namespaces' hashes masked (they differ between builds of a file)."""
    from repro_torch.kernels import cuda_lib
    cuobjdump = Path(cuda_lib._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    sass = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}",
                  "_GLOBAL__N_", sass)
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, _, body = part.partition("\n")
        # the instructions and their encodings, not the dump's headers
        # or what follows the last function
        out[name.strip()] = "\n".join(
            line.strip() for line in body.splitlines()
            if line.strip().startswith("/*"))
    return out


# the functions whose SASS must equal the parent's: the bf16 flash bodies
# and every paged and ring-decode kernel
SASS_KEPT = {"flash_attention": "8flash_tc", "flash_attention_bwd": "3tcb",
             "paged_decode": "", "paged_extend": "",
             "decode_attention": ""}


# a template instantiation at head dim 192 (its mangled ``Li192E``
# argument): the one kind of function the tree may add to a kept library
NEW_ALLOWED = re.compile(r"Li192E")


def sass_vs_parent(cuda_lib):
    """With the parent commit's checkout at ``build/parent`` (unpacked
    there by ``git archive``), build its libraries of ``SASS_KEPT`` (one
    nvcc each, in parallel) and print whether each kept function's SASS
    equals the parent's.  A parent function that is missing here or
    differs fails the run; a function only this tree has is listed as new
    and fails it unless it is an hd-192 instantiation (``NEW_ALLOWED``)."""
    csrc = ROOT / "build" / "parent" / "src" / "repro_torch" / "kernels" / \
        "csrc"
    if not csrc.is_dir():
        log("[build] SASS vs the parent: no parent checkout at build/parent; "
            "not compared")
        return
    origin = "build/parent"
    out = ROOT / "build" / "parent_libs"
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
         str(csrc / f"{name}.cu")], stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for name in SASS_KEPT}
    differ = []
    for name, prefix in SASS_KEPT.items():
        if procs[name].wait(timeout=900) != 0:
            raise RuntimeError(f"nvcc failed on the parent's {name}.cu: "
                               f"{procs[name].stderr.read()}")
        mine = {f: b for f, b in
                sass_functions(cuda_lib._library_path(name)).items()
                if prefix in f}
        theirs = {f: b for f, b in sass_functions(out / f"{name}.so").items()
                  if prefix in f}
        same = sorted(f for f in theirs if mine.get(f) == theirs[f])
        new = sorted(set(mine) - set(theirs))
        bad = sorted((set(theirs) - set(same))
                     | {f for f in new if not NEW_ALLOWED.search(f)})
        log(f"[build] SASS vs the parent ({origin}): {name} "
            f"{prefix or 'all'}: {len(same)} of {len(theirs)} parent "
            f"functions equal; {len(new)} new (hd-192 instantiations: "
            f"{sum(bool(NEW_ALLOWED.search(f)) for f in new)})"
            f"{'' if not bad else f'; differ or not allowed: {bad}'}")
        for f in bad[:1]:
            a, b = (d.get(f, "").splitlines() for d in (mine, theirs))
            first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
            log(f"[build] {f}: {len(a)} lines here, {len(b)} in the parent;"
                f" first difference at line {first}: "
                f"{a[first:first + 2]} against {b[first:first + 2]}")
        differ += bad
    if differ:
        raise AssertionError(f"SASS differs from the parent's: {differ}")


# -------------------------------------------------------------- 3. kernels

def make_inputs(seed, B, Sx, K, G, hd, ps, NP, dtype, quant, dev):
    """Scattered pages of a full pool, unmapped tails past each row's
    frontier, positions mid-page, and batch slot B-1 empty."""
    from repro_torch.kernels import kv_quant
    g = torch.Generator().manual_seed(seed)
    P = B * NP
    q = torch.randn(B, Sx, K, G, hd, generator=g)
    kp = torch.randn(P, ps, K, hd, generator=g)
    vp = torch.randn(P, ps, K, hd, generator=g)
    pt = torch.randperm(P, generator=g)[:B * NP].view(B, NP).to(torch.int32)
    last = torch.randint(ps * 4, NP * ps - ps, (B,), generator=g)
    last = last - last % ps + ps // 2 - 1          # mid-page frontier
    pos0 = (last - (Sx - 1)).to(torch.int32)
    for b in range(B):
        pt[b, int(last[b]) // ps + 1:] = -1
    pt[B - 1] = -1
    sc = {}
    if quant:
        kp, ks, kz = kv_quant.quantize_k(kp)
        vp, vs = kv_quant.quantize_v(vp)
        sc = {"k_scale": ks.to(dev), "k_zero": kz.to(dev),
              "v_scale": vs.to(dev)}
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    return (q.to(dev, dtype), kp.to(dev), vp.to(dev), pt.to(dev),
            pos0.to(dev), sc)


def work(q, kp, pt, pos0, sc, window):
    """Bytes the function must move and operations it must do on this
    data: every valid K/V slot read once (with its int8 sidecars), q read,
    out written, table and positions read; 4 * hd operations per (query
    row, valid slot) for QK^T and PV.  A request with a lane that has no
    valid slot (the empty batch slot) also reads the V of every page its
    table gathers (page 0 for unmapped entries) once, and adds them up."""
    B, Sx, K, G, hd = q.shape
    ps = kp.shape[1]
    pt_h, pos_h = pt.cpu().numpy(), pos0.cpu().numpy()
    NP = pt_h.shape[1]
    t = np.arange(NP * ps)
    union = pairs = mean_pages = mean_adds = 0
    for b in range(B):
        mapped = np.repeat(pt_h[b] >= 0, ps)
        seen = np.zeros_like(mapped)
        empty = False
        for lane in range(Sx):
            p = pos_h[b] + lane
            v = mapped & (t <= p)
            if window is not None:
                v &= t > p - window
            pairs += int(v.sum())
            seen |= v
            empty |= not v.any()
        union += int(seen.sum())
        if empty:
            mean_pages += len(set(np.maximum(pt_h[b], 0).tolist()))
            mean_adds += NP * ps * K * hd
    slot_bytes = 2 * K * hd * kp.element_size() + (3 * K * 4 if sc else 0)
    v_page_bytes = ps * K * (hd * kp.element_size() + (4 if sc else 0))
    nbytes = (union * slot_bytes + mean_pages * v_page_bytes
              + 2 * q.numel() * q.element_size()
              + pt.numel() * 4 + pos0.numel() * 4)
    ops = 4 * hd * G * K * pairs + mean_adds
    return nbytes, ops


def bound_ms(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def cuda_ms(fn, n=30, flush=None):
    """Mean milliseconds per call from CUDA events after a warm-up.  With
    ``flush`` (a 256 MB write) before every call, L2 holds none of the
    inputs: the cold-L2 time; without it, the warm-L2 time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if flush is None:
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(n):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / n
    total = 0.0
    for _ in range(n):
        flush()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        total += s.elapsed_time(e)
    return total / n


def interleaved_ms(kern, lib, flush, rounds=10):
    """Kernel and library call timed in turns within one loop, cold-L2
    each (kernel, library, library, kernel a round), so that both see the
    same card state: (median, min, max) milliseconds of each."""
    times = {kern: [], lib: []}
    for fn in (kern, lib):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    for _ in range(rounds):
        for fn in (kern, lib, lib, kern):
            flush()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            times[fn].append(s.elapsed_time(e))
    return [(float(np.median(t)), min(t), max(t))
            for t in (times[kern], times[lib])]


def device_us_by_kernel(fn, calls=5):
    """Mean device microseconds a call of ``fn`` spends in each kernel it
    launches (``torch.profiler``, warm L2, ``calls`` calls after one
    unprofiled): the card's work without the host's time to enqueue it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            name = re.search(r"\w+_kernel(<\d+>)?", e.key)
            out[name.group(0) if name else e.key[:60]] = us / calls
    return out


def time_record(kern, plain, flush, nbytes, nops, dtype, err, exps=0,
                lib=None):
    """Kernel cold-L2 / warm-L2 and plain-version cold-L2 times beside
    the bound: bytes over the HBM rate against operations over the peak
    rate for ``dtype`` (and exponentials over the SFU rate).  With a
    library call ``lib``, the kernel's cold-L2 time and the library's are
    medians of ``interleaved_ms``."""
    bms, by = bound_ms(nbytes, nops, dtype)
    if exps / SFU_PER_S * 1e3 > bms:
        bms, by = exps / SFU_PER_S * 1e3, "operations"
    rec = {"warm_ms": cuda_ms(kern),
           "plain_ms": cuda_ms(plain, n=10, flush=flush),
           "bound_ms": bms, "bound_by": by, "max_abs_err": err,
           "bytes": nbytes, "ops": nops, "exps": exps}
    if lib is None:
        rec["ms"] = cuda_ms(kern, flush=flush)
    else:
        (rec["ms"], *rec["ms_range"]), (rec["library_ms"],
                                        *rec["library_range"]) = \
            interleaved_ms(kern, lib, flush)
    return rec


def tf32x3_bound(rec):
    """Bound an fp32 flash record by its work as 3xTF32 products on the
    tensor cores (3 x FLOP over the TF32 rate), the least time this card
    needs for fp32-accurate products; the FMA bound moves to
    ``bound_fma_ms``."""
    rec["bound_fma_ms"] = rec["bound_ms"]
    t_ops = 3 * rec["ops"] / TF32_PER_S * 1e3
    t_bytes = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    t_exp = rec["exps"] / SFU_PER_S * 1e3
    rec["bound_ms"] = max(t_ops, t_bytes, t_exp)
    rec["bound_by"] = "bytes" if t_bytes >= max(t_ops, t_exp) \
        else "operations"
    return rec


def log_record(label, rec):
    lib = rec.get("library_ms")
    if lib is not None:
        log(f"[kernels] {label}: interleaved cold-L2, kernel median "
            f"{rec['ms']:.4f} ms (range {rec['ms_range'][0]:.4f}-"
            f"{rec['ms_range'][1]:.4f}), library median {lib:.4f} ms (range "
            f"{rec['library_range'][0]:.4f}-{rec['library_range'][1]:.4f}); "
            f"kernel / library {rec['ms'] / lib:.2f}")
    log(f"[kernels] {label}: kernel {rec['ms']:.4f} ms cold-L2 / "
        f"{rec['warm_ms']:.4f} ms warm-L2, plain {rec['plain_ms']:.4f} ms "
        f"cold-L2, library {'none' if lib is None else f'{lib:.4f} ms'} "
        f"cold-L2, bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
        f"({rec['bytes']} B, {rec['ops']} ops, {rec['exps']} exp; HBM "
        f"{rec['bytes'] / rec['ms'] / 1e6:.1f} GB/s)")


def check_record(label, got, want, tol, bf16):
    """Hold a kernel's output against its plain version (float32)."""
    err = float((got.float() - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want, atol=tol, rtol=0.0 if bf16 else tol)
    log(f"[kernels] {label}: max_abs_err={err:.3e} (tol {tol}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def paged_cases(records, tag, shape, cases, modes, windows, timed_window,
                check_np, dev, flush, seed, timed=True):
    """Paged kernels at one model's attention shape: every (case, mode,
    window) against the plain version on a table of ``check_np`` pages,
    then (``timed``) times at ``shape`` (the serve's table) with
    ``timed_window``, also checked."""
    from repro_torch.kernels import cuda_lib, ops, paged_attention, \
        paged_extend, ref
    kernels = {"paged_decode": ops.paged_decode_attention,
               "paged_extend": ops.paged_extend_attention}
    plains = {"paged_decode": ref.paged_decode_attention_ref,
              "paged_extend": ref.paged_extend_attention_ref}
    B, K, G, hd, ps, NP = (shape[k] for k in ("B", "K", "G", "hd", "ps",
                                               "NP"))
    fp = (lambda t: t.float() if t.is_floating_point() else t)
    for name, Sx in cases:
        for mode, dtype, quant, tol in modes:
            # the split the wrapper makes of the timed table (its
            # split_plan: the tuning table's count, else the heuristic's)
            code = cuda_lib.DTYPE_CODES[(dtype, torch.int8 if quant
                                         else dtype)]
            rows = (cuda_lib.decode_rows(G) if name == "paged_decode"
                    else cuda_lib.extend_rows(hd, Sx * G, code))
            tiles = -(-Sx * G // rows)
            splits, source = (
                paged_attention.split_plan(dev, B, K, hd, NP * ps)
                if name == "paged_decode" else
                paged_extend.split_plan(dev, B, Sx, K, G, hd, NP * ps, code))
            route = ("tensor cores" if name == "paged_extend"
                     and code in cuda_lib.TC_CODES else "CUDA cores")
            log(f"[kernels] {tag} {name} Sx={Sx} {mode}: {route}, tiles of "
                f"{rows} rows x {tiles}, {splits} splits a tile (from the "
                f"{source}), {B * K * tiles * splits} blocks")
            for window in windows + (("timed",) if timed else ()):
                seed += 1
                at_shape = window == "timed"
                win = timed_window if at_shape else window
                q, kp, vp, pt, pos0, sc = make_inputs(
                    seed, B, Sx, K, G, hd, ps,
                    NP if at_shape else check_np, dtype, quant, dev)
                if name == "paged_decode":
                    q = q[:, 0].contiguous()
                kern = lambda: kernels[name](q, kp, vp, pt, pos0,
                                             window=win, **sc)
                got = kern()
                torch.cuda.synchronize()
                # the plain version in float32 on the same (rounded) inputs
                want = plains[name](fp(q), fp(kp), fp(vp), pt, pos0,
                                    window=win, **sc)
                err = check_record(
                    f"{tag} {name} Sx={Sx} K={K} G={G} hd={hd} "
                    f"NP={pt.shape[1]} {mode} window={win}", got, want, tol,
                    dtype == torch.bfloat16)
                if not at_shape:
                    continue
                plain = lambda: plains[name](q, kp, vp, pt, pos0,
                                             window=win, **sc)
                q5 = q if q.dim() == 5 else q[:, None]
                nbytes, nops = work(q5, kp, pt, pos0, sc, win)
                rec = time_record(kern, plain, flush, nbytes, nops, dtype,
                                  err)
                rec.update(splits=splits, splits_from=source, tile=rows)
                log_record(f"{tag} {name} Sx={Sx} {mode} window={win}", rec)
                records[(name, tag, Sx, mode)] = rec
    return seed


def scan_cases(records, dev, flush):
    """The two scans at the serves' shapes (mixed step S = 32, decode
    S = 1): nonzero h0, a per-(d, n) A and a per-d skip (so that a lane
    reading another channel's or state's value shows), pad lanes masked to
    the identity (mamba: dt = 0 on the last lanes of all rows but the
    first; RG-LRU: a = 1, b = 0), against the plain versions on the same
    inputs; then the RG-LRU scan at recurrentgemma-9b's full-sequence
    prefill, [4, 4096, 4096]."""
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(11)
    B, D, N, W = 8, 8192, 16, 4096
    for S in (32, 1):
        nv = torch.tensor([S] + [max(1, S - 4 * b) for b in range(1, B)],
                          device=dev)
        pad = (torch.arange(S, device=dev)[None, :] < nv[:, None])
        dt = torch.nn.functional.softplus(
            torch.randn(B, S, D, generator=g, device=dev) - 4.0)
        dt = dt * pad[..., None]
        Bm, Cm = (torch.randn(B, S, N, generator=g, device=dev)
                  for _ in range(2))
        x32 = torch.randn(B, S, D, generator=g, device=dev)
        A = -torch.exp(0.5 * torch.randn(D, N, generator=g, device=dev))
        Dsk = torch.randn(D, generator=g, device=dev)
        h0 = torch.randn(B, D, N, generator=g, device=dev)
        for mode, x in (("float32", x32), ("bfloat16", x32.bfloat16())):
            kern = lambda: ops.mamba_scan(dt, Bm, Cm, x, A, Dsk, h0)
            plain = lambda: ref.mamba_scan_ref(dt, Bm, Cm, x, A, Dsk, h0)
            (y, h), (wy, wh) = kern(), plain()
            torch.cuda.synchronize()
            err = max(float((y - wy).abs().max()),
                      float((h - wh).abs().max()))
            ok = (bool(torch.isfinite(y).all())
                  and torch.allclose(y, wy, atol=1e-4, rtol=1e-4)
                  and torch.allclose(h, wh, atol=1e-4, rtol=1e-4))
            log(f"[kernels] mamba_scan [{B},{S},{D}] N={N} x {mode}: "
                f"max_abs_err={err:.3e} (tol 1e-4 abs + 1e-4 rel) "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"mamba_scan S={S} {mode} disagrees "
                                     "with its plain version")
            nbytes = (dt.numel() * 4 + x.numel() * x.element_size()
                      + (Bm.numel() + Cm.numel() + A.numel() + Dsk.numel())
                      * 4 + 2 * h0.numel() * 4 + y.numel() * 4)
            exps = B * S * D * N
            # dt * A, two multiply-adds (state, output), and the skip
            rec = time_record(kern, plain, flush, nbytes, 5 * exps,
                              torch.float32, err, exps)
            log_record(f"mamba_scan S={S} x {mode}", rec)
            records[("mamba_scan", S, mode)] = rec
        a = torch.sigmoid(torch.randn(B, S, W, generator=g, device=dev))
        b = torch.randn(B, S, W, generator=g, device=dev)
        a.masked_fill_(~pad[..., None], 1.0)
        b.masked_fill_(~pad[..., None], 0.0)
        h0 = torch.randn(B, W, generator=g, device=dev)
        rglru_case(records, a, b, h0, flush)
    # the full-sequence prefill: 4096 sequential steps a channel
    a = torch.sigmoid(torch.randn(4, 4096, W, generator=g, device=dev))
    b = torch.randn(4, 4096, W, generator=g, device=dev)
    rglru_case(records, a, b, torch.randn(4, W, generator=g, device=dev),
               flush)
    del a, b
    torch.cuda.empty_cache()


def rglru_case(records, a, b, h0, flush):
    """The RG-LRU scan against its plain version, bit for bit, then
    timed."""
    from repro_torch.kernels import ops, ref
    B, S, W = a.shape
    kern = lambda: ops.rglru_scan(a, b, h0)
    plain = lambda: ref.rglru_scan_ref(a, b, h0)
    (hs, h), (whs, wh) = kern(), plain()
    torch.cuda.synchronize()
    err = max(float((hs - whs).abs().max()), float((h - wh).abs().max()))
    log(f"[kernels] rglru_scan [{B},{S},{W}]: max_abs_err={err:.3e} "
        f"(tol 0: the kernel rounds as the plain version does) "
        f"{'ok' if err == 0 else 'MISMATCH'}")
    if err != 0 or not bool(torch.isfinite(hs).all()):
        raise AssertionError(f"rglru_scan S={S} disagrees with its "
                             "plain version")
    del hs, h, whs, wh
    rec = time_record(kern, plain, flush,
                      (3 * a.numel() + 2 * h0.numel()) * 4,
                      2 * a.numel(), torch.float32, err)
    log_record(f"rglru_scan S={S}", rec)
    records[("rglru_scan", S, "float32")] = rec


def ring_inputs(seed, B, K, G, hd, C, dtype, quant, dev):
    """A wrapped ring per row (positions past C), 10% empty slots, three
    slots holding tokens past pos (a rejected draft's writes), and batch
    row B-1 empty."""
    from repro_torch.kernels import kv_quant
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, K, G, hd, generator=g)
    k = torch.randn(B, C, K, hd, generator=g)
    v = torch.randn(B, C, K, hd, generator=g)
    pos = torch.randint(C // 2, 3 * C, (B,), generator=g)
    c = torch.arange(C)
    tok = pos[:, None] - (pos[:, None] - c[None, :]) % C
    tok[(tok < 0) | (torch.rand(B, C, generator=g) < 0.1)] = -1
    ahead = (c[None, :] - pos[:, None] % C) % C
    tok = torch.where((ahead >= 1) & (ahead <= 3), pos[:, None] + ahead, tok)
    tok[B - 1] = -1
    sc = {}
    if quant:
        k, ks, kz = kv_quant.quantize_k(k)
        v, vs = kv_quant.quantize_v(v)
        sc = {"k_scale": ks.to(dev), "k_zero": kz.to(dev),
              "v_scale": vs.to(dev)}
    else:
        k, v = k.to(dtype), v.to(dtype)
    return (q.to(dev, dtype), k.to(dev), v.to(dev),
            tok.to(dev, torch.int32), pos.to(dev, torch.int32), sc)


def ring_valid(tok, pos, window):
    valid = (tok >= 0) & (tok <= pos[:, None])
    if window is not None:
        valid &= tok > pos[:, None] - window
    return valid


def ring_work(q, k, tok, pos, window, quant):
    """Bytes, operations and exponentials of a ring decode call on this
    data: every valid slot's K and V read once (with its int8 sidecars),
    the token list and positions read, q read and out written; 4 * hd
    operations and one exponential per (query row, valid slot)."""
    B, K, G, hd = q.shape
    n = int(ring_valid(tok, pos, window).sum())
    slot_bytes = 2 * K * hd * k.element_size() + (3 * K * 4 if quant else 0)
    nbytes = (n * slot_bytes + tok.numel() * 4 + pos.numel() * 4
              + 2 * q.numel() * q.element_size())
    return nbytes, 4 * hd * G * K * n, G * K * n


def ring_cases(records, dev, flush):
    """Ring decode at reflect_demo_100m's, granite-moe-1b-a400m's,
    recurrentgemma-9b's and nemotron-4-340b's decode shapes, every mode
    and window against the plain version; timed at window None (demo,
    granite, nemotron) and 2048 (recurrentgemma), with SDPA on a boolean
    mask built from the tokens as the library yardstick."""
    from repro_torch.kernels import decode_attention, ops, ref
    F = torch.nn.functional
    fp = (lambda t: t.float() if t.is_floating_point() else t)
    modes = (("float32", torch.float32, False, 1e-4),
             ("bfloat16", torch.bfloat16, False, 2e-2),
             ("int8", torch.float32, True, 1e-4),
             ("int8+bf16", torch.bfloat16, True, 2e-2))
    seed = 100
    for tag, (B, K, G, hd, C), windows, timed, mds in (
            ("demo", (8, 4, 3, 64, 2048), (None, 48), None, modes),
            ("granite", (8, 8, 2, 64, 2048), (None,), None, modes),
            ("rg", (8, 1, 16, 256, 2048), (None, 48, 2048), 2048,
             modes[:3]),
            ("nemotron", (8, 8, 12, 192, 2048), (None, 48), None, modes)):
        splits, source = decode_attention.split_plan(dev, B, K, C, hd)
        log(f"[kernels] {tag} decode_attention B={B} K={K} C={C} hd={hd}: "
            f"{splits} splits of {C // splits}-{-(-C // splits)} slots (from "
            f"the {source}), {B * K * splits} blocks")
        for mode, dtype, quant, tol in mds:
            for window in windows:
                seed += 1
                q, k, v, tok, pos, sc = ring_inputs(seed, B, K, G, hd, C,
                                                    dtype, quant, dev)
                kern = lambda: ops.decode_attention(q, k, v, tok, pos,
                                                    window=window, **sc)
                got = kern()
                torch.cuda.synchronize()
                want = ref.decode_attention_ref(fp(q), fp(k), fp(v), tok,
                                                pos, window=window, **sc)
                err = check_record(
                    f"{tag} decode_attention B={B} K={K} G={G} hd={hd} "
                    f"C={C} {mode} window={window}", got, want, tol,
                    dtype == torch.bfloat16)
                if window != timed:
                    continue
                plain = lambda: ref.decode_attention_ref(
                    q, k, v, tok, pos, window=window, **sc)
                lib = None
                if not quant:
                    qh = q.reshape(B, K * G, 1, hd)
                    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
                    mask = ring_valid(tok, pos, window)[:, None, None, :]
                    lib = lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, attn_mask=mask, enable_gqa=True)
                nbytes, nops, exps = ring_work(q, k, tok, pos, window,
                                               quant)
                rec = time_record(kern, plain, flush, nbytes, nops, dtype,
                                  err, exps, lib=lib)
                rec.update(splits=splits, splits_from=source)
                log_record(f"{tag} decode_attention {mode} window={window}",
                           rec)
                records[("decode_attention", tag, mode)] = rec


def flash_valid(S, window, lengths, dev, prefix=0):
    """[B or 1, S, S] mask of the (query, key) pairs flash attends (with
    a bidirectional prefix of ``prefix`` tokens)."""
    i = torch.arange(S, device=dev)
    valid = (i[None, :] <= i[:, None])[None]
    if prefix:
        valid = valid | ((i[:, None] < prefix) & (i[None, :] < prefix))[None]
    if window is not None:
        valid = valid & (i[None, None, :] > i[None, :, None] - window)
    if lengths is not None:
        valid = valid & (i[None, None, :] < lengths.long()[:, None, None])
    return valid


# (tag, (B, H, K, S, hd), window, dtype, ragged lengths, prefix): the
# full-sequence runs' shapes; whisper's encoder (P = S = 1500 frames, MHA)
# and internvl2-76b's patches (P 256) run the prefix mode; nemotron-4-340b
# runs hd 192 (float32 at B 1, a quarter of the bf16 case's work, for the
# phase's time)
FLASH_CASES = (
    ("demo", (8, 12, 4, 2048, 64), None, torch.float32, False, 0),
    ("demo", (8, 12, 4, 2048, 64), None, torch.bfloat16, False, 0),
    ("demo", (8, 12, 4, 2048, 64), 48, torch.float32, False, 0),
    ("demo", (8, 12, 4, 2048, 64), 48, torch.bfloat16, False, 0),
    ("granite", (8, 16, 8, 2048, 64), None, torch.bfloat16, False, 0),
    ("rg", (4, 16, 1, 4096, 256), 2048, torch.bfloat16, False, 0),
    ("rg", (4, 16, 1, 4096, 256), 2048, torch.float32, False, 0),
    ("ragged", (8, 12, 4, 1000, 64), None, torch.bfloat16, True, 0),
    ("whisper", (8, 6, 6, 1500, 64), None, torch.bfloat16, False, 1500),
    ("whisper", (8, 6, 6, 1500, 64), None, torch.float32, False, 1500),
    ("internvl2", (4, 64, 8, 2048, 128), None, torch.bfloat16, False, 256),
    ("prefix-ragged", (8, 12, 4, 1000, 64), None, torch.bfloat16, True,
     300),
    # nemotron-4-340b's prefill: hd 192, G 12
    ("nemotron", (4, 96, 8, 2048, 192), None, torch.bfloat16, False, 0),
    ("nemotron", (1, 96, 8, 2048, 192), None, torch.float32, False, 0),
    ("nemotron", (4, 96, 8, 2048, 192), 48, torch.bfloat16, False, 0),
    ("nemotron-ragged", (4, 96, 8, 1000, 192), None, torch.bfloat16, True,
     0),
)


def flash_cases(records, dev, flush):
    """Flash attention at the full-sequence runs' shapes (``FLASH_CASES``)
    against the plain version, timed beside its bound and one SDPA call
    (causal, or a boolean mask for a window, lengths or a prefix)."""
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional
    g = torch.Generator().manual_seed(7)
    for tag, (B, H, K, S, hd), window, dtype, ragged, P in FLASH_CASES:
        q = torch.randn(B, H, S, hd, generator=g).to(dev, dtype)
        k = torch.randn(B, K, S, hd, generator=g).to(dev, dtype)
        v = torch.randn(B, K, S, hd, generator=g).to(dev, dtype)
        lengths = (torch.randint(S // 2, S + 1, (B,), generator=g)
                   .to(dev, torch.int32) if ragged else None)
        kern = lambda: ops.flash_attention(q, k, v, window=window,
                                           lengths=lengths, prefix_len=P)
        got = kern()
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                       window=window, lengths=lengths,
                                       prefix_len=P)
        bf16 = dtype == torch.bfloat16
        mode = "bfloat16" if bf16 else "float32"
        label = (f"{tag} flash_attention B={B} H={H} K={K} S={S} hd={hd} "
                 f"{mode} window={window} lengths={ragged} prefix={P}")
        err = check_record(label, got, want, 2e-2 if bf16 else 1e-4, bf16)
        del want
        plain = lambda: ref.flash_attention_ref(q, k, v, window=window,
                                                lengths=lengths,
                                                prefix_len=P)
        valid = flash_valid(S, window, lengths, dev, P)
        pairs = int(valid.sum()) * (B if valid.shape[0] == 1 else 1) * H
        kv_rows = (B * S if lengths is None
                   else int(lengths.clamp_max(S).sum()))
        nbytes = (2 * q.numel() + 2 * kv_rows * K * hd) * q.element_size()
        if window is None and lengths is None and not P:
            lib = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
        else:
            mask = valid[:, None]
            lib = lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)
        rec = time_record(kern, plain, flush, nbytes, 4 * hd * pairs, dtype,
                          err, pairs, lib=lib)
        if not bf16:
            tf32x3_bound(rec)
            log(f"[flash] {tag} float32 window={window} prefix={P}: bound "
                f"{rec['bound_ms']:.4f} ms as 3xTF32 (3 x {rec['ops']} FLOP "
                f"at 495 TFLOP/s), {rec['bound_fma_ms']:.4f} ms as FMA (67 "
                f"TFLOP/s); kernel / SDPA {rec['ms'] / rec['library_ms']:.2f}")
        log_record(f"{tag} flash_attention {mode} window={window} "
                   f"prefix={P}", rec)
        log(f"[flash] {tag} {mode} window={window} lengths={ragged} "
            f"prefix={P}: {rec['ops'] / rec['ms'] / 1e9:.1f} TFLOP/s "
            f"achieved ({rec['ops']} FLOP in {rec['ms']:.4f} ms), library "
            f"{rec['ops'] / rec['library_ms'] / 1e9:.1f} TFLOP/s; bound "
            f"share {rec['bound_ms'] / rec['ms']:.3f}")
        records[("flash_attention", tag, mode, window)] = rec
        del q, k, v, valid
        torch.cuda.empty_cache()


def phase_tuning(dev):
    """The tuning table's entries for this card: the split counts the
    three split walks take instead of the heuristic's at those shapes."""
    from repro_torch.kernels import tuning
    table = tuning.load_table(refresh=True)
    be = tuning.backend_key(dev)
    mine = {(kernel, key): entry["params"]["splits"]
            for kernel, per in table.items()
            for key, entry in per.get(be, {}).items()}
    log(f"[tuning] backend {be}: {len(mine)} entries in "
        f"{Path(tuning.TABLE_PATH).relative_to(ROOT)}"
        + "".join(f"; {kernel} {key} {n} splits"
                  for (kernel, key), n in sorted(mine.items())))


def phase_kernels(dev):
    # (label, activation dtype, int8 pool, tolerance)
    modes = (("float32", torch.float32, False, 1e-4),
             ("bfloat16", torch.bfloat16, False, 2e-2),
             ("int8", torch.float32, True, 1e-4),
             ("int8+bf16", torch.bfloat16, True, 2e-2))
    phase_tuning(dev)
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    flush = flush_buf.zero_
    records = {}
    # reflect_demo_100m: max_seq 2048 / page 16; timed at window None
    demo = dict(B=8, K=4, G=3, hd=64, ps=16, NP=128)
    seed = paged_cases(records, "demo", demo,
                       [("paged_decode", 1), ("paged_extend", 32),
                        ("paged_extend", 5)], modes, (None, 48), None, 128,
                       dev, flush, 0)
    # recurrentgemma-9b's local attention: checked on 160 pages so that
    # the 2048-slot window binds; timed on the serve's 128 pages with the
    # window its rg_attn layers pass
    rg = dict(B=8, K=1, G=16, hd=256, ps=16, NP=128)
    seed = paged_cases(records, "rg", rg, [("paged_decode", 1),
                                           ("paged_extend", 32)],
                       modes[:3], (None, 48, 2048), 2048, 160, dev, flush,
                       seed)
    # granite-moe-1b-a400m (K 8, G 2, hd 64; the serve's table), checked
    # and timed; then the dense archs' hd-128 shapes, checked only:
    # yi-6b (K 4, G 8) and minitron-4b (K 8, G 3)
    serve_cases = [("paged_decode", 1), ("paged_extend", 32),
                   ("paged_extend", 5)]
    granite = dict(B=8, K=8, G=2, hd=64, ps=16, NP=128)
    seed = paged_cases(records, "granite", granite, serve_cases, modes,
                       (None,), None, 128, dev, flush, seed)
    for tag, K, G in (("yi", 4, 8), ("minitron", 8, 3)):
        seed = paged_cases(records, tag, dict(B=8, K=K, G=G, hd=128, ps=16,
                                              NP=128),
                           serve_cases, modes, (None, 48), None, 64, dev,
                           flush, seed, timed=False)
    # nemotron-4-340b (K 8, G 12, hd 192; the serve's table): window 48
    # checked, window None checked and timed at the serve's table
    nemotron = dict(B=8, K=8, G=12, hd=192, ps=16, NP=128)
    seed = paged_cases(records, "nemotron", nemotron, serve_cases, modes,
                       (48,), None, 128, dev, flush, seed)
    scan_cases(records, dev, flush)
    ring_cases(records, dev, flush)
    flash_cases(records, dev, flush)
    bwd_cases(records, dev, flush)
    scan_bwd_cases(records, dev, flush)
    return records


# ---------------------------------------------------------------- 4. serve

def serve(model, kv_dtype, rounds, max_new, seed, path, paged=True,
          aot=False, mesh=None):
    """Serve ``rounds`` reflection rounds of 8 conversations from a paged
    pool or (``paged=False``) ring caches, eagerly or (``aot``) with every
    step captured as a CUDA graph at startup, on a device mesh (``mesh``,
    "DxM") or none; ``path`` names the kernels this model's steps must
    launch.  Returns (engine, conversations, launches, what the run gave:
    streams, bills, step counters, launches, resident KV, ms a step)."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, Status
    scfg = ServeConfig(max_batch=8, max_seq=2048, page_size=16,
                       spec_decode=True, spec_tokens=4, kv_dtype=kv_dtype,
                       paged_kv=paged, aot_warmup=aot, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(model, scfg, device="cuda")
    startup = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    convos = [[1] + rng.integers(3, model.cfg.vocab_size, n).tolist()
              for n in rng.integers(200, 400, 8)]
    torch.cuda.synchronize()
    ops.reset_launches()
    hits, outputs, usage = [], [], []
    t0 = time.perf_counter()
    for _ in range(rounds):
        h0 = eng.prefix_cache.stats["hits"]
        reqs = [Request(prompt=list(c), max_new_tokens=max_new, eos_id=None)
                for c in convos]
        for r in reqs:
            eng.submit(r)
        eng.run()
        if not all(r.status is Status.DONE and len(r.output) == max_new
                   for r in reqs):
            raise AssertionError("a request did not finish")
        hits.append(eng.prefix_cache.stats["hits"] - h0)
        outputs += [list(r.output) for r in reqs]
        usage += [dataclasses.asdict(r.usage) for r in reqs]
        for c, r in zip(convos, reqs):
            c += r.output + [99, 98]              # reflection suffix
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if paged:
        eng.pool.check()
    st = eng.stats()
    peak = torch.cuda.max_memory_allocated()
    steps = {k: st[k] for k in ("mixed_steps", "decode_batch_steps",
                                "verify_steps", "prefill_tokens",
                                "extend_tokens", "decode_tokens",
                                "spec_drafted", "spec_accepted",
                                "preemptions")}
    processed = st["prefill_tokens"] + st["extend_tokens"] + \
        st["decode_tokens"]
    n_steps = sum(st[k] for k in STEP_KINDS)
    name = (f"{model.cfg.name} kv={kv_dtype} {'paged' if paged else 'ring'}"
            f" {'captured' if aot else 'eager'}"
            + (f" mesh {mesh}" if mesh else ""))
    log(f"[serve] {name}: {rounds} rounds x 8 requests in {dt:.3f}s, "
        f"{n_steps} engine steps ({dt / n_steps * 1e3:.2f} ms each); "
        f"{st['decode_tokens'] / dt:.1f} output tok/s, "
        f"{processed / dt:.1f} processed tok/s; steps {steps}")
    kv = (f"pool {st['kv_pool_pages_used']}/{st['kv_pool_pages']} pages"
          if paged else f"rings of {eng._ring_cap} slots, "
          f"{st['resident_kv_bytes']} B")
    log(f"[serve] {name}: prefix hits per round {hits}; launches "
        f"{launches}; peak memory {peak} B (from before the engine was "
        f"built); {kv}; speculation {eng.spec}; startup {startup:.3f}s "
        f"(step capture {st.get('startup_compile_s', 0.0):.3f}s, "
        f"{st.get('aot_warmed', 0)} step shapes); step_compiles "
        f"{st['step_compiles']} {st.get('step_compiles_by_fn', {})}")
    if any(h <= 0 for h in hits[1:]):
        raise AssertionError("reflection rounds missed the prefix cache")
    if min(launches[k] for k in path) <= 0:
        raise AssertionError(f"a kernel of {path} was not launched: "
                             f"{launches}")
    if (st["verify_steps"] > 0) != eng.spec:
        raise AssertionError("speculative verify steps ran iff the engine "
                             f"speculates (spec={eng.spec}, verify steps "
                             f"{st['verify_steps']})")
    if aot and (st["step_compiles"] != 0 or st["aot_warmed"] < 2):
        raise AssertionError(f"a step ran outside the captured shapes: "
                             f"{st['step_compiles_by_fn']}, warmed "
                             f"{st['aot_warmed']}")
    return eng, convos, launches, {
        "outputs": outputs, "usage": usage, "steps": steps,
        "launches": launches, "ms_per_step": dt / n_steps * 1e3,
        "kv": {k: st[k] for k in ("resident_kv_bytes",
                                  "resident_kv_bytes_per_device")}}


def serve_pair(model, kv_dtype, rounds, max_new, seed, path, paged=True,
               profile=None):
    """The same serve eagerly and then with captured steps, on the same
    weights and prompts, each followed (``profile``: new tokens of the
    round) by ``profile_round``.  The captured serve must give the eager
    one's token streams, bills, step counters and kernel launches, with no
    step outside its captured shapes.  Returns both runs' launches."""
    runs = []
    for aot in (False, True):
        eng, convos, launches, got = serve(model, kv_dtype, rounds, max_new,
                                           seed, path, paged, aot)
        if profile:
            profile_round(eng, convos, profile)
        runs.append(got)
        del eng
        release()
    eager, captured = runs
    for key in ("outputs", "usage", "steps", "launches"):
        if captured[key] != eager[key]:
            raise AssertionError(f"the captured serve's {key} differ from "
                                 f"the eager serve's")
    log(f"[serve] {model.cfg.name} kv={kv_dtype} "
        f"{'paged' if paged else 'ring'}: captured = eager in "
        f"{len(eager['outputs'])} token streams, bills, step counters and "
        f"launches")
    return eager["launches"], captured["launches"]


def check_engine(cfg, state, dev, soften, sharpen=None, chaos=False,
                 label=None):
    """The engine on the card, every step captured, against the port's
    engine on the CPU (which the CPU tests hold to the JAX engine): float32
    activations and parameters, q/k scaled by ``soften`` and MoE routers
    by ``sharpen`` as in ``check_logits``, 8 seeded conversations, 2
    reflection rounds; then, on the same engines, the paper's reflection
    loop over 2 SQL tasks: reflect1 with execution feedback, and the
    routed loop
    (``reflect_router``).  Greedy streams and bills must be identical, and
    the loop's responses, per-round bills, decision traces and stop
    reasons; prints the smallest top-1/top-2 logit gap that either engine
    sampled from, and for MoE the smallest gap between the k-th and
    (k+1)-th router probability the CPU engine routed by, so that a
    near-tie can be told from a fault.  With ``chaos``, both engines then
    serve 2 greedy rounds under clones of ``[chaos]``'s hostile plan
    (``fault_run``): streams, stop reasons, bills, decision traces, fault
    counters and the plan's fires must be identical.  ``label`` names the
    weights in the log line (default: the q/k and router scales)."""
    from repro_torch.data.tasks import make_sql_tasks
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import Engine

    class MarginEngine(Engine):
        """Records the smallest top-1/top-2 gap over the rows (verify:
        the valid lanes) of the logits each step returns."""
        margin = float("inf")

        def _run(self, kind, *arrays):
            logits = super()._run(kind, *arrays)
            lg = logits.float()
            if kind == "decode":
                lg = lg[[i for i, r in enumerate(self.slots)
                         if r is not None]]
            else:
                nv = torch.as_tensor(arrays[2], device=lg.device)
                lanes = (nv > 0 if kind == "mixed" else
                         torch.arange(lg.shape[1], device=lg.device)[None]
                         < nv[:, None])
                lg = lg[lanes]
            if lg.numel():
                top = lg.topk(2, dim=-1).values
                self.margin = min(self.margin,
                                  float((top[:, 0] - top[:, 1]).min()))
            return logits

    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    state = scaled(state, soften, sharpen)
    kw = dict(max_batch=8, max_seq=2048, page_size=16, spec_decode=True,
              spec_tokens=4)
    rng = np.random.default_rng(4)
    prompts = [[1] + rng.integers(3, cfg.vocab_size, n).tolist()
               for n in rng.integers(200, 400, 8)]
    tasks = make_sql_tasks(2, seed=0)
    runs = []
    for d, aot in ((torch.device("cpu"), False), (dev, True)):
        m = build_model(cfg32)
        m.load_state_dict(state)
        # routing gaps on the CPU, whose every step runs eagerly
        gaps = router_gaps() if not aot else contextlib.nullcontext([])
        with gaps as seen:
            runs.append(engine_run(MarginEngine, m, kw, aot, d, prompts,
                                   tasks) + (seen,))
        del m
    (c_out, c_use, c_loop, c_gap, c_st, r_gaps), (g_out, g_use, g_loop,
                                                  g_gap, g_st, _) = runs
    if "moe" in cfg.block_pattern and not r_gaps:
        raise AssertionError("no MoE routing was recorded on the CPU")
    same = sum(a == b for a, b in zip(c_out, g_out))
    weights = label or (f"q/k x {soften}" + ("" if sharpen is None
                                             else f", router x {sharpen}"))
    log(f"[check] {cfg.name}, {cfg.num_layers} layers, engine fp32, "
        f"{weights} weights: "
        f"cuda captured vs cpu eager: {same}/{len(c_out)} "
        f"identical token streams, bills identical {c_use == g_use}; "
        f"reflection loop (reflect1/exec and routed, 2 SQL tasks, "
        f"{sum(len(r['rounds']) for r in g_loop)} rounds): responses, "
        f"bills, decision traces and stop reasons identical "
        f"{c_loop == g_loop}, traces "
        f"{[[k[:2] for k in r['trace']] for r in g_loop[2:]]}; "
        f"{g_st['verify_steps']} verify, {g_st['mixed_steps']} mixed and "
        f"{g_st['decode_batch_steps']} decode steps; smallest top-1/top-2 "
        f"logit gap sampled: cpu {c_gap:.3e}, cuda {g_gap:.3e}; "
        + (f"smallest k-th/(k+1)-th router probability gap (cpu) "
           f"{min(r_gaps):.3e}; " if r_gaps else "")
        + f"cuda step_compiles {g_st['step_compiles']}")
    if (c_out != g_out or c_use != g_use or c_loop != g_loop
            or g_st["step_compiles"] != 0):
        raise AssertionError("the engine on the card disagrees with the "
                             "port's engine on the CPU")
    if not chaos:
        return
    recs = []
    for d, aot in ((torch.device("cpu"), False), (dev, True)):
        m = build_model(cfg32)
        m.load_state_dict(state)
        recs.append(fault_run(MarginEngine, m, kw, aot, d, prompts))
        del m
    same = {k: recs[0][k] == recs[1][k] for k in recs[0]}
    log(f"[check] {cfg.name}, {cfg.num_layers} layers, under clones of the "
        f"hostile plan: cuda captured vs cpu eager identical {same}; fires "
        f"{recs[1]['plan']}, stop reasons "
        f"{sorted(set(recs[1]['stops']))}, {recs[1]['steps']}")
    if not all(same.values()):
        raise AssertionError("under one fault plan the engine on the card "
                             "disagrees with the port's engine on the CPU")


def engine_run(engine_cls, m, kw, aot, d, prompts, tasks):
    """``check_engine``'s runs on one engine: 2 token rounds of the
    prompts, then reflect1/exec and the routed loop over ``tasks``.
    Returns (streams, bills, loop records, smallest gap, stats)."""
    import torch_reflection_serving as example
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serving.request import Request
    eng = engine_cls(m, ServeConfig(**kw, aot_warmup=aot), device=d)
    convos = [list(p) for p in prompts]
    outs, usage = [], []
    for _ in range(2):
        reqs = [Request(prompt=list(c), max_new_tokens=16, eos_id=None)
                for c in convos]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs += [list(r.output) for r in reqs]
        usage += [dataclasses.asdict(r.usage) for r in reqs]
        for c, r in zip(convos, reqs):
            c += r.output + [99, 98]
    loop = (reflection_records(example.serve_strategy(eng, 1, "exec", tasks))
            + reflection_records(example.serve_strategy(
                eng, 3, "exec", tasks, router=reflect_router())))
    return outs, usage, loop, eng.margin, eng.stats()


# ------------------------------------------------------------- [reflect]

ROUTER_BOOK = "nova_micro"


def reflect_router():
    """The routed loop's controller: the paper's nova_micro price and
    latency books, the default ``ControllerConfig`` (3 rounds at most).
    In ``[reflect]`` its engine prices SLOs with the same books
    (``slo_price_model``), the engine's backstop to the controller."""
    from repro_torch.core.accounting import CostModel, LatencyModel
    from repro_torch.core.controller import (ControllerConfig,
                                             SweetSpotController)
    return SweetSpotController(CostModel.for_model(ROUTER_BOOK),
                               LatencyModel.for_model(ROUTER_BOOK),
                               ControllerConfig(max_rounds=3))


def reflection_records(served):
    """Each task's rounds (response, ``TokenUsage``, correct), decision
    trace (``Decision.key()``) and stop reason, as plain values."""
    return [{"rounds": [(r.response, dataclasses.asdict(r.usage), r.correct)
                        for r in res.rounds],
             "trace": [d.key() for d in res.trace],
             "stop_reason": res.stop_reason} for res in served.results]


def reflect_strategy(model, dev, rounds, feedback, tasks, aot, router=None,
                     slos=None):
    """One strategy of the reflection loop on a fresh engine, eagerly or
    with captured steps; launch counters are reset after the engine is
    built and read after the strategy.  Fails unless every reflection
    round read the conversation from the cache, a third round's fresh
    input is below its cache reads, and (captured) no step ran outside
    the captured shapes.  Returns (what it served, launches)."""
    import torch_reflection_serving as example
    from repro_torch.configs.base import ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine
    # the routed loop's engine prices SLOs with its router's book: the
    # engine backstop that the loop checks against the controller's
    eng = Engine(model, ServeConfig(
        **example.SERVE, aot_warmup=aot,
        slo_price_model=ROUTER_BOOK if router else None), device=dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    served = example.serve_strategy(eng, rounds, feedback, tasks, router,
                                    slos)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    eng.pool.check()
    st = served.stats
    for t, res in enumerate(served.results):
        for i, r in enumerate(res.rounds):
            u = r.usage
            if i >= 1 and u.cache_read_tokens <= 0:
                raise AssertionError(f"{served.name}: task {t} round {i} "
                                     "read nothing from the cache")
            if i == 3 and not u.input_tokens < u.cache_read_tokens:
                raise AssertionError(f"{served.name}: task {t} round 3 "
                                     f"billed {u}")
    if aot and (st["step_compiles"] != 0 or st["aot_warmed"] < 2):
        raise AssertionError(f"{served.name}: a step ran outside the "
                             f"captured shapes: {st['step_compiles_by_fn']}")
    return served, launches


def phase_reflect(model, dev):
    """The paper's reflection loop on ``model``: the strategy grid of
    ``examples/torch_reflection_serving.py`` (reflect0, reflect1 and
    reflect3 with no feedback or execution feedback, 4 SQL tasks, a fresh
    engine each, 24 new tokens a round) with captured steps, the routed
    loop on the same tasks (the last two under a 0.5 s latency SLO of the
    paper's model), and reflect3/exec again eagerly, which must give the
    captured run's responses, bills, step counters and launches.  Prints
    each strategy's bill, the paper's modeled API latency beside the
    card's wall a round, ms a step, speculation and prefix hits; returns
    the launches of the captured runs and of the eager one."""
    import torch_reflection_serving as example
    from repro_torch.core.accounting import CostModel, LatencyModel
    from repro_torch.core.controller import SLO
    from repro_torch.data.tasks import make_sql_tasks
    tasks = make_sql_tasks(4, seed=0)
    cost = CostModel.for_model("nova_micro")
    lat = LatencyModel.for_model("nova_micro")
    card = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    captured, served = {}, {}
    slos = [None, None, SLO(max_latency_s=0.5), SLO(max_latency_s=0.5)]
    for rounds, fb, router in [(r, f, None) for r, f in example.GRID] + [
            (3, "exec", reflect_router())]:
        s, launches = reflect_strategy(model, dev, rounds, fb, tasks, True,
                                       router, slos if router else None)
        served[s.name] = s, launches
        for k, v in launches.items():
            captured[k] = captured.get(k, 0) + v
        for line in example.report(s, cost, lat, card):
            log(f"[reflect] {line}")
        log(f"[reflect] {s.name}: launches {launches}; step capture "
            f"{s.stats['startup_compile_s']:.3f}s, step_compiles "
            f"{s.stats['step_compiles']}"
            + (f"; engine slo_price_model {ROUTER_BOOK}: "
               f"{s.stats['slo_rejections']} SLO rejections"
               if router else ""))
    for t, res in enumerate(served["routed/exec"][0].results):
        log(f"[reflect] routed task {t} (SLO {slos[t]}): "
            f"{[f'{d.action}:{d.reason}' for d in res.trace]}, stop "
            f"{res.stop_reason}")
    eager, eager_launches = reflect_strategy(model, dev, 3, "exec", tasks,
                                             False)
    twin, twin_launches = served["reflect3/exec"]
    steps = [{k: s.stats[k] for k in STEP_KEYS} for s in (eager, twin)]
    log(f"[reflect] reflect3/exec eager: "
        f"{sum(map(sum, eager.walls)):.3f}s of rounds against captured "
        f"{sum(map(sum, twin.walls)):.3f}s; launches {eager_launches}")
    if (reflection_records(eager) != reflection_records(twin)
            or steps[0] != steps[1] or eager_launches != twin_launches):
        raise AssertionError("the eager reflection loop differs from the "
                             "captured one")
    for name, launches in (("captured", captured), ("eager", eager_launches)):
        if min(launches[k] for k in ("paged_decode", "paged_extend")) <= 0:
            raise AssertionError(f"the {name} reflection loop did not launch "
                                 f"both paged kernels: {launches}")
    log(f"[reflect] captured = eager in {len(eager.results)} tasks' "
        f"responses, bills, step counters and launches; phase "
        f"{time.perf_counter() - t0:.1f}s")
    return {"reflect_demo_100m reflection": eager_launches,
            "reflect_demo_100m reflection captured": captured}


# --------------------------------------------------------------- [chaos]

CHAOS_STOPS = {"max_tokens", "eos", "budget", "timeout", "stalled", "error"}
ENGINE_SITES = ("engine.crash", "engine.latency", "engine.logits",
                "engine.stuck")
HARDENED = dict(enforce_deadlines=True, stall_limit=8, nan_quarantine=True,
                nan_retry_limit=2)


def chaos_plan(rate=True):
    """The ``[chaos]`` fault plan on a virtual clock (0.02 s a step):
    non-finite logits at rate 0.05 (NaN and inf payloads at 0.025 each),
    one stuck row, one crash mid-run and latency spikes of 0.5 s at rate
    0.05; ``rate=False``: every site at rate 0."""
    from repro_torch.serving.faults import FaultPlan, FaultSpec, VirtualClock
    specs = ([FaultSpec("engine.logits", "nan", rate=0.025),
              FaultSpec("engine.logits", "inf", rate=0.025,
                        payload={"value": "inf"}),
              FaultSpec("engine.stuck", "stuck", rate=1.0, start=40,
                        max_fires=1),
              FaultSpec("engine.crash", "crash", rate=1.0, start=70,
                        max_fires=1),
              FaultSpec("engine.latency", "spike", rate=0.05,
                        payload={"delay_s": 0.5})]
             if rate else [FaultSpec(site) for site in ENGINE_SITES])
    return FaultPlan(specs, seed=20, clock=VirtualClock(tick_s=0.02))


def fault_records(eng, reqs, plan):
    """What two runs under clones of one plan must share, as plain
    values: streams, stop reasons, bills, decision traces, the fault
    counters and the plan's fires."""
    return {"outputs": [list(r.output) for r in reqs],
            "stops": [r.stop_reason for r in reqs],
            "usage": [dataclasses.asdict(r.usage) for r in reqs],
            "traces": [list(r.decision_trace) for r in reqs],
            "steps": {k: eng.model_steps[k] for k in (
                "nan_quarantines", "crash_recoveries", "stuck_rows",
                "stalls", "timeouts", "errors", "preemptions",
                "decode_tokens", "mixed_steps", "decode_batch_steps",
                "verify_steps")},
            "plan": None if plan is None else dict(plan.stats)}


def chaos_serve(model, plan, hardened, label, rounds=3, max_new=32):
    """``serve()``'s workload (8 conversations of 200-400 tokens, 3
    reflection rounds, speculation on) on a captured engine under
    ``plan``; ``hardened`` turns on deadlines, the stall detector (8
    steps) and NaN quarantine (2 retries).  Rows 2 and 5 sample at
    temperature 0.7 and rows 0-3 carry a 2.5 s latency SLO.  Launch
    counters are reset just before the serve and read just after.  Fails
    unless every request ends with a stop reason of ``CHAOS_STOPS``, the
    pool checks and no page is left once the cache is released, and both
    paged kernels launched.  Returns (records, launches, wall ms a
    step)."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, Status
    scfg = ServeConfig(max_batch=8, max_seq=2048, page_size=16,
                       spec_decode=True, spec_tokens=4, aot_warmup=True,
                       **(HARDENED if hardened else {}))
    eng = Engine(model, scfg, device="cuda", faults=plan)
    rng = np.random.default_rng(1)
    convos = [[1] + rng.integers(3, model.cfg.vocab_size, n).tolist()
              for n in rng.integers(200, 400, 8)]
    torch.cuda.synchronize()
    ops.reset_launches()
    reqs_all = []
    t0 = time.perf_counter()
    for _ in range(rounds):
        reqs = [Request(prompt=list(c), max_new_tokens=max_new, eos_id=None,
                        temperature=0.7 if i in (2, 5) else 0.0,
                        max_latency_s=2.5 if i < 4 else None)
                for i, c in enumerate(convos)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        for c, r in zip(convos, reqs):
            c += r.output + [99, 98]
        reqs_all += reqs
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    st = eng.stats()
    n_steps = sum(st[k] for k in STEP_KINDS)
    eng.pool.check()
    while eng.prefix_cache.evict_lru():
        pass
    eng.pool.check()
    rec = fault_records(eng, reqs_all, plan)
    stops = {s: rec["stops"].count(s) for s in sorted(set(rec["stops"]))}
    log(f"[chaos] {label}: {len(reqs_all)} requests, {n_steps} engine "
        f"steps in {dt:.3f}s ({dt / n_steps * 1e3:.2f} ms a step); stop "
        f"reasons {stops}; fires {rec['plan']}; {rec['steps']}; pages "
        f"left after the cache is released {eng.pool.used_pages}; "
        f"launches {launches}; step_compiles {st['step_compiles']}")
    if not all(r.status is Status.DONE and r.stop_reason in CHAOS_STOPS
               for r in reqs_all):
        raise AssertionError(f"{label}: a request did not terminate with "
                             f"a known stop reason: {stops}")
    if eng.pool.used_pages != 0 or st["step_compiles"] != 0:
        raise AssertionError(f"{label}: pages leaked or a step ran outside "
                             "the captured shapes")
    if min(launches[k] for k in ("paged_decode", "paged_extend")) <= 0:
        raise AssertionError(f"{label}: a paged kernel was not launched: "
                             f"{launches}")
    return rec, launches, dt / n_steps * 1e3


def phase_chaos(model):
    """``[chaos]``: the full-width demo engine, captured, under the
    hostile plan (``chaos_plan``) with deadlines, the stall detector and
    quarantine, then again on ``plan.clone()`` — identical streams, stop
    reasons, bills, decision traces and fires — then under a rate-0 plan
    and under none, in turns (rate-0, none, none, rate-0): identical
    streams, bills and launches, and two readings of each one's wall a
    step (the reliability layer's host cost).  The serves after the
    hostile ones show that the context survived its hot NaN rows.
    Returns the launches of the hostile, clone, first rate-0 and first
    no-plan serves."""
    t0 = time.perf_counter()
    plan = chaos_plan()
    twin = plan.clone()
    hostile, h_launch, h_ms = chaos_serve(model, plan, True, "hostile plan")
    clone, c_launch, _ = chaos_serve(model, twin, True, "plan.clone()")
    if clone != hostile or c_launch != h_launch:
        raise AssertionError("two engines under clones of one plan differ")
    turns = []
    for rate_0 in (True, False, False, True):
        turns.append((rate_0,) + chaos_serve(
            model, chaos_plan(rate=False) if rate_0 else None, rate_0,
            "rate-0 plan" if rate_0 else "no plan"))
    (_, zero, z_launch, _), (_, none, n_launch, _) = turns[:2]
    for _, rec, launches, _ in turns:
        same = {k: rec[k] == none[k] for k in ("outputs", "stops", "usage")}
        if not all(same.values()) or launches != n_launch:
            raise AssertionError(f"the rate-0 plan differs from no plan: "
                                 f"{same}, launches {launches} / "
                                 f"{n_launch}")
    if hostile["plan"].get("engine.logits", 0) <= 0 or \
            hostile["steps"]["crash_recoveries"] != 1:
        raise AssertionError(f"the hostile plan did not fire as planned: "
                             f"{hostile['plan']}")
    ms = {r: [f"{t[3]:.2f}" for t in turns if t[0] is r]
          for r in (True, False)}
    log(f"[chaos] plan.clone() = hostile plan in {len(hostile['outputs'])} "
        f"streams, stop reasons, bills, decision traces, fires and "
        f"launches; rate-0 plan = no plan in streams, bills and launches; "
        f"the context served on after {hostile['plan']['engine.logits']} "
        f"non-finite logit rows ({hostile['steps']['nan_quarantines']} "
        f"quarantines); wall ms a step: hostile {h_ms:.2f}, rate-0 "
        f"{' / '.join(ms[True])}, no plan {' / '.join(ms[False])} (in "
        f"turns: rate-0, none, none, rate-0); phase "
        f"{time.perf_counter() - t0:.1f}s")
    return {"reflect_demo_100m chaos": h_launch,
            "reflect_demo_100m chaos clone": c_launch,
            "reflect_demo_100m chaos rate-0": z_launch,
            "reflect_demo_100m chaos no plan": n_launch}


def fault_run(engine_cls, m, kw, aot, d, prompts):
    """``check_engine``'s run under a clone of the hostile plan with
    deadlines, the stall detector and quarantine: 2 greedy rounds of the
    prompts, rows 0-3 under a 2.5 s latency SLO.  Returns its records."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serving.request import Request
    plan = chaos_plan()
    eng = engine_cls(m, ServeConfig(**kw, **HARDENED, aot_warmup=aot),
                     device=d, faults=plan)
    convos = [list(p) for p in prompts]
    reqs_all = []
    for _ in range(2):
        reqs = [Request(prompt=list(c), max_new_tokens=16, eos_id=None,
                        max_latency_s=2.5 if i < 4 else None)
                for i, c in enumerate(convos)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        for c, r in zip(convos, reqs):
            c += r.output + [99, 98]
        reqs_all += reqs
    eng.pool.check()
    return fault_records(eng, reqs_all, plan)


# --------------------------------------------------------------- [fleet]

def fleet_trace():
    """The ``[fleet]`` trace: 64 arrivals at a mean 40/s, 6-page group
    prefixes, tokens under 512."""
    from repro_torch.serving.trace import TraceConfig, generate_trace
    return generate_trace(TraceConfig(n_requests=64, seed=3, mean_rate=40.0,
                                      vocab=512, page_size=16))


def fleet_run(model, n, policy, device, label, aot=True, **scfg_kw):
    """A live fleet of ``n`` engines on ``device`` (captured steps when
    ``aot``) behind the router, replaying ``fleet_trace()``.  Fails unless
    all 64 requests complete and no page is left once the caches are
    released.  Returns (report, launches, what it measured)."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.fleet import EngineReplica, Router, RouterConfig
    cuda = device.type == "cuda"
    scfg = ServeConfig(max_batch=8, max_seq=2048, page_size=16,
                       aot_warmup=aot, **scfg_kw)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    replicas = [EngineReplica(i, Engine(model, scfg, device=device))
                for i in range(n)]
    startup = time.perf_counter() - t0
    router = Router(replicas, RouterConfig(policy=policy, page_size=16))
    trace = fleet_trace()
    if cuda:
        torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    report = router.run_trace(trace)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    out_tok = sum(r.engine.model_steps["decode_tokens"] for r in replicas)
    per = [sum(rid == r.rid for _, rid in report.assignments)
           for r in replicas]
    leaked = router.shutdown_check()
    got = {"startup_s": startup, "wall_s": wall,
           "out_tok_s": out_tok / wall,
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    if cuda:
        log(f"[fleet] {label}: {report.summary()}; wall {wall:.3f}s, "
            f"{out_tok} output tokens ({got['out_tok_s']:.1f} tok/s); "
            f"assignments per replica {per}; startup {startup:.3f}s; peak "
            f"memory {got['peak_bytes']} B (from before the replicas were "
            f"built); paged launches {launches}; leaked pages {leaked}")
    if len(report.completions) != len(trace) or leaked != 0:
        raise AssertionError(f"{label}: {len(report.completions)} of "
                             f"{len(trace)} completions, {leaked} pages "
                             "leaked")
    if cuda and min(launches[k] for k in ("paged_decode",
                                          "paged_extend")) <= 0:
        raise AssertionError(f"{label}: a paged kernel was not launched: "
                             f"{launches}")
    return report, launches, got


def phase_fleet(model, dev):
    """``[fleet]``: live fleets of captured full-width demo replicas on
    the one card (pumped in turn on one stream: routing, affinity and
    TTFT under queueing, not parallel replicas): 2 and 4 replicas under
    ``affinity`` and ``round_robin``, then 4 under ``affinity`` with
    deadlines and SLO pricing.  Returns their launches."""
    t0 = time.perf_counter()
    runs = {}
    for n, policy, kw in ((2, "affinity", {}), (2, "round_robin", {}),
                          (4, "affinity", {}), (4, "round_robin", {}),
                          (4, "affinity", dict(enforce_deadlines=True,
                                               slo_price_model=ROUTER_BOOK))):
        label = f"{n} replicas {policy}" + (" deadlines + SLO pricing"
                                            if kw else "")
        _, launches, _ = fleet_run(model, n, policy, dev, label, **kw)
        runs[f"reflect_demo_100m fleet {label}"] = launches
        release()
    log(f"[fleet] TTFT is stamped on the host after the step whose ids "
        f"were read back, so it includes that step's device work; phase "
        f"{time.perf_counter() - t0:.1f}s")
    return runs


def check_fleet(cfg, state, dev, soften):
    """The same trace through a 2-replica affinity fleet of the first
    layers (float32, q/k scaled by ``soften``) on the card, captured, and
    on the CPU: identical assignments, and completions apart from their
    times."""
    from repro_torch.models.registry import build_model
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    state = scaled(state, soften)
    out = []
    for d, aot in ((torch.device("cpu"), False), (dev, True)):
        m = build_model(cfg32)
        m.load_state_dict(state)
        report, _, got = fleet_run(m.to(d), 2, "affinity", d,
                                   f"{cfg.num_layers} layers on {d.type}",
                                   aot=aot)
        out.append((report.assignments,
                    [{k: v for k, v in c.items()
                      if k not in ("ttft_s", "latency_s")}
                     for c in report.completions], got["wall_s"]))
        del m
    (c_assign, c_comp, c_wall), (g_assign, g_comp, g_wall) = out
    log(f"[check] {cfg.name}, {cfg.num_layers} layers, fleet of 2 "
        f"(affinity, {len(c_comp)} requests): cuda captured vs cpu eager: "
        f"assignments identical {c_assign == g_assign}, completions apart "
        f"from their times identical {c_comp == g_comp}; wall cpu "
        f"{c_wall:.3f}s, cuda {g_wall:.3f}s")
    if c_assign != g_assign or c_comp != g_comp:
        raise AssertionError("the fleet on the card disagrees with the "
                             "fleet on the CPU")


def profile_round(eng, convos, max_new=16):
    """Device time by kernel over one more short round, then the idle
    share.  The profiler's own tracing slows every launch on this card's
    host many times over, so the wall time it is set against is that of
    the same round served again without the profiler (the second pass
    finds one more token of each prompt cached).  A captured engine's
    round is then split into graph span and host time (``replay_split``),
    after which the engine must serve no more."""
    from repro_torch.serving.request import Request
    from torch.profiler import ProfilerActivity, profile

    def one_round():
        """Serve the round; returns (engine steps by kind, wall seconds)."""
        before = eng.stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in convos:
            eng.submit(Request(prompt=list(c), max_new_tokens=max_new,
                               eos_id=None))
        eng.run()
        torch.cuda.synchronize()
        after = eng.stats()
        return ({k: after[k] - before[k] for k in STEP_KINDS},
                time.perf_counter() - t0)

    mode = "captured" if eng.stats().get("aot_warmed") else "eager"
    # an eager MoE round also records operators (and each moe_ffn call as
    # a range), so that its device time can be split by operator
    moe = "moe" in eng.cfg.block_pattern and mode == "eager"
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if moe else [])
    with profile(activities=acts) as prof, (
            moe_spans() if moe else contextlib.nullcontext()):
        steps, traced_s = one_round()
    kinds, wall_s = one_round()
    steps, steps2 = sum(steps.values()), sum(kinds.values())

    # kernel rows only: CPU-side operator rows repeat their kernels' time
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.key != MOE_SPAN), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in rows)
    busy_ms, wall_ms = busy / steps / 1e3, wall_s / steps2 * 1e3
    log(f"[profile] {eng.cfg.name} {mode}: {len(convos)} requests x "
        f"{max_new} new tokens: {len(rows)} kernel rows, {steps} engine "
        f"steps, device busy {busy:.0f} us ({busy_ms:.3f} ms per step; "
        f"{traced_s:.3f} s wall under the profiler); again without the "
        f"profiler: {steps2} steps in {wall_s:.3f} s ({wall_ms:.3f} ms per "
        f"step); idle share {1 - busy_ms / wall_ms:.3f}"
        + ("; the profiler lists a replayed graph's kernels under their own "
           "names, as in eager runs" if mode == "captured" else ""))
    # the top 15, then the port's own kernels (the split walks' combine
    # among them) that are not in it
    # (a kernel that is not a template is named without its "void")
    port = re.compile(
        r"(void )?(\(anonymous namespace\)|paged|flash_tc)::\w+_kernel")
    for i, e in enumerate(rows):
        if dev_us(e) > 0 and (i < 15 or port.match(e.key)):
            log(f"[profile] {dev_us(e):10.0f} us {e.count:6d} calls  "
                f"{e.key[:90]}")
    if busy <= 0:
        log("[profile] the profiler saw no device time; kernel times come "
            "from the CUDA events of the kernels phase")
    if "moe" in eng.cfg.block_pattern:
        moe_share(prof, rows, busy, f"{eng.cfg.name} {mode}", spans=moe)
    if mode == "captured":
        replay_split(eng, kinds, wall_s)


def dev_us(e):
    """A profiler row's or event's device time, microseconds (named
    ``cuda_time_total`` by older PyTorch)."""
    t = getattr(e, "device_time_total", None)
    return t if t is not None else getattr(e, "cuda_time_total", 0.0)


MOE_SPAN = "moe_ffn"


@contextlib.contextmanager
def moe_spans():
    """Run every ``moe_ffn`` call inside a profiler range named
    ``MOE_SPAN``: the profiler then gives the range the device time of the
    operators it ran (eager steps; a replayed graph has no operators)."""
    from repro_torch.models import moe
    ffn = moe.moe_ffn

    def spanned(*a, **kw):
        with torch.profiler.record_function(MOE_SPAN):
            return ffn(*a, **kw)

    moe.moe_ffn = spanned
    try:
        yield
    finally:
        moe.moe_ffn = ffn


def _moe_part(name):
    """The MoE phase an operator or kernel name belongs to, or None."""
    n = name.lower()
    if "bmm" in n:
        return "expert bmm"
    if "sort" in n:
        return "sort"
    if any(w in n for w in ("index", "scatter", "gather", "repeat_inter")):
        return "gather/scatter"
    return None


def moe_share(prof, rows, busy, label, spans):
    """The MoE FFN's share of a profiled round's device time.  Eager
    (``spans``: the round ran under ``moe_spans``): the ``MOE_SPAN``
    ranges' device time, split by the operators they ran (expert ``bmm``,
    the routing sorts, the dispatch and combine's gathers and scatters,
    the rest: router product, softmax, elementwise); a round that recorded
    no such range fails.  Captured: kernel rows only, so the sort and
    gather/scatter kernel rows by name (the K/V writes' and page-table
    gathers' among them); the expert products are cuBLAS kernels that
    share their names with the dense projections'."""
    if busy <= 0:
        return
    if spans:
        if not any(e.key == MOE_SPAN for e in prof.key_averages()):
            raise AssertionError(f"{label}: the round recorded no "
                                 f"{MOE_SPAN!r} range: moe_ffn was not "
                                 "called through repro_torch.models.moe")
        parts, total = {}, 0.0
        for e in prof.events():
            if e.name != MOE_SPAN or e.device_type != \
                    torch.autograd.DeviceType.CPU:
                continue
            total += dev_us(e)
            for ch in e.cpu_children:
                part = _moe_part(ch.name) or "other"
                parts[part] = parts.get(part, 0.0) + dev_us(ch)
        log(f"[profile] {label}: MoE FFN {total:.0f} us of {busy:.0f} us "
            f"device time, share {total / busy:.3f}; "
            + ", ".join(f"{k} {v:.0f} us ({v / busy:.3f})"
                        for k, v in sorted(parts.items())))
        return
    parts = {}
    for e in rows:
        part = _moe_part(e.key)
        if part in ("sort", "gather/scatter"):
            parts[part] = parts.get(part, 0.0) + dev_us(e)
    log(f"[profile] {label}: kernel rows by name, of {busy:.0f} us: "
        + ", ".join(f"{k} {v:.0f} us ({v / busy:.3f})"
                    for k, v in sorted(parts.items()))
        + "; the expert products' share is the eager round's")


def replay_split(eng, kinds, wall_s):
    """Split a captured round's wall time into the graphs' device span and
    the host's share: each captured step shape replayed alone, 10 times
    back to back (CUDA events), its span (kernels and the gaps between
    them) weighted by the round's steps of that kind (``kinds``, mixed
    steps at the widest bucket).  The replays write into the cache with
    the last step's inputs: the engine must serve no more after this."""
    span = {}
    for kind, step in eng._steps.items():
        for shapes, sig in step._sigs.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            sig.graph.replay()
            start.record()
            for _ in range(10):
                sig.graph.replay()
            end.record()
            torch.cuda.synchronize()
            span[kind, shapes[0][1]] = start.elapsed_time(end) / 10
    widest = {k: max(w for kk, w in span if kk == k) for k, _ in span}
    dev_ms = sum(kinds[STEP_COUNTERS[k]] * span[k, w]
                 for k, w in widest.items())
    steps = sum(kinds.values())
    log(f"[profile] {eng.cfg.name} captured: one replay alone "
        + ", ".join(f"{k} [{eng.scfg.max_batch}, {w}] {ms:.3f} ms"
                    for (k, w), ms in sorted(span.items()))
        + f"; the round's {steps} steps: graph span {dev_ms / steps:.3f} ms"
        f" a step, host {(wall_s * 1e3 - dev_ms) / steps:.3f} ms a step "
        f"(wall {wall_s * 1e3 / steps:.3f})")


def full_sequence(model, B, S, lengths, steps, forward, path, extra=None):
    """The full-sequence entry points: ``prefill`` of B seeded prompts
    padded to S (valid up to ``lengths``), ``steps`` greedy
    ``decode_step``s on the primed rings, then (``forward``) teacher
    forcing on all [B, S] tokens.  ``extra`` holds the model's other
    inputs, passed to ``prefill`` and in ``forward``'s batch: whisper's
    ``frames`` [B, F, d] (its encoder runs the flash kernel in the prefix
    mode, P = F) or the VLM's ``patch_embeds`` [B, P, d] (a prefix of P
    before the tokens, so decoding starts at P + lengths and the rings
    hold P + S slots).  Every kernel of ``path`` must launch; flash once
    per attention (or MoE) layer, encoder layers included, and call, ring
    decode once per such decoder layer and step.  With MoE blocks,
    ``forward``'s aux loss must be finite and positive.  Returns the
    launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import KV_KINDS
    cfg = model.cfg
    dev = model.embed.device
    extra = extra or {}
    n_attn = sum(k in KV_KINDS for k in cfg.block_pattern)
    n_flash = n_attn + (cfg.encoder_layers if "frames" in extra else 0)
    P = extra["patch_embeds"].shape[1] if "patch_embeds" in extra else 0
    g = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(3, cfg.vocab_size, (B, S), generator=g,
                           device=dev)
    lens = (torch.full((B,), S) if lengths is None
            else torch.tensor(lengths)).to(dev, torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, cache = model.prefill(tokens, lens, max_seq=P + S, **extra)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    outs = [logits]
    nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
    pos = lens + P
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = model.decode_step(cache, nxt, pos)
        outs.append(logits)
        nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
        pos += 1
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    t_fwd = aux = None
    if forward:
        t0 = time.perf_counter()
        lf, aux = model.forward({"tokens": tokens, **extra})
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        if lf.shape != (B, S, cfg.vocab_size) or not bool(
                torch.isfinite(lf).all()):
            raise AssertionError("forward logits are not finite [B, S, V]")
        aux = float(aux)
        if "moe" in cfg.block_pattern and not (np.isfinite(aux)
                                               and aux > 0):
            raise AssertionError(f"forward's MoE aux loss is {aux}")
        del lf
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    rings = sorted({c["k"].shape[1] for c in cache if "tok" in c})
    if not all(o.shape == (B, cfg.vocab_size) and bool(torch.isfinite(o)
                                                       .all()) for o in outs):
        raise AssertionError("prefill / decode logits are not finite [B, V]")
    log(f"[full] {cfg.name}: prefill [{B}, {S}] (lengths "
        f"{lens.min().item()}-{lens.max().item()}"
        + "".join(f"; {k} {list(v.shape)}" for k, v in extra.items())
        + f") {t_prefill:.3f}s; "
        f"{steps} decode steps {t_decode / steps * 1e3:.2f} ms each; "
        f"forward {'not run' if t_fwd is None else f'{t_fwd:.3f}s'} (aux "
        f"loss {aux}); rings of {rings} slots; launches {launches}; peak "
        f"memory {peak} B")
    want_flash = n_flash * (1 + bool(forward))
    if launches["flash_attention"] != want_flash:
        raise AssertionError(f"flash launched {launches['flash_attention']} "
                             f"times, not {want_flash}")
    if launches["decode_attention"] != n_attn * steps:
        raise AssertionError("ring decode did not launch once per layer "
                             "and step")
    if min(launches[k] for k in path) <= 0:
        raise AssertionError(f"a kernel of {path} was not launched: "
                             f"{launches}")
    return launches


def _walk(m, prompt, feed):
    """Logits [5, V] of a 45-token prompt prefilled in two chunks (32 +
    13 valid lanes of 32) and four decode steps fed ``feed``, or the
    model's own greedy tokens (appended to ``feed``) when it is empty."""
    d = m.embed.device
    own = not feed
    pt = torch.arange(8, dtype=torch.int32, device=d)[None]
    cache = m.init_cache_paged(8, 16, device=d)
    i32 = dict(dtype=torch.int32, device=d)
    for p0 in (0, 32):
        chunk = prompt[:, p0:p0 + 32]
        blk = torch.zeros(1, 32, dtype=torch.int32)
        blk[:, :chunk.shape[1]] = chunk
        lg, cache = m.prefill_extend(
            cache, blk.to(d), torch.tensor([p0], **i32),
            torch.tensor([chunk.shape[1]], **i32), page_table=pt)
    logits = [lg.float().cpu()]
    for i in range(4):
        if own:
            feed.append(int(logits[-1].argmax()))
        lg, cache = m.decode_step(cache, torch.tensor([[feed[i]]], **i32),
                                  torch.tensor([45 + i], **i32),
                                  page_table=pt)
        logits.append(lg.float().cpu())
    return torch.cat(logits)


def _walk_prefill(m, prompt, feed, patches=None):
    """Logits [5, V] of the same walk as ``_walk`` through the
    full-sequence entry points: ``prefill`` of the 45-token prompt (its
    length passed as ``lengths``; after the VLM's ``patches`` [1, P, d],
    a bidirectional prefix, when given), then four ring ``decode_step``s
    fed ``feed``, or the model's own greedy tokens (appended to
    ``feed``)."""
    d = m.embed.device
    own = not feed
    i32 = dict(dtype=torch.int32, device=d)
    P = 0 if patches is None else patches.shape[1]
    kw = {} if patches is None else {"patch_embeds": patches.to(d)}
    lg, cache = m.prefill(prompt.to(d), torch.tensor([45], **i32),
                          max_seq=64 + P, **kw)
    logits = [lg.float().cpu()]
    for i in range(4):
        if own:
            feed.append(int(logits[-1].argmax()))
        lg, cache = m.decode_step(cache, torch.tensor([[feed[i]]], **i32),
                                  torch.tensor([45 + P + i], **i32))
        logits.append(lg.float().cpu())
    return torch.cat(logits)


def scaled(state, soften=None, sharpen=None):
    """``state`` with the q/k projections scaled by ``soften`` and MoE
    routers by ``sharpen`` (None: unchanged)."""
    def factor(k):
        if soften is not None and k.endswith((".wq", ".wk")):
            return soften
        if sharpen is not None and k.endswith(".router"):
            return sharpen
        return 1.0
    # unscaled tensors are shared, not copied: at nemotron-4-340b's width
    # a copy of the state would not fit the host beside the CPU's model
    return {k: v if factor(k) == 1.0 else v * factor(k)
            for k, v in state.items()}


def host_memory():
    """(total, available) bytes of the host's memory (``/proc/meminfo``)."""
    info = dict(line.split(":", 1) for line in
                Path("/proc/meminfo").read_text().splitlines())
    return tuple(int(info[k].split()[0]) * 1024
                 for k in ("MemTotal", "MemAvailable"))


@contextlib.contextmanager
def router_gaps():
    """Yield a list that gets, for every MoE routing made while active
    (outside a CUDA graph capture), the smallest gap between the k-th and
    (k+1)-th router probability of the lanes it routed: how near a tie
    the top-k was."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    route = moe.route
    gaps = []

    def recording(cfg, p, x3, valid3=None):
        out = route(cfg, p, x3, valid3)
        if not (x3.is_cuda and torch.cuda.is_current_stream_capturing()):
            k = cfg.experts_per_token
            probs = torch.softmax((x3 @ L.cast(p.router, x3.dtype)).float(),
                                  dim=-1)
            top = probs.topk(k + 1, dim=-1).values
            gap = top[..., k - 1] - top[..., k]
            if valid3 is not None:
                gap = gap[valid3]
            if gap.numel():
                gaps.append(float(gap.min()))
        return out

    moe.route = recording
    try:
        yield gaps
    finally:
        moe.route = route


def check_logits(cfg, state, dev, soften=None, sharpen=None, patches=None):
    """The model's entry points on the card against the plain path on the
    CPU, on a small input (chunked paged prefill, and full-sequence
    ``prefill``, each followed by greedy decode steps fed the CPU's
    tokens), at full width; ``state`` is a state dict on either device.
    With ``patches`` (the VLM's [1, P, d] patch embeddings) the
    full-sequence walk runs them as its prefix, and the chunked paged walk
    serves the text decoder alone, as the engine does.

    The seeded weights follow the reference's init recipe, whose q/k
    projections (normal over fan_in = H for wq [d, H, hd]) make attention
    nearly one-hot: a 1e-6 relative change of the weights then moves the
    logits by O(1), so no two implementations could agree.  The check
    prints that sensitivity on the card, for the served weights and, for
    a model with attention, for the weights with wq and wk scaled by
    ``soften`` (scores O(1)), and compares implementations on the scaled
    ones.  An MoE router's init (scale 0.1) leaves the gaps between the
    k-th and (k+1)-th expert small, so that a flipped expert is a near tie,
    not a fault: ``sharpen`` scales the routers too, and the smallest such
    gap the walks saw is printed.  Each model is built once on each device
    and dtype and walks both paths (each walk makes its own cache)."""
    from repro_torch.models.registry import build_model
    # float32 activations and parameters (bf16-stored weights upcast
    # exactly), so that a 1e-6 change of the weights is not rounded away
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    g = torch.Generator().manual_seed(7)
    prompt = torch.randint(3, cfg.vocab_size, (1, 45), generator=g)
    noise = torch.Generator(device=dev).manual_seed(7)
    variants = [("served", state)]
    if soften is not None or sharpen is not None:
        state = scaled(state, soften, sharpen)
        variants.append((", ".join(
            f"{w} x {f}" for w, f in (("q/k", soften), ("router", sharpen))
            if f is not None), state))
    label = variants[-1][0]

    def load(c, st, d):
        with torch.device(d):
            m = build_model(c)
        m.load_state_dict(st)
        return m

    t0 = time.perf_counter()
    feeds = {}
    for name, st in variants:
        a = load(cfg32, st, dev)
        feed = []
        out_a = _walk(a, prompt, feed)
        # the same weights x (1 + 1e-6 noise), perturbed in place (a second
        # fp32 copy does not fit the card beside the first at nemotron's
        # width): the bits a noisy copy of ``st`` loaded anew would give
        with torch.no_grad():
            params = a.state_dict()
            for k, v in st.items():
                r = torch.randn(v.shape, generator=noise, device=dev)
                params[k].mul_(r.mul_(1e-6).add_(1.0))
                del r
        out_b = _walk(a, prompt, feed)
        del a, params
        release()
        log(f"[check] {cfg.name}: sensitivity, {name} weights, cuda fp32: "
            f"a 1e-6 relative weight change moves logits by "
            f"{float((out_a - out_b).abs().max()):.3e} (logit scale "
            f"{float(out_a.abs().max()):.3f})")
    walks = (("chunked paged prefill + paged decode", _walk),
             ("prefill" + (" with the patches" if patches is not None
                           else "") + " + ring decode",
              lambda m, p, f: _walk_prefill(m, p, f, patches)))
    outs = {}
    total, avail = host_memory()
    n_params = sum(v.numel() for v in state.values())
    log(f"[check] {cfg.name}: host memory {total} B, {avail} B available, "
        f"before the CPU's fp32 model of {n_params} parameters "
        f"({4 * n_params} B)")
    with router_gaps() as gaps:              # fp32: bf16 logits tie often
        t_cpu = time.perf_counter()
        m = load(cfg32, state, torch.device("cpu"))
        for path, walk in walks:
            feeds[path] = []
            outs[path] = [walk(m, prompt, feeds[path])]
        del m
        t_cpu = time.perf_counter() - t_cpu
        m = load(cfg32, state, dev)
        for path, walk in walks:
            outs[path].append(walk(m, prompt, feeds[path]))
        del m
    release()
    m = load(cfg, state, dev)
    for path, walk in walks:
        outs[path].append(walk(m, prompt, feeds[path]))
    del m
    release()
    if "moe" in cfg.block_pattern and not gaps:
        raise AssertionError("no MoE routing was recorded")
    for path, (ref, out32, out16) in outs.items():
        if not all(torch.isfinite(v).all() for v in (ref, out32, out16)):
            raise AssertionError("non-finite logits")
        err32 = float((out32 - ref).abs().max())
        err16 = float((out16 - ref).abs().max())
        cos = float(torch.nn.functional.cosine_similarity(out16, ref,
                                                          dim=-1).min())
        log(f"[check] {cfg.name}, {cfg.num_layers} layers, {path}, logits "
            f"[{ref.shape[0]}, {ref.shape[-1]}], {label} weights: cuda fp32 "
            f"vs cpu fp32 max abs err {err32:.3e} (tol 1e-3); cuda "
            f"{cfg.dtype} vs cpu fp32 max abs err {err16:.3e} (tol 0.1), "
            f"min cosine {cos:.6f} (tol 0.999)"
            + (f"; smallest k-th/(k+1)-th router probability gap (fp32) "
               f"{min(gaps):.3e}" if gaps else ""))
        if err32 > 1e-3 or err16 > 0.1 or cos < 0.999:
            raise AssertionError("logits on the card disagree with the CPU")
    log(f"[check] {cfg.name}: {time.perf_counter() - t0:.1f}s, of which the "
        f"CPU's model and walks {t_cpu:.1f}s")
    return t_cpu


def build_on_card(cfg, seed):
    """The model with seeded random weights, made on the card."""
    from repro_torch.models.registry import build_model
    with torch.device("cuda"):
        model = build_model(cfg)
    model.init(torch.Generator(device="cuda").manual_seed(seed))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers "
        f"({' '.join(sorted(set(cfg.block_pattern)))}), d_model "
        f"{cfg.d_model}, {n_params} parameters ({cfg.param_dtype}), "
        f"activations {cfg.dtype}")
    return model


def cut(cfg, n_layers):
    """``cfg`` at full width and the first ``n_layers`` of its pattern."""
    return cfg.replace(num_layers=n_layers,
                       block_pattern=cfg.block_pattern[:n_layers])


def first_layers(state, n_layers):
    """A state dict without the blocks past the first ``n_layers``."""
    return {k: v for k, v in state.items() if not k.startswith("blocks.")
            or int(k.split(".")[1]) < n_layers}


def release():
    """Return the freed models' memory to the card before the next one."""
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def timed(label):
    """Log the seconds the block took."""
    t0 = time.perf_counter()
    yield
    log(f"[time] {label}: {time.perf_counter() - t0:.1f}s")


def phase_granite(dev):
    """granite-moe-1b-a400m at full width and depth: MoE blocks (32
    experts top-8) over the paged kernels at K 8 / G 2, eager and
    captured; then the full-sequence entry points, whose rows of 2048
    tokens are routed one group per row; then the checks against the CPU
    on the first 2 layers, q/k softened and the routers sharpened.
    Returns the launch counts of its runs."""
    from repro_torch.models.registry import get_config
    runs = {}
    cfg = get_config("granite_moe_1b_a400m")
    with timed("granite serves"):
        model = build_on_card(cfg, 0)
        runs["granite_moe_1b_a400m"], runs["granite_moe_1b_a400m captured"] \
            = serve_pair(model, "model", 3, 32, 3,
                         ("paged_decode", "paged_extend"), profile=4)
    with timed("granite full-sequence"):
        runs["granite_moe_1b_a400m full-sequence"] = full_sequence(
            model, B=8, S=2048,
            lengths=np.linspace(1500, 2048, 8).astype(int), steps=16,
            forward=True, path=("flash_attention", "decode_attention"))
    state = {k: v.cpu()
             for k, v in first_layers(model.state_dict(), 2).items()}
    del model
    release()
    with timed("granite logits check"):
        check_logits(cut(cfg, 2), state, dev, soften=0.125, sharpen=8.0)
    with timed("granite engine check"):
        # one layer (an MoE block): the CPU engine's side of two took a
        # minute of the script's limit
        check_engine(cut(cfg, 1), first_layers(state, 1), dev, 0.125,
                     sharpen=8.0)
    del state
    release()
    return runs


def phase_serve(dev):
    """Each model's runs; returns the launch counts read just after each
    run of a kernel's path.  Every serve runs eagerly and then with its
    steps captured as CUDA graphs (``serve_pair``)."""
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model, get_config
    runs = {}
    paged = ("paged_decode", "paged_extend")
    ring = ("decode_attention",)
    t0 = time.perf_counter()
    cfg = get_config("reflect_demo_100m")
    model = build_on_card(cfg, 0)
    for kv, rounds, max_new, seed, profile in (("model", 3, 64, 1, 16),
                                               ("int8", 2, 32, 2, None)):
        for is_paged, path, tag in ((True, paged, ""), (False, ring,
                                                         " ring")):
            key = "reflect_demo_100m" + tag + ("" if kv == "model"
                                               else " int8")
            runs[key], runs[key + " captured"] = serve_pair(
                model, kv, rounds, max_new, seed, path, is_paged, profile)
    runs["reflect_demo_100m full-sequence"] = full_sequence(
        model, B=8, S=2048, lengths=np.linspace(1500, 2048, 8).astype(int),
        steps=16, forward=True, path=("flash_attention", "decode_attention"))
    runs.update(phase_reflect(model, dev))
    with timed("chaos"):
        runs.update(phase_chaos(model))
    with timed("fleet"):
        runs.update(phase_fleet(model, dev))
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    check_logits(cfg, state, dev, soften=0.125)
    del model
    release()
    with timed("demo engine check"):
        check_engine(cut(cfg, 2), first_layers(state, 2), dev, 0.125,
                     chaos=True)
    with timed("demo fleet check"):
        check_fleet(cut(cfg, 2), first_layers(state, 2), dev, 0.125)
    del state
    release()
    log(f"[time] reflect_demo_100m: {time.perf_counter() - t0:.1f}s")

    runs.update(phase_granite(dev))
    t0 = time.perf_counter()

    # the recurrent families at full width and depth, one at a time; the
    # logits check at a cut depth (one unit of the pattern), whose weights
    # are made on the CPU
    for arch, path, n_cut, soften in (
            ("falcon_mamba_7b", ("mamba_scan",), 2, None),
            ("recurrentgemma_9b", ("rglru_scan", "paged_extend",
                                   "paged_decode"), 3, 1 / 32)):
        cfg = get_config(arch)
        with timed(f"{arch} serves"):
            model = build_on_card(cfg, 0)
            runs[arch], runs[arch + " captured"] = serve_pair(
                model, "model", 3, 32, 3, path, profile=8)
        if arch == "recurrentgemma_9b":
            with timed(f"{arch} ring serves"):
                runs[arch + " ring"], runs[arch + " ring captured"] = \
                    serve_pair(model, "model", 3, 32, 3,
                               ("rglru_scan", "decode_attention"),
                               paged=False, profile=8)
            with timed(f"{arch} full-sequence"):
                runs[arch + " full-sequence"] = full_sequence(
                    model, B=4, S=4096, lengths=None, steps=16,
                    forward=False, path=("flash_attention",
                                         "decode_attention", "rglru_scan"))
        del model
        release()
        with timed(f"{arch} logits check"):
            small = build_model(cut(cfg, n_cut)).init(
                torch.Generator().manual_seed(0))
            check_logits(small.cfg, small.state_dict(), dev, soften)
            del small
        log(f"[time] {arch}: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
    ops.reset_launches()
    return runs


def phase_mesh(dev):
    """``[mesh]``: full-width reflect_demo_100m served by ``Engine(mesh=
    "1x1")`` — parameters and the page pools as DTensors on a one-rank
    NCCL mesh (launch/mesh.py), the attention reads inside ``local_map`` —
    paged, int8 KV off and on, speculation on, eagerly and captured, each
    beside the same engine without a mesh; the streams, bills, step
    counters and launches must agree, both paged kernels must launch
    under the mesh and its per-device resident KV must equal the whole.
    The step times side by side give what DTensor dispatch adds to the
    host's time a step.  A 1x2 mesh on the card must raise
    ``NotImplementedError``.  Returns the meshed runs' launches."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.launch.mesh import HBM_BYTES
    from repro_torch.models.registry import get_config
    from repro_torch.serving.engine import Engine
    total = torch.cuda.get_device_properties(dev).total_memory
    log(f"[mesh] {torch.cuda.get_device_name(dev)} total_memory {total} B; "
        f"launch/mesh.py HBM_BYTES {HBM_BYTES} "
        f"({'equal' if total == HBM_BYTES else 'NOT equal'})")
    paged = ("paged_decode", "paged_extend")
    cfg = get_config("reflect_demo_100m")
    model = build_on_card(cfg, 0)
    runs, ms = {}, {}
    # captured in both KV dtypes; eager (the host's dispatch cost) in fp
    for kv, seed, aot in (("model", 5, True), ("int8", 6, True),
                          ("model", 5, False)):
        got = {}
        for mesh in (None, "1x1", "1x1", None):
            eng, _, launches, run = serve(model, kv, 2, 32, seed, paged,
                                          True, aot, mesh)
            del eng
            release()
            if mesh in got and run["outputs"] != got[mesh]["outputs"]:
                raise AssertionError("[mesh] a repeated serve differs")
            got[mesh] = run
            ms.setdefault((kv, aot, mesh), []).append(
                run["ms_per_step"])
        base, meshed = got[None], got["1x1"]
        for key in ("outputs", "usage", "steps", "launches"):
            if meshed[key] != base[key]:
                raise AssertionError(f"[mesh] kv={kv} aot={aot}: the "
                                     f"1x1 mesh's {key} differ")
        if (meshed["kv"]["resident_kv_bytes_per_device"]
                != meshed["kv"]["resident_kv_bytes"]):
            raise AssertionError(f"[mesh] per-device resident KV "
                                 f"{meshed['kv']}")
        tag = ("reflect_demo_100m mesh 1x1" + ("" if kv == "model"
                                               else " int8")
               + (" captured" if aot else ""))
        runs[tag] = meshed["launches"]
        log(f"[mesh] kv={kv} {'captured' if aot else 'eager'}: 1x1 "
            f"mesh = no mesh in {len(base['outputs'])} token streams, "
            f"bills, step counters and launches {meshed['launches']}; "
            f"resident KV {meshed['kv']}")
    for (kv, aot, mesh), t in sorted(ms.items(), key=str):
        log(f"[mesh] ms a step kv={kv} {'captured' if aot else 'eager'} "
            f"mesh={mesh}: {t}")
    for kv, aot in (("model", True), ("int8", True), ("model", False)):
        d = (sum(ms[(kv, aot, "1x1")]) - sum(ms[(kv, aot, None)])) / 2
        log(f"[mesh] DTensor dispatch adds {d:.3f} ms a step "
            f"(kv={kv}, {'captured' if aot else 'eager'})")
    try:
        Engine(model, ServeConfig(mesh="1x2"), device="cuda")
    except NotImplementedError as e:
        log(f"[mesh] 1x2 on the card raises NotImplementedError: {e}")
    else:
        raise AssertionError("[mesh] a 1x2 mesh on the card did not raise")
    del model
    release()
    return runs


def phase_whisper(dev, smi):
    """whisper-tiny at full width and depth (4 encoder and 4 decoder
    layers, d_model 384, 1500 frames, vocab 51,865; bf16 activations, fp32
    parameters): ``[full]`` ``prefill`` of [8, 448] tokens after seeded
    frames [8, 1500, 384] (the encoder through flash attention in the
    prefix mode, P = 1500), 16 ring ``decode_step``s (cross-attention over
    the primed cross K/V) and ``forward``; ``[serve]`` on rings (whisper
    has no paged layout and no verify step, so no speculation, as in the
    reference), eagerly and captured, rounds 2 and 3 hitting the prefix
    cache (its cross K/V, zeros as the engine never passes frames, ride in
    the slot snapshots); ``[train]`` 20 AdamW steps of 8 x 256 with
    seeded random frames, and one float32 step of the whole model on the
    card against the CPU.  Returns the launch counts of its runs."""
    from repro_torch.models.registry import get_config
    runs = {}
    cfg = get_config("whisper_tiny")
    model = build_on_card(cfg, 0)
    frames = torch.randn(8, cfg.encoder_seq, cfg.d_model, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             9)).to(torch.bfloat16)
    with timed("whisper full-sequence"):
        runs["whisper_tiny full-sequence"] = full_sequence(
            model, B=8, S=448, lengths=np.linspace(300, 448, 8).astype(int),
            steps=16, forward=True,
            path=("flash_attention", "decode_attention"),
            extra={"frames": frames})
    with timed("whisper serves"):
        runs["whisper_tiny ring"], runs["whisper_tiny ring captured"] = \
            serve_pair(model, "model", 3, 32, 4, ("decode_attention",),
                       paged=False, profile=8)
    del model, frames
    release()
    with timed("whisper train card vs cpu"):
        # 1500 frames through 8 layers of random-init attention, near
        # one-hot: q/k softened, as the logits checks do
        runs["whisper_tiny train fp32 card"] = train_card_vs_cpu(
            cfg, batch=2, n_layers=None,
            launches_each=cfg.num_layers + cfg.encoder_layers, soften=0.125)
    with timed("whisper train full width"):
        runs["whisper_tiny train"] = train_full_width(
            "whisper_tiny", None, {"attn": "flash_attention"}, dev, smi)
    return runs


def phase_internvl2(dev):
    """internvl2-76b's language backbone at full width (d_model 8192, 64 q
    and 8 KV heads, hd 128, d_ff 28672, vocab 128,256; bf16 parameters)
    cut to 8 of its 80 layers (17.9 GB of weights; 80 would not fit one
    card): ``[full]`` ``prefill`` of [4, 1792] tokens after 256 seeded
    patch embeddings (S 2048; flash attention in the prefix mode, P 256),
    16 ``decode_step``s from position 256 + length, and a no-grad
    ``forward`` with the patches; a paged serve of the text decoder (the
    engine passes no patches, as the reference's), eagerly and captured,
    8 conversations, 2 rounds of 32; then ``check_logits`` at 2 layers of
    full width, the full-sequence walk with 256 patches: card against the
    CPU.  Returns the launch counts of its runs."""
    from repro_torch.models.registry import get_config
    runs = {}
    full = get_config("internvl2_76b")
    cfg = cut(full, 8)
    model = build_on_card(cfg, 0)
    g = torch.Generator(device=dev).manual_seed(10)
    patches = torch.randn(4, cfg.num_patches, cfg.d_model, device=dev,
                          generator=g).to(torch.bfloat16)
    with timed("internvl2 full-sequence"):
        runs["internvl2_76b full-sequence"] = full_sequence(
            model, B=4, S=1792,
            lengths=np.linspace(1500, 1792, 4).astype(int), steps=16,
            forward=True, path=("flash_attention", "decode_attention"),
            extra={"patch_embeds": patches})
    with timed("internvl2 serves"):
        runs["internvl2_76b"], runs["internvl2_76b captured"] = serve_pair(
            model, "model", 2, 32, 5, ("paged_decode", "paged_extend"),
            profile=8)
    state = {k: v.cpu()
             for k, v in first_layers(model.state_dict(), 2).items()}
    del model, patches
    release()
    with timed("internvl2 logits check"):
        one = torch.randn(1, cfg.num_patches, cfg.d_model,
                          generator=torch.Generator().manual_seed(11))
        check_logits(cut(full, 2), state, dev, soften=1 / 16, patches=one)
    del state
    release()
    return runs


def phase_nemotron(dev):
    """nemotron-4-340b at full width (d_model 18432, 96 q and 8 KV heads,
    hd 192, d_ff 73,728 with squared ReLU, an untied vocab of 256,000;
    bf16 parameters) cut to its first 4 of 96 layers (23.25 B parameters,
    46.5 GB; 96 layers are 681 GB): ``[full]`` ``prefill`` of [4, 2048]
    with ragged lengths, 16 ``decode_step``s and a no-grad ``forward``
    (flash attention and ring decode at hd 192); a paged serve with
    speculation, eagerly and captured, 8 conversations, 2 rounds of 32
    (paged decode and extend); then ``check_logits`` at 1 layer of full
    width (12.9 B parameters, 51.6 GB in fp32; its sensitivity step
    perturbs the model in place), card against the CPU, q/k x 1/16.
    Returns the launch counts of its runs."""
    from repro_torch.models.registry import get_config
    runs = {}
    full = get_config("nemotron_4_340b")
    model = build_on_card(cut(full, 4), 0)
    with timed("nemotron full-sequence"):
        runs["nemotron_4_340b full-sequence"] = full_sequence(
            model, B=4, S=2048,
            lengths=np.linspace(1500, 2048, 4).astype(int), steps=16,
            forward=True, path=("flash_attention", "decode_attention"))
    with timed("nemotron serves"):
        runs["nemotron_4_340b"], runs["nemotron_4_340b captured"] = \
            serve_pair(model, "model", 2, 32, 6,
                       ("paged_decode", "paged_extend"), profile=8)
    state = {k: v.cpu()
             for k, v in first_layers(model.state_dict(), 1).items()}
    del model
    release()
    with timed("nemotron logits check"):
        check_logits(cut(full, 1), state, dev, soften=1 / 16)
    del state
    release()
    return runs


# ---------------------------------------------------------------- [train]

# (tag, (B, H, K, S, hd), window, dtypes, lengths, timed, prefix): the
# training shape of examples/torch_train_100m.py (reflect_demo_100m, 8 x
# 256), recurrentgemma-9b's local attention (hd 256, window 2048) at S
# 4096, a ragged batch with an empty row, hd 32 / 128 checked only, and the
# prefix mode at whisper's encoder in training (8 x 1500 frames, P = S)
# and at internvl2-76b's patches (S 2048, P 256)
BWD_CASES = (
    ("demo", (8, 12, 4, 256, 64), None, (torch.bfloat16, torch.float32),
     None, True, 0),
    ("rg", (1, 16, 1, 4096, 256), 2048, (torch.bfloat16, torch.float32),
     None, True, 0),
    ("ragged", (8, 12, 4, 1000, 64), None, (torch.bfloat16,),
     (0, 1000, 517, 1, 999, 64, 700, 333), True, 0),
    ("hd32", (2, 8, 2, 300, 32), 100, (torch.float32, torch.bfloat16),
     (300, 77), False, 0),
    ("hd128", (2, 8, 4, 300, 128), 100, (torch.float32, torch.bfloat16),
     (300, 77), False, 0),
    ("whisper", (8, 6, 6, 1500, 64), None, (torch.bfloat16, torch.float32),
     None, True, 1500),
    ("internvl2", (1, 64, 8, 2048, 128), None, (torch.bfloat16,), None,
     True, 256),
)


def bwd_cases(records, dev, flush):
    """The flash backward kernel against ``flash_attention_bwd_ref`` on the
    same inputs (q, k, v, the forward kernel's output, a seeded output
    gradient), tolerance 1e-4 (float32) or 2e-2 (bfloat16) of the largest
    gradient magnitude; timed cases beside their bound (the five backward
    products, 10 * hd FLOP a valid (query, key) pair, and q/k/v/o/do read
    once and dq/dk/dv written once) and SDPA's backward (autograd of one
    ``scaled_dot_product_attention`` call, the forward excluded) as the
    library yardstick.  Both dtypes take the lse of a forward launch made
    outside the timed call, as the autograd function keeps it; float32 is
    bounded as 3xTF32 products (``tf32x3_bound``)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    F = torch.nn.functional
    g = torch.Generator().manual_seed(11)
    for tag, (B, H, K, S, hd), window, dtypes, lengths, timed, P in \
            BWD_CASES:
        for dtype in dtypes:
            mk = lambda *s: torch.randn(*s, generator=g).to(dev, dtype)
            q, k, v = mk(B, H, S, hd), mk(B, K, S, hd), mk(B, K, S, hd)
            do = mk(B, H, S, hd)
            ln = (None if lengths is None else
                  torch.tensor(lengths, dtype=torch.int32, device=dev))
            o, lse = FA._launch(q, k, v, window, ln, with_lse=True,
                                prefix_len=P)
            kern = lambda: flash_attention_bwd(q, k, v, o, do, lse=lse,
                                               window=window, lengths=ln,
                                               prefix_len=P)
            got = kern()
            again = kern()
            torch.cuda.synchronize()
            want = ref.flash_attention_bwd_ref(
                q.float(), k.float(), v.float(), o.float(), do.float(),
                window=window, lengths=ln, prefix_len=P)
            bf16 = dtype == torch.bfloat16
            mode = "bfloat16" if bf16 else "float32"
            tol = 2e-2 if bf16 else 1e-4
            errs = []
            for name, x, w, y in zip(("dq", "dk", "dv"), got, want, again):
                scale = float(w.abs().max())
                err = float((x.float() - w).abs().max())
                ok = (bool(torch.isfinite(x).all()) and err <= tol *
                      max(scale, 1.0) and torch.equal(x, y))
                errs.append(err)
                log(f"[kernels] {tag} flash_attention_bwd B={B} H={H} K={K} "
                    f"S={S} hd={hd} {mode} window={window} lengths="
                    f"{lengths is not None} prefix={P} {name}: "
                    f"max_abs_err={err:.3e} "
                    f"(tol {tol} x max(|grad|, 1) = {tol * max(scale, 1):.3e})"
                    f"; same bits on a second call {torch.equal(x, y)} "
                    f"{'ok' if ok else 'MISMATCH'}")
                if not ok:
                    raise AssertionError(f"{tag} flash backward {name} "
                                         "disagrees with its plain version")
            if ln is not None and 0 in lengths:
                b = lengths.index(0)
                if any(bool(x[b].any()) for x in got):
                    raise AssertionError("an empty row got a gradient")
            del want, got, again
            if not timed:
                continue
            plain = lambda: ref.flash_attention_bwd_ref(
                q, k, v, o, do, window=window, lengths=ln, prefix_len=P)
            valid = flash_valid(S, window, ln, dev, P)
            pairs = int(valid.sum()) * (B if valid.shape[0] == 1 else 1) * H
            kv_rows = B * S if ln is None else int(ln.clamp_max(S).sum())
            nbytes = (4 * q.numel() + 2 * kv_rows * K * hd
                      + 2 * k.numel()) * q.element_size()
            qa, ka, va = (t.detach().requires_grad_(True) for t in (q, k, v))
            if window is None and ln is None and not P:
                out = F.scaled_dot_product_attention(qa, ka, va,
                                                     is_causal=True,
                                                     enable_gqa=True)
            else:
                out = F.scaled_dot_product_attention(
                    qa, ka, va, attn_mask=valid[:, None], enable_gqa=True)
            lib = lambda: torch.autograd.grad(out, (qa, ka, va), do,
                                              retain_graph=True)
            rec = time_record(kern, plain, flush, nbytes, 10 * hd * pairs,
                              dtype, max(errs), pairs, lib=lib)
            if not bf16:
                tf32x3_bound(rec)
                log(f"[kernels] {tag} flash_attention_bwd float32: bound "
                    f"{rec['bound_ms']:.4f} ms as 3xTF32 of the five "
                    f"products ({1.4 * rec['bound_ms']:.4f} ms for the "
                    f"seven this design does), {rec['bound_fma_ms']:.4f} ms "
                    f"as FMA; kernel / SDPA backward "
                    f"{rec['ms'] / rec['library_ms']:.2f}")
            log_record(f"{tag} flash_attention_bwd {mode} window={window} "
                       f"prefix={P}", rec)
            # one cold-L2 call between two events also holds the wrapper's
            # host enqueue, which at the demo shape exceeds the device
            # work: the profiler's time is the kernels' own
            us = device_us_by_kernel(kern)
            rec["device_us"] = sum(us.values())
            log(f"[kernels] {tag} flash_attention_bwd {mode}: device us a "
                f"call (profiler, warm L2, mean of 5) " + ", ".join(
                    f"{n} {x:.1f}" for n, x in us.items())
                + f"; total {sum(us.values()):.1f} us against "
                f"{1e3 * rec['ms']:.1f} us between events (cold L2) and "
                f"{1e3 * rec['warm_ms']:.1f} us (warm L2)")
            log(f"[kernels] {tag} flash_attention_bwd {mode}: "
                f"{rec['ops'] / rec['ms'] / 1e9:.1f} TFLOP/s achieved "
                f"({rec['ops']} FLOP in {rec['ms']:.4f} ms), SDPA backward "
                f"{rec['ops'] / rec['library_ms'] / 1e9:.1f} TFLOP/s; bound "
                f"share {rec['bound_ms'] / rec['ms']:.3f}")
            records[("flash_attention_bwd", tag, mode)] = rec
            if tag == "demo" and bf16:
                lse_forward_ms(q, k, v, flush)
            del q, k, v, o, do, qa, ka, va, out, valid, lse
            torch.cuda.empty_cache()


def scan_bwd_cases(records, dev, flush):
    """The two scans' backward kernels at the training shapes of the
    ``[train]`` runs against their written-out plain versions on the same
    inputs (a nonzero h0, random output gradients on both outputs, pad
    lanes as in ``scan_cases``): mamba at falcon-mamba-7b's [8, 256, 8192]
    N 16 with bf16 x (timed) and float32 x, 1e-4 absolute plus 1e-4 of
    each gradient's largest magnitude (``ex2.approx``); the RG-LRU at
    recurrentgemma-9b's [8, 256, 4096], bit for bit; both the same bits on
    a second call.  The mamba backward starts from the tile states that
    one forward launch keeps (as ``_MambaScan`` runs them); with bf16 x
    (the training runs' dtype) its device time by kernel is printed, and
    the forward at the same shape is timed with and without keeping those
    states, in turns.  Bounds: the bytes each
    input is read and each output written once; mamba also one
    exponential a (b, t, d, n) over the SFU rate and 12 float32 operations
    each."""
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import ref
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd
    g = torch.Generator(device=dev).manual_seed(12)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    B, S, D, N, W = 8, 256, 8192, 16, 4096
    nv = torch.tensor([S] + [S - 16 * b - 3 for b in range(1, B)],
                      device=dev)
    pad = torch.arange(S, device=dev)[None, :] < nv[:, None]
    dt = torch.nn.functional.softplus(rn(B, S, D) - 4.0) * pad[..., None]
    Bm, Cm, x32 = rn(B, S, N), rn(B, S, N), rn(B, S, D)
    A = -torch.exp(0.5 * rn(D, N))
    Dsk, h0, dy, dh = rn(D), rn(B, D, N), rn(B, S, D), rn(B, D, N)
    names = ("d_dt", "dBm", "dCm", "dx", "dA", "dDsk", "dh0")
    for mode, x in (("bfloat16", x32.bfloat16()), ("float32", x32)):
        fwd = (dt, Bm, Cm, x, A, Dsk, h0)
        states = MS._launch(*fwd, keep_states=True)[2]
        kern = lambda: MS.mamba_scan_bwd(*fwd, dy, dh, states=states)
        plain = lambda: ref.mamba_scan_bwd_ref(*fwd, dy, dh)
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        errs = []
        for name, a, b, w in zip(names, got, again, want):
            scale = float(w.float().abs().max())
            err = float((a.float() - w.float()).abs().max())
            # dx in bf16: the kernel and the plain version each round once
            tol = 1e-4 + 1e-4 * scale + (2 ** -8 * scale if a.dtype ==
                                          torch.bfloat16 else 0.0)
            ok = (bool(torch.isfinite(a).all()) and err <= tol
                  and torch.equal(a, b))
            errs.append(err)
            log(f"[kernels] mamba_scan_bwd [{B},{S},{D}] N={N} x {mode} "
                f"{name}: max_abs_err={err:.3e} (tol {tol:.3e}; largest "
                f"{scale:.3e}); same bits on a second call "
                f"{torch.equal(a, b)} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"mamba_scan_bwd {name} x {mode} "
                                     "disagrees with its plain version")
        del got, again, want
        nbytes = ((dt.numel() * 3 + 2 * Bm.numel() * 2 + A.numel() * 2
                   + Dsk.numel() * 2 + h0.numel() * 3) * 4
                  + x.numel() * x.element_size() * 2)
        exps = B * S * D * N
        rec = time_record(kern, plain, flush, nbytes, 12 * exps,
                          torch.float32, max(errs), exps)
        log_record(f"mamba_scan_bwd train x {mode}", rec)
        records[("mamba_scan_bwd", "train", mode)] = rec
        if mode == "bfloat16":
            log(f"[kernels] mamba_scan_bwd train x {mode}: device us a call "
                f"by kernel (profiler, warm L2): "
                + ", ".join(f"{k} {v:.1f}" for k, v in
                            device_us_by_kernel(kern).items()))
            (ms, lo, hi), (bare, blo, bhi) = interleaved_ms(
                lambda: MS._launch(*fwd, keep_states=True),
                lambda: MS._launch(*fwd), flush)
            log(f"[kernels] mamba_scan [{B},{S},{D}] N={N} x {mode}: keeping "
                f"the tile states median {ms:.4f} ms (range {lo:.4f}-"
                f"{hi:.4f}), without {bare:.4f} ms (range {blo:.4f}-"
                f"{bhi:.4f}), in turns, cold-L2")
        del states
    del dt, Bm, Cm, x32, A, Dsk, h0, dy, dh, fwd
    a = torch.sigmoid(rn(B, S, W))
    b = rn(B, S, W)
    a.masked_fill_(~pad[..., None], 1.0)
    b.masked_fill_(~pad[..., None], 0.0)
    h0 = rn(B, W)
    hs, _ = ref.rglru_scan_ref(a, b, h0)
    dhs, dh = rn(B, S, W), rn(B, W)
    kern = lambda: rglru_scan_bwd(a, hs, h0, dhs, dh)
    plain = lambda: ref.rglru_scan_bwd_ref(a, hs, h0, dhs, dh)
    got, again, want = kern(), kern(), plain()
    torch.cuda.synchronize()
    err = max(float((x - w).abs().max()) for x, w in zip(got, want))
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    log(f"[kernels] rglru_scan_bwd [{B},{S},{W}]: max_abs_err={err:.3e} "
        f"(tol 0: the kernel rounds as the plain version does); same bits "
        f"on a second call {same} {'ok' if err == 0 and same else 'MISMATCH'}")
    if err != 0 or not same or not all(bool(torch.isfinite(x).all())
                                       for x in got):
        raise AssertionError("rglru_scan_bwd disagrees with its plain "
                             "version")
    del got, again, want
    rec = time_record(kern, plain, flush,
                      (5 * a.numel() + 3 * h0.numel()) * 4,
                      3 * a.numel(), torch.float32, err)
    log_record("rglru_scan_bwd train", rec)
    records[("rglru_scan_bwd", "train", "float32")] = rec
    del a, b, h0, hs, dhs, dh
    torch.cuda.empty_cache()


def lse_forward_ms(q, k, v, flush):
    """The bf16 forward launch with its lse output (as the autograd
    function makes it) against the bare launch (serving, no grad), in
    turns, cold-L2."""
    from repro_torch.kernels import flash_attention as FA
    (ms, lo, hi), (bare, blo, bhi) = interleaved_ms(
        lambda: FA._launch(q, k, v, None, None, with_lse=True),
        lambda: FA._launch(q, k, v, None, None), flush)
    log(f"[kernels] demo flash_attention bfloat16 B={q.shape[0]} "
        f"H={q.shape[1]} S={q.shape[2]} hd={q.shape[3]}: with lse median "
        f"{ms:.4f} ms (range {lo:.4f}-{hi:.4f}), without {bare:.4f} ms "
        f"(range {blo:.4f}-{bhi:.4f}), in turns, cold-L2")


def train_card_vs_cpu(cfg, batch=8, kernels=("flash_attention",
                                               "flash_attention_bwd"),
                      n_layers=2, launches_each=2, soften=None):
    """One float32 loss and gradient of the full-width cut to
    ``n_layers`` layers (None: the whole model) on the card and on the
    CPU, on one seeded weight set (q/k scaled by ``soften``, as
    ``check_logits`` does, where random-init attention is near one-hot)
    and one batch of ``batch`` x 256 of the task corpus (with seeded
    frames [batch, F, d] for whisper): loss within 1e-4 relative, every
    gradient tensor's cosine with the CPU's at least 0.9999.  The card's
    run must launch each of ``kernels`` (the forward and the backward
    kernel of the model's attention or scan) ``launches_each`` times:
    once a layer.  Returns the card's launches."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.lm_data import lm_batches
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import (grads_of, make_loss_fn, params_of,
                                        to_device, trainable)
    cfg32 = (cfg if n_layers is None else cut(cfg, n_layers)).replace(
        dtype="float32", param_dtype="float32")
    tcfg = TrainConfig(remat=False)
    data = dict(next(lm_batches(256, batch, 1)))
    if cfg.arch_type == "audio":
        data["frames"] = torch.randn(
            batch, cfg.encoder_seq, cfg.d_model,
            generator=torch.Generator().manual_seed(4))
    # the weights are drawn on the card (a host draw of a 256K-vocab cut
    # took most of this check), each device's model loads them, and the
    # cosines are taken on the card in float64
    with torch.device("cuda"):
        state = scaled(build_model(cfg32).init(
            torch.Generator(device="cuda").manual_seed(3)).state_dict(),
            soften)
    out = []
    for d in (torch.device("cpu"), torch.device("cuda")):
        with torch.device(d):
            m = build_model(cfg32)
        m.load_state_dict(state)
        ops.reset_launches()
        with trainable(m):
            loss, metrics = make_loss_fn(m, cfg32, tcfg)(to_device(data, d))
            grads = grads_of(loss, params_of(m))
        launches = dict(ops.LAUNCHES)
        out.append((float(loss.detach()), {k: v.detach().cuda()
                                           for k, v in grads.items()},
                    launches))
        del m, grads, loss
    del state
    (c_loss, c_g, _), (g_loss, g_g, launches) = out
    cos = {}
    for k in c_g:
        a, b = c_g[k].double(), g_g[k].double()
        cos[k] = float((a * b).sum() / (a.norm() * b.norm()).clamp_min(
            1e-300))
    del c_g, g_g
    worst = min(cos, key=cos.get)
    rel = abs(g_loss - c_loss) / abs(c_loss)
    depth = ("all" if n_layers is None else n_layers)
    log(f"[train] {cfg.name}, {depth} layers fp32"
        + ("" if soften is None else f" (q/k x {soften})")
        + f", one batch of {batch} x 256: "
        f"loss cpu {c_loss:.7f} cuda {g_loss:.7f} (relative {rel:.2e}, tol "
        f"1e-4); smallest gradient cosine {cos[worst]:.7f} ({worst}, tol "
        f"0.9999) over {len(cos)} tensors; cuda launches {launches}")
    if rel > 1e-4 or cos[worst] < 0.9999:
        raise AssertionError(f"the {cfg.name} train step on the card "
                             "disagrees with the CPU")
    if any(launches[k] != launches_each for k in kernels):
        raise AssertionError(f"the {depth}-layer step did not launch "
                             f"{kernels} once a layer: {launches}")
    release()
    return launches


class _KernelForwardPlainBackward(torch.autograd.Function):
    """The flash forward kernel with ``ref.flash_attention_bwd_ref`` as
    its backward."""

    @staticmethod
    def forward(ctx, q, k, v, window, lengths, prefix_len):
        from repro_torch.kernels import flash_attention as FA
        out, _ = FA._launch(q, k, v, window, lengths, prefix_len=prefix_len)
        ctx.save_for_backward(q, k, v, out, lengths)
        ctx.window, ctx.prefix_len = window, prefix_len
        return out

    @staticmethod
    def backward(ctx, do):
        from repro_torch.kernels import ref
        q, k, v, out, lengths = ctx.saved_tensors
        return (*ref.flash_attention_bwd_ref(
            q, k, v, out, do, window=ctx.window, lengths=lengths,
            prefix_len=ctx.prefix_len), None, None, None)


# Stand-ins for ops.flash_attention, with its signature
def kernel_forward_plain_backward(q, k, v, window=None, lengths=None,
                                  prefix_len=0):
    return _KernelForwardPlainBackward.apply(q, k, v, window, lengths,
                                             prefix_len)


def plain_attention(q, k, v, window=None, lengths=None, prefix_len=0):
    """Autograd of the flash kernels' plain version."""
    from repro_torch.kernels import ref
    return ref.flash_attention_ref(q, k, v, window=window, lengths=lengths,
                                   prefix_len=prefix_len)


def plain_bf16_p(q, k, v, window=None, lengths=None, prefix_len=0):
    """Plain attention in float32 under autograd whose P V product takes
    P as the bf16 forward kernel does (``flash_tc::softmax_tile``): p =
    exp(s - the row's max) rounded to bf16 (its gradient passed through),
    divided after the product by the row's sum of the unrounded p.  The
    kernel's running max makes its roundings differ in detail, not in
    size; an empty row gives zeros."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    valid = flash_valid(S, window, lengths, q.device, prefix_len)[
        :, None, None]
    s = torch.einsum("bkgid,bkjd->bkgij",
                     q.float().reshape(B, K, H // K, S, hd),
                     k.float()) * hd ** -0.5
    s = s.masked_fill(~valid, -torch.inf)
    m = s.amax(-1, keepdim=True).detach()
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    o = torch.einsum("bkgij,bkjd->bkgid", p.to(torch.bfloat16).float(),
                     v.float()) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(B, H, S, hd).to(q.dtype)


def train_bf16_kernels_vs_plain(cfg, dev):
    """One bfloat16 loss and gradient of the 2-layer full-width cut on the
    card, one batch, through the flash kernels (the forward with lse, the
    tensor-core backward) and through three plain counterparts: the
    forward kernel with the plain backward, autograd of the plain version
    (``ref.flash_attention_ref`` on CUDA tensors), and that with P
    rounded to bf16 before P V, as the forward kernel rounds it
    (``plain_bf16_p``).  Gated, every gradient tensor's cosine at least
    0.999: on the reference's random init, whose attention is near
    one-hot, the kernels against the kernel forward with the plain
    backward (the backward kernel's own bf16 P and dS); with q/k softened
    by 0.125, as ``check_logits`` does, the kernels against plain
    attention.  Also gated on the raw init: the forward kernel's output
    at the first layer's own q, k, v against the plain version (2e-2 of
    max(|out|, 1)).  Printed: on the raw init the kernels and the bf16-P
    witness against plain attention, the two gaps the forward's bf16 P
    makes there (PERF.md)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.lm_data import lm_batches
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention as A
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import (grads_of, make_loss_fn, params_of,
                                        to_device, trainable)

    cfg2 = cut(cfg, 2)
    tcfg = TrainConfig(remat=False)
    batch = next(lm_batches(256, 8, 1))
    init = build_model(cfg2).init(torch.Generator().manual_seed(3)) \
        .state_dict()
    kern = A.ops.flash_attention
    first = []  # the first layer's q, k, v on the raw init

    def kernels(q, k, v, window=None, lengths=None, prefix_len=0):
        if not first:
            first.append((q.detach().clone(), k.detach().clone(),
                          v.detach().clone(), window, lengths))
        return kern(q, k, v, window=window, lengths=lengths,
                    prefix_len=prefix_len)

    ways = {"kernels": kernels,
            "kernel forward, plain backward": kernel_forward_plain_backward,
            "plain": plain_attention,
            "plain, bf16 P": plain_bf16_p}

    def step(state, way):
        A.ops.flash_attention = ways[way]
        try:
            m = build_model(cfg2)
            m.load_state_dict(state)
            m.to(dev)
            ops.reset_launches()
            with trainable(m):
                loss, _ = make_loss_fn(m, cfg2, tcfg)(to_device(batch, dev))
                grads = grads_of(loss, params_of(m))
            out = (float(loss.detach()), {k: g.detach().double().cpu()
                                          for k, g in grads.items()},
                   dict(ops.LAUNCHES))
            del m, grads, loss
            return out
        finally:
            A.ops.flash_attention = kern

    def worst(a, b):
        cos = {k: float((a[1][k] * b[1][k]).sum() / (a[1][k].norm()
                        * b[1][k].norm()).clamp_min(1e-300)) for k in a[1]}
        k = min(cos, key=cos.get)
        return cos[k], k

    soft = scaled(init, soften=0.125)
    runs = {("init", w): step(init, w) for w in ways}
    runs.update({("softened", w): step(soft, w)
                 for w in ("kernels", "plain")})
    checks = []
    for s, way, other, gated in (
            ("init", "kernels", "kernel forward, plain backward", True),
            ("softened", "kernels", "plain", True),
            ("init", "kernels", "plain", False),
            ("init", "plain, bf16 P", "plain", False),
            ("init", "kernels", "plain, bf16 P", False)):
        a, b = runs[(s, way)], runs[(s, other)]
        cos, leaf = worst(a, b)
        log(f"[train] {cfg.name}, 2 layers bf16, one batch of 8 x 256 on "
            f"the card, {s} weights: {way} against {other}: loss "
            f"{a[0]:.6f} / {b[0]:.6f} (relative "
            f"{abs(a[0] - b[0]) / abs(b[0]):.2e}); smallest gradient "
            f"cosine {cos:.6f} ({leaf}"
            f"{', tol 0.999' if gated else ', not gated'}) over "
            f"{len(a[1])} tensors")
        if gated:
            checks.append(cos >= 0.999)
    q, k, v, window, lengths = first[0]
    with torch.no_grad():
        got = FA._launch(q, k, v, window, lengths)[0].float()
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                       window=window, lengths=lengths)
        witness = plain_bf16_p(q.float(), k.float(), v.float(), window,
                               lengths)
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    checks.append(bool(torch.isfinite(got).all()) and err <= 2e-2 * scale)
    log(f"[train] the forward kernel at the first layer's q, k, v "
        f"{list(q.shape)} on the raw init: max_abs_err {err:.3e} against "
        f"the plain version (tol 2e-2 x max(|out|, 1) = {2e-2 * scale:.3e}),"
        f" {float((got - witness).abs().max()):.3e} against it with bf16 "
        f"P; the bf16-P witness against the plain version "
        f"{float((witness - want).abs().max()):.3e}")
    launches = runs[("init", "kernels")][2]
    log(f"[train] bf16 2-layer step launches: kernels {launches}, kernel "
        f"forward / plain backward "
        f"{runs[('init', 'kernel forward, plain backward')][2]}")
    if not all(checks):
        raise AssertionError("the bf16 step through the kernels disagrees "
                             "with its plain counterpart on the card")
    if launches["flash_attention"] != 2 or \
            launches["flash_attention_bwd"] != 2 or \
            runs[("init", "plain")][2]["flash_attention_bwd"] != 0:
        raise AssertionError("the bf16 2-layer step did not launch the "
                             f"flash kernels once a layer: {launches}")
    release()


def fitted_reflect_serve(cfg, dev):
    """Speculation on fitted weights: the 2-layer full-width cut (float32)
    fitted by ``quick_fit_reflect`` on the card, then the reflection
    pattern it was fitted on: round 1 answers 8 ramp questions, round 2
    quotes the answer and restates the question (``prompt + answer + [2]
    + prompt``, the answer as the speculation context), served with
    speculation off and on: the streams must agree and drafts must be
    accepted."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request
    from repro_torch.train.quick_fit import quick_fit_reflect
    from repro_torch.launch.train import build
    cfg32 = cut(cfg, 2).replace(dtype="float32", param_dtype="float32")
    model = build(cfg32, dev, seed=0)
    t0 = time.perf_counter()
    quick_fit_reflect(model, steps=400)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    kw = dict(max_batch=8, max_seq=256, page_size=16, spec_tokens=6)
    prompts = [[1] + list(range(10 + 55 * i, 25 + 55 * i)) for i in range(8)]

    def serve_round(spec, reqs):
        eng = Engine(model, ServeConfig(spec_decode=spec, **kw), device=dev)
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [list(r.output) for r in reqs], eng.stats()

    answers, _ = serve_round(False, [Request(prompt=list(p),
                                             max_new_tokens=32, eos_id=None)
                                     for p in prompts])
    got = {}
    for spec in (False, True):
        reqs = [Request(prompt=p + a + [2] + p, max_new_tokens=28,
                        eos_id=None, spec_context=list(a))
                for p, a in zip(prompts, answers)]
        got[spec] = serve_round(spec, reqs)
    st = got[True][1]
    same = sum(a == b for a, b in zip(got[False][0], got[True][0]))
    redone = sum(o == a[:28] for o, a in zip(got[True][0], answers))
    log(f"[train] {cfg.name}, 2 layers fp32, quick_fit_reflect 400 steps "
        f"on the card in {t_fit:.2f}s; round 2 with speculation: drafted "
        f"{st['spec_drafted']}, accepted {st['spec_accepted']} "
        f"({st['spec_accepted'] / max(st['spec_drafted'], 1):.3f}), "
        f"{st['verify_steps']} verify steps; streams as without speculation "
        f"{same}/8; round 2 re-derives round 1's answer {redone}/8")
    if same != 8 or st["spec_accepted"] <= 0:
        raise AssertionError("speculation on fitted weights accepted no "
                             "draft or changed the streams")
    del model
    release()


# (arch, layers of the full-width cut, {block kind: its kernel}): the
# recurrent families' training runs
RECURRENT_TRAIN = (
    ("falcon_mamba_7b", 4, {"mamba": "mamba_scan"}),
    ("recurrentgemma_9b", 3, {"rglru": "rglru_scan",
                              "rg_attn": "flash_attention"}))


def train_full_width(arch, n_layers, kernels, dev, smi):
    """20 AdamW steps of 8 x 256 of the task corpus through
    ``launch/train.py``'s ``build`` and ``train`` (``train/loop.py``'s
    step) at full width and ``n_layers`` layers (None: all): bf16
    activations, fp32 parameters (AdamW's moments need them), no remat;
    whisper with seeded random frames [8, F, d] beside every batch (zero
    frames, the launcher's default, would leave its encoder's attention
    nothing to compute).  The loss must be finite and fall, and each block
    kind's forward and backward kernels launch once a layer (encoder
    layers included) and step.  Returns the run's launches."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build, train
    from repro_torch.models.registry import get_config
    steps = 20
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cut(cfg, n_layers)
    cfg = cfg.replace(dtype="bfloat16", param_dtype="float32")
    model = build(cfg, dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    tcfg = TrainConfig(total_steps=steps, warmup_steps=5,
                       learning_rate=1e-3, remat=False)
    extra = None
    if cfg.arch_type == "audio":
        extra = {"frames": torch.randn(
            8, cfg.encoder_seq, cfg.d_model, device=dev,
            generator=torch.Generator(device=dev).manual_seed(6)).to(
                torch.bfloat16)}
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    out = train(model, cfg, tcfg, steps, 8, 256, log_every=5,
                log=lambda m: log(f"[train] {cfg.name} {m}"), extra=extra)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    first, last = (float(np.mean(out["losses"][:5])),
                   float(np.mean(out["losses"][-5:])))
    log(f"[train] {cfg.name} full width, {n_layers or 'all'} layers "
        f"({' '.join(cfg.block_pattern)}"
        + (f"; {cfg.encoder_layers} encoder layers over frames "
           f"{list(extra['frames'].shape)}" if extra else "")
        + f"), {n_params} fp32 parameters, bf16 "
        f"activations, {steps} AdamW steps of 8 x 256: loss {first:.4f} -> "
        f"{last:.4f} (means of the first and last 5); "
        f"{out['ms_per_step']:.2f} ms a step, {out['tokens_per_s']:.0f} "
        f"tokens/s (steps 2-{steps}); peak memory {peak} B; launches "
        f"{launches}; {smi}")
    if not (all(np.isfinite(out["losses"])) and last < first):
        raise AssertionError(f"{cfg.name}: the training loss is not finite "
                             "or did not fall")
    for kind, kernel in kernels.items():
        want = steps * (cfg.block_pattern.count(kind) + (
            cfg.encoder_layers if extra and kind == "attn" else 0))
        if launches[kernel] != want or launches[kernel + "_bwd"] != want:
            raise AssertionError(f"{cfg.name}: {kernel} and its backward "
                                 f"did not launch once a {kind} layer and "
                                 f"step: {launches}")
    del model, out
    release()
    return launches


def tie_share(model, dev):
    """The share of positions of 8 seeded random prompts of 300 tokens
    whose two largest logits are exactly equal: near 0 on a model that
    ranks its tokens, near 1 on one whose logits have collapsed (where an
    engine check would compare tie-breaking, not the model)."""
    rng = np.random.default_rng(4)
    toks = torch.tensor(rng.integers(3, model.cfg.vocab_size, (8, 300)),
                        dtype=torch.int32, device=dev)
    with torch.no_grad():
        top = model.forward({"tokens": toks})[0].float().topk(2, -1).values
    return float((top[..., 0] == top[..., 1]).float().mean())


def fitted_engine_check(cfg, dev, lr=0.5, max_steps=None):
    """C2 on port-fitted weights: ``quick_fit_ramp`` (SGD at ``lr``, at
    most ``max_steps`` steps) of the 2-layer full-width fp32 cut on the
    card (its gradients through the card's backward kernels), the
    worst-case ramp margin it reaches
    printed, the fitted model's share of exact top-2 ties on random
    prompts at most 0.01 (its logits have not collapsed), then
    ``check_engine`` on those weights (streams, bills and the reflection
    loop identical on the card and the CPU)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build
    from repro_torch.train.quick_fit import _ramp_margin, quick_fit_ramp
    cfg32 = cut(cfg, 2).replace(dtype="float32", param_dtype="float32")
    model = build(cfg32, dev, seed=0)
    before = _ramp_margin(model)
    ops.reset_launches()
    t0 = time.perf_counter()
    quick_fit_ramp(model, lr=lr, max_steps=max_steps)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    margin, ties = _ramp_margin(model), tie_share(model, dev)
    cap = "" if max_steps is None else f", at most {max_steps} steps"
    log(f"[train] {cfg.name}, 2 layers fp32: quick_fit_ramp (lr {lr}{cap}) "
        f"on the card in {fit_s:.2f}s, worst-case ramp margin {before:.4f} "
        f"-> {margin:.4f} (target 2.0); exact top-2 ties on random prompts "
        f"{ties:.4f} (tol 0.01); launches {launches}")
    if not all(k + "_bwd" in launches for k in launches
               if not k.endswith("_bwd")):
        raise AssertionError("the fit's gradients did not go through the "
                             f"backward kernels: {launches}")
    if ties > 0.01:
        raise AssertionError("the fitted model's logits have collapsed: an "
                             "engine check on it would compare ties")
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    del model
    release()
    with timed(f"{cfg.name} fitted engine check"):
        check_engine(cut(cfg, 2), state, dev, None, label="port-fitted")


def phase_train(dev, smi):
    """Training on the card: the card's steps against the CPU's and
    against plain attention, the full 12-layer run of
    ``examples/torch_train_100m.py`` (the main path of the flash backward
    kernel, whose launches are counted from it), C2 on port-fitted
    weights (``quick_fit_ramp`` on the card, then ``check_engine``), a
    speculative serve on ``quick_fit_reflect`` weights; then the recurrent
    families: falcon-mamba-7b's and recurrentgemma-9b's 2-layer steps on
    the card against the CPU, their full-width training runs (the main
    path of the scans' backward kernels), and C2 on falcon-mamba weights
    fitted on the card.  Returns the train runs' launches.  The backward
    kernels' records are taken in phase 3 with the other kernels'
    (``bwd_cases``, ``scan_bwd_cases``)."""
    import torch_train_100m as example
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_config
    from repro_torch.launch.train import build
    runs = {}
    cfg = get_config("reflect_demo_100m")
    with timed("train card vs cpu"):
        runs["reflect_demo_100m train fp32 card"] = train_card_vs_cpu(cfg)
    with timed("train bf16 kernels vs plain"):
        train_bf16_kernels_vs_plain(cfg, dev)
    with timed("train full run"):
        from repro_torch.train import checkpoint as ckpt
        ops.reset_launches()
        out = example.train_demo(steps=200, batch=8, seq=256, device=dev,
                                 log=lambda m: log(f"[train] {m}"))
        launches = dict(ops.LAUNCHES)
        runs["torch_train_100m"] = launches
        ratio = out["last"] / out["first"]
        log(f"[train] {cfg.name} full width and depth, 200 steps of 8 x "
            f"256, bf16 activations, fp32 parameters, AdamW: loss "
            f"{out['first']:.4f} -> {out['last']:.4f} (ratio {ratio:.4f}; "
            f"the reference example's criterion < 0.7 "
            f"{'met' if ratio < 0.7 else 'NOT met'}); "
            f"{out['ms_per_step']:.2f} ms a step, "
            f"{out['tokens_per_s']:.0f} tokens/s (steps 2-200); peak memory "
            f"{out['peak_bytes']} B; launches {launches}")
        if not (all(np.isfinite(out["losses"])) and ratio < 1.0):
            raise AssertionError("the training loss is not finite or did "
                                 "not fall")
        for k in ("flash_attention", "flash_attention_bwd"):
            if launches[k] != 200 * cfg.num_layers:
                raise AssertionError(f"{k} launched {launches[k]} times, "
                                     f"not once a layer and step")
        path = ROOT / "build" / "reflect_demo.msgpack"
        ckpt.save_model(str(path), out["model"], step=200)
        back = build(cfg, dev, seed=1)
        if ckpt.restore_model(str(path), back) != 200 or any(
                not torch.equal(a, b) for a, b in zip(
                    out["model"].state_dict().values(),
                    back.state_dict().values())):
            raise AssertionError("the checkpoint did not restore the "
                                 "trained weights")
        log(f"[train] checkpoint {path.stat().st_size} B written and "
            "restored")
        del out, back
        release()
    with timed("train C2 check"):
        fitted_engine_check(cfg, dev)
    with timed("train fitted speculation"):
        fitted_reflect_serve(cfg, dev)
    for arch, n_layers, kernels in RECURRENT_TRAIN:
        rcfg = get_config(arch)
        scans = [k for k in kernels.values() if k.endswith("scan")]
        with timed(f"train {arch} card vs cpu"):
            train_card_vs_cpu(rcfg, batch=1,
                              kernels=scans + [k + "_bwd" for k in scans])
        with timed(f"train {arch} full width"):
            runs[f"{arch} train"] = train_full_width(arch, n_layers,
                                                     kernels, dev, smi)
    with timed("train falcon_mamba_7b C2 check"):
        # the reference's lr 0.5 collapses this full-width cut's logits,
        # and at 0.1 its margin stays below 0 through all 720 steps
        # (scripts/train_profile.py; PERF.md, PR 23): the base 120 steps
        fitted_engine_check(get_config("falcon_mamba_7b"), dev, lr=0.1,
                            max_steps=120)
    return runs


def phase_quickstart():
    """``examples/torch_quickstart.py`` on the card: three rounds of one
    conversation on the smoke qwen3_0_6b; rounds 1 and 2 must read the
    earlier rounds from the prefix cache, both paged kernels must launch,
    and the run must take under 15 s."""
    import contextlib
    import io

    import torch_quickstart
    from repro_torch.kernels import ops
    ops.reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        run = torch_quickstart.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        if line.strip():
            log(f"[quickstart] {line}")
    reads = [r.usage.cache_read_tokens for r in run["requests"]]
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    log(f"[quickstart] {wall:.2f} s on {torch.cuda.get_device_name(0)}; "
        f"cache reads by round {reads}; launches {launches}")
    if not (reads[1] > 0 and reads[2] > 0):
        raise AssertionError("a quickstart round after the first read "
                             "nothing from the prefix cache")
    if not (launches.get("paged_decode") and launches.get("paged_extend")):
        raise AssertionError("the quickstart did not launch both paged "
                             "kernels")
    if wall > 15:
        raise AssertionError(f"the quickstart took {wall:.1f} s (limit 15)")


def ring_reread(dev):
    """The demo's bf16 ring decode read again at the end of the run, in
    turns with SDPA (``interleaved_ms``), beside the kernels phase's
    reading."""
    from repro_torch.kernels import ops
    F = torch.nn.functional
    B, K, G, hd, C = 8, 4, 3, 64, 2048
    # the kernels phase's demo bf16 window-None inputs (its seed)
    q, k, v, tok, pos, _ = ring_inputs(103, B, K, G, hd, C,
                                       torch.bfloat16, False, dev)
    kern = lambda: ops.decode_attention(q, k, v, tok, pos)
    mask = ring_valid(tok, pos, None)[:, None, None, :]
    qh, kh, vh = q.reshape(B, K * G, 1, hd), k.transpose(1, 2), \
        v.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                 enable_gqa=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev).zero_
    (ms, lo, hi), (lms, llo, lhi) = interleaved_ms(kern, lib, flush)
    log(f"[ring re-read] demo decode_attention bfloat16 at the end of the "
        f"run: kernel median {ms:.4f} ms (range {lo:.4f}-{hi:.4f}), SDPA "
        f"median {lms:.4f} ms (range {llo:.4f}-{lhi:.4f}), in turns, "
        f"cold-L2")
    return ms


# ---------------------------------------------------------------- main

def start_dryrun() -> subprocess.Popen:
    """The meta-device dry run of every arch at ``single`` in a CPU
    process beside the card's phases: no card, one thread, at the lowest
    priority, so the phases' own host work goes first."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
         "single"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, preexec_fn=lambda: os.nice(19))


def finish_dryrun(proc: subprocess.Popen) -> None:
    """Print the dry run's lines; fail unless it passed."""
    try:
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for line in out.splitlines():
        log(f"[dryrun] {line}")
    if proc.returncode != 0 or not out.rstrip().endswith(
            "all dry-runs passed"):
        raise AssertionError(f"the dry run failed (exit {proc.returncode})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "examples"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    smi = phase_device()
    with timed("build"):
        phase_build()
    dry = start_dryrun()
    try:
        return run_phases(dev, smi, dry)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()


def run_phases(dev, smi, dry) -> int:
    with timed("kernels"):
        records = phase_kernels(dev)
    with timed("quickstart"):
        phase_quickstart()
    with timed("serve"):
        runs = phase_serve(dev)
    with timed("mesh"):
        runs.update(phase_mesh(dev))
    with timed("whisper"):
        runs.update(phase_whisper(dev, smi))
    with timed("internvl2"):
        runs.update(phase_internvl2(dev))
    with timed("nemotron"):
        runs.update(phase_nemotron(dev))
    with timed("train"):
        runs.update(phase_train(dev, smi))
    ring_reread(dev)
    with timed("dryrun"):
        finish_dryrun(dry)
    kernels = []
    # each kernel's record at one shape its model's runs give it: paged
    # extend at Sx = 5 (the demo's verify steps make most of its
    # launches), the scans at the 32-lane mixed step with the serve's bf16
    # activations, ring decode and flash at the demo's bf16 shapes, the
    # backward kernels at their training runs' shapes (the demo's for
    # flash, falcon-mamba-7b's bf16 x for mamba, recurrentgemma-9b's)
    rows = [(name, name, key, run) for name, key, run in (
            ("paged_decode", ("paged_decode", "demo", 1, "bfloat16"),
             "reflect_demo_100m"),
            ("paged_extend", ("paged_extend", "demo", 5, "bfloat16"),
             "reflect_demo_100m"),
            ("flash_attention", ("flash_attention", "demo", "bfloat16",
                                 None), "reflect_demo_100m full-sequence"),
            ("decode_attention", ("decode_attention", "demo", "bfloat16"),
             "reflect_demo_100m ring"),
            ("mamba_scan", ("mamba_scan", 32, "bfloat16"),
             "falcon_mamba_7b"),
            ("rglru_scan", ("rglru_scan", 32, "float32"),
             "recurrentgemma_9b"),
            ("flash_attention_bwd", ("flash_attention_bwd", "demo",
                                     "bfloat16"), "torch_train_100m"),
            ("mamba_scan_bwd", ("mamba_scan_bwd", "train", "bfloat16"),
             "falcon_mamba_7b train"),
            ("rglru_scan_bwd", ("rglru_scan_bwd", "train", "float32"),
             "recurrentgemma_9b train"))]
    # the float32 bodies of the two flash kernels (3xTF32 on the tensor
    # cores) at whisper's encoder and the demo's shapes, launched by the
    # float32 card-vs-CPU train steps; bound as 3xTF32 (bound_fma_ms: FMA)
    rows += [
        ("flash_attention fp32 whisper", "flash_attention",
         ("flash_attention", "whisper", "float32", None),
         "whisper_tiny train fp32 card"),
        ("flash_attention fp32 demo", "flash_attention",
         ("flash_attention", "demo", "float32", None),
         "reflect_demo_100m train fp32 card"),
        ("flash_attention_bwd fp32 whisper", "flash_attention_bwd",
         ("flash_attention_bwd", "whisper", "float32"),
         "whisper_tiny train fp32 card"),
        ("flash_attention_bwd fp32 demo train", "flash_attention_bwd",
         ("flash_attention_bwd", "demo", "float32"),
         "reflect_demo_100m train fp32 card")]
    # nemotron-4-340b's hd 192 (K 8, G 12): each serving attention kernel
    # at its shape, launched by its 4-layer full-width runs
    rows += [
        ("paged_decode nemotron", "paged_decode",
         ("paged_decode", "nemotron", 1, "bfloat16"), "nemotron_4_340b"),
        ("paged_extend nemotron", "paged_extend",
         ("paged_extend", "nemotron", 5, "bfloat16"), "nemotron_4_340b"),
        ("flash_attention nemotron", "flash_attention",
         ("flash_attention", "nemotron", "bfloat16", None),
         "nemotron_4_340b full-sequence"),
        ("decode_attention nemotron", "decode_attention",
         ("decode_attention", "nemotron", "bfloat16"),
         "nemotron_4_340b full-sequence")]
    for label, name, key, run in rows:
        rec = records[key]
        kernels.append({
            "name": label, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": runs[run][name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms"),
            **({"bound_fma_ms": rec["bound_fma_ms"]}
               if "bound_fma_ms" in rec else {}),
            **({"device_us": rec["device_us"]} if "device_us" in rec
               else {}),
            **({k: rec[k] for k in ("splits", "splits_from")}
               if "splits_from" in rec else {}),
            "launches_by_run": {r: runs[r][name] for r in runs}})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
