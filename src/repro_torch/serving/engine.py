"""Reflection-aware continuous-batching inference engine (port of the
paged path of ``repro/serving/engine.py``).

The paper's three levers are first-class here:
  * reflection rounds — requests re-enter the scheduler per round with the
    same conversation; prefix caching makes each round's prefill cost
    proportional to its suffix;
  * prompt caching — serving/prefix_cache.py pins the pages of a finished
    round AND of page-aligned chunk boundaries mid-prefill;
  * budget tuning — BudgetTier caps decode steps (thinking budgets).

Scheduling is chunked-prefill continuous batching: prompts and
reflection-round suffixes are split into chunks and interleaved with
in-flight decode tokens in one mixed step (``model.prefill_extend(...,
n_valid)``), under a per-step token budget.  KV memory is a paged pool by
default: every attention layer shares one ``[num_pages, page_size, K,
hd]`` pool and each request owns a page table.  Prefill chunks shrink to
allocatable pages, prefix snapshots pin pages by refcount, the first write
past a shared page copies it (copy-on-write), and on exhaustion the
youngest request is preempted and later replays its prompt and output.
``ServeConfig.paged_kv=False`` serves from dense per-slot ring caches
instead (``[max_batch, capacity]`` per attention layer): the mixed-step
width is clamped to the smallest ring, prefix snapshots copy the slot's
cache, and there is no pool to run out of.  Self-speculative decoding
(``ServeConfig.spec_decode``) drafts by n-gram lookup and scores ``1 +
spec_tokens`` lanes per row in one verify step; rejected lanes roll back
by truncating page-table tails (paged) or are masked and overwritten
(rings whose capacity is max_seq; a window-clamped ring does not
speculate).  Only committed tokens are billed (``TokenUsage``).

Differences from the reference:
  * PyTorch runs eagerly: there is no ``jax.jit``.  With
    ``ServeConfig.aot_warmup`` the constructor warms every step shape the
    serve loop can reach — decode ``[B, 1]``, mixed ``[B, w]`` for each
    bucket width, verify ``[B, 1 + spec_tokens]`` — as CUDA graphs
    (serving/step_graph.py; on the CPU, eager runs through the same static
    buffers), restores the cache to empty, and replays them from then on;
    a step shape that was not warmed runs eagerly and counts in
    ``stats()["step_compiles"]``, the reference's recompile tripwire.
    Sampling and the COW page copies stay eager, outside the graphs.
    Without it every step runs eagerly and ``step_compiles`` is 0.
  * The model runs on ``device`` (CUDA unless the caller asks for the
    CPU); page pools and ring caches are updated in place (never rebound,
    so a captured step keeps their addresses), and COW copies run as one
    indexed copy per pool leaf with only real (src, dst) pairs.
  * Recurrent models (mamba, RG-LRU) keep dense per-slot state beside the
    page pool, as in the reference: zeroed at admission (so a preemption
    replay restarts from zero), copied into prefix snapshots and restored
    from them; speculative decoding is off for them.
  * MoE models serve as attention models (pool layers, speculation on).
    Their decode step routes every batch slot, idle ones included, so the
    engine keeps an idle slot's ``next_token`` and ``pos`` as the
    reference does: through expert capacity they reach the live rows.
  * The reliability layer is the reference's: deterministic fault
    injection (``faults=``, serving/faults.py), deadlines on ``clock``
    (the fault plan's virtual clock when one is installed), NaN
    quarantine, the stall detector and SLO pricing at admission
    (``ServeConfig.slo_price_model``, with core/accounting.py).  The fault
    hooks fire at the reference's opportunities in the reference's order,
    so a plan cloned into both engines fires at the same places.  The
    logit lanes' finite flags are computed on the device and come back
    in the sampled ids' copy to the host, where the consumed lanes are
    read as the reference reads them; and whenever a plan is installed or
    quarantine is on and a row samples at a temperature, a non-finite
    lane is replaced on the device before sampling (``sampler.guard``),
    so a NaN never reaches ``torch.multinomial``.  With every option off
    the step is unchanged.
  * A device mesh (``mesh=``, a ``torch.distributed`` DeviceMesh, or
    ``ServeConfig.mesh``, "DxM": launch/mesh.py) places the engine as the
    reference places it: parameters as DTensors by
    ``launch/rules.serve_rules`` (tensor-parallel along ``model``), the
    cache by its leaves' logical axes (page pools by physical page along
    ``model``, ``num_pages`` rounded up to a multiple of that axis), each
    rank holding its shards.  Steps run through DTensor propagation, and
    the attention reads, the scans and the MoE dispatch run on plain
    tensors inside ``local_map`` (``rules.run_local``): on a mesh of one
    device the hand-written kernels read the local tensors, exactly as
    without a mesh; on a CPU mesh of more devices the plain reads run on
    the gathered pool, the reference's own choice under more than one
    device.  A CUDA mesh of more than one device raises
    ``NotImplementedError`` (ROADMAP A17).  Cache writes, COW copies and
    slot copies write each rank's own shard.
  * A model without a paged layout (whisper: no ``init_cache_paged``)
    serves from rings whatever ``paged_kv`` says, and one without a
    verify step (no ``supports_verify``) serves without speculation, as
    in the reference.
"""
from __future__ import annotations

import copy
import math
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.core.accounting import CostModel, LatencyModel
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_serve_mesh, parse_mesh_spec
from repro_torch.launch.rules import mesh_axes
from repro_torch.models import attention as A
from repro_torch.models.layers import LeafDef
from repro_torch.models.transformer import KV_KINDS, STATE_KINDS
from repro_torch.serving import sampler
from repro_torch.serving.page_pool import PagePool, PagedSnapshot
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.request import (DEADLINE_EPS, BudgetTier, Request,
                                         Status, TokenUsage)
from repro_torch.serving.speculator import (NGramSpeculator, draft_corpus,
                                            external_draft_proposal)
from repro_torch.serving.step_graph import StepGraph


MULTI_GPU = ("a CUDA mesh of more than one device is not served yet "
             "(ROADMAP A17, multi-GPU: the hand-written paged kernels "
             "would need a partial-softmax mode over page shards and a "
             "cross-rank combine); serve on a 1x1 mesh, or a CPU mesh "
             "under torchrun")


def _place_model(model, mesh, place: Dict[str, list]):
    """A copy of ``model`` whose parameters are DTensors on ``mesh``,
    placed by ``place`` (name -> placements); the caller's model is left
    as it was."""
    params = dict(model.named_parameters())
    # the copy's modules are new, its parameters the caller's (replaced
    # below by placed ones)
    model = copy.deepcopy(model, {id(p): p for p in params.values()})
    for name, p in params.items():
        owner, _, leaf = name.rpartition(".")
        placed = torch.nn.Parameter(SH.distribute(p.data, mesh, place[name]),
                                    requires_grad=False)
        placed.__dict__.update({k: v for k, v in p.__dict__.items()
                                if k != "_casts"})
        setattr(model.get_submodule(owner), leaf, placed)
    return model


def _place_cache(defs: List[Dict[str, LeafDef]], places: List[Dict],
                 mesh, device: torch.device) -> List[Dict[str, torch.Tensor]]:
    """Empty caches (``attention.empty_cache``) as DTensors on ``mesh``,
    placed by ``places``: each rank allocates its own shards, K/V leaves
    with their scratch slot behind them."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    out = []
    for layer, place in zip(defs, places):
        shapes = {n: compute_local_shape_and_global_offset(
            d.shape, mesh, place[n])[0] for n, d in layer.items()}
        mine = A.empty_cache({n: LeafDef(shapes[n], d.dtype, d.axes)
                              for n, d in layer.items()}, device)
        out.append({n: DTensor.from_local(
            mine[n], mesh, place[n], run_check=False,
            shape=torch.Size(d.shape),
            stride=torch.empty(d.shape, device="meta").stride())
            for n, d in layer.items()})
    return out


def _on_mesh(fn: Callable[..., torch.Tensor]) -> Callable[..., torch.Tensor]:
    """A step of a mesh-placed model: host tensors count as replicated,
    and the logits come back whole, as a plain tensor."""
    from torch.distributed.tensor.experimental import implicit_replication

    def step(*args):
        with implicit_replication():
            return fn(*args).full_tensor()
    return step


class Engine:
    def __init__(self, model, scfg: ServeConfig, *,
                 device: Optional[Union[str, torch.device]] = None,
                 faults=None, clock: Optional[Callable[[], float]] = None,
                 mesh=None):
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(
                    "mesh= takes a torch.distributed DeviceMesh "
                    f"(launch/mesh.py), not {type(mesh).__name__}")
            if device is None:
                device = mesh.device_type
        # Deterministic fault injection (serving/faults.py).  None (the
        # default) and a rate-0 plan both serve as the engine without it.
        self.faults = faults
        # Clock for deadline enforcement: wall time by default, the fault
        # plan's VirtualClock when one is installed.
        if clock is not None:
            self.clock = clock
        elif faults is not None:
            self.clock = faults.clock
        else:
            self.clock = time.monotonic
        # guarded steps (_guarded): a plan may inject non-finite logits,
        # and quarantine reads their flags
        self._guard = faults is not None or scfg.nan_quarantine
        self.device = resolve_device(device)
        # Device mesh: an explicit DeviceMesh wins, else ServeConfig.mesh
        # ("DxM") builds one, else the single-device engine (None).
        if mesh is None and scfg.mesh:
            n = math.prod(parse_mesh_spec(scfg.mesh))
        else:
            n = mesh.size() if mesh is not None else 1
        if self.device.type == "cuda" and n > 1:
            raise NotImplementedError(MULTI_GPU)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot serve on "
                             f"{self.device}")
        self.mesh = mesh if mesh is not None else (
            make_serve_mesh(scfg.mesh, self.device.type) if scfg.mesh
            else None)
        self.n_devices = n
        self.model = model = model.to(self.device)
        self.cfg: ModelConfig = model.cfg
        self.scfg = scfg
        B, S = scfg.max_batch, scfg.max_seq

        # recurrent (mamba / rglru) layers keep dense per-slot state; the
        # prefix cache derives its exact-boundary rule from the same pattern
        kinds = self.cfg.block_pattern
        self._state_layers = [i for i, k in enumerate(kinds)
                              if k in STATE_KINDS]
        self.prefix_cache = (PrefixCache(scfg.page_size, model_cfg=self.cfg)
                             if scfg.prefix_cache else None)
        self.kv_dtype = scfg.kv_dtype or self.cfg.kv_dtype
        self.attn_impl = ops.resolve_attn_impl(self.device)
        self.paged = bool(scfg.paged_kv
                          and hasattr(model, "init_cache_paged"))
        if self.paged:
            self._pool_layers = [i for i, k in enumerate(kinds)
                                 if k in KV_KINDS]
            # per-slot (batch-axis) layers: what a slot reset, a snapshot
            # copy and adoption touch; the pools are shared
            self._slot_layers = self._state_layers
            ps = scfg.page_size
            self.pages_per_seq = -(-S // ps)
            num_pages = scfg.num_pages or B * self.pages_per_seq
            if self.mesh is not None:
                # round the pool up to a multiple of the 'model' axis so
                # the pages dim shards evenly (spec_for would otherwise
                # replicate the whole pool); extra pages only add headroom
                m_ax = mesh_axes(self.mesh).get("model", 1)
                num_pages = -(-num_pages // m_ax) * m_ax
            if num_pages < self.pages_per_seq:
                raise ValueError(
                    f"num_pages={num_pages} cannot hold one max_seq request "
                    f"({self.pages_per_seq} pages)")
            self.pool = PagePool(num_pages, ps)
            # logical page -> physical page, per slot (-1 = unmapped)
            self.page_tables = np.full((B, self.pages_per_seq), -1,
                                       np.int64)
            self.cache = self._new_cache(model.cache_defs_paged(
                num_pages, ps, self.kv_dtype, B))
            # paged lanes have no ring aliasing: the mixed-step width is
            # bounded only by max_seq
            self.chunk = max(1, min(scfg.prefill_chunk, S))
            # With EVERY attention layer windowed, pages that slid out of
            # the window can never be attended again and are freed as a
            # request advances (every layer shares one table: the widest
            # window rules).  rg_attn layers attend within local_window,
            # attn and moe layers within sliding_window; a model without
            # K/V layers frees nothing (its pages hold no KV).
            wins = [self.cfg.local_window if k == "rg_attn"
                    else self.cfg.sliding_window for k in set(kinds)
                    if k in KV_KINDS]
            self._window_free = (max(wins) if wins and None not in wins
                                 else None)
            # bytes of one physical page across every layer's pools
            self._page_nbytes = sum(
                t.numel() * t.element_size() for i in self._pool_layers
                for t in self.cache[i].values()) // num_pages
            self._ring_cap = None
        else:
            self._slot_layers = list(range(len(kinds)))
            self.pool = self.page_tables = self._window_free = None
            self.cache = self._new_cache(model.cache_defs(
                B, S, self.kv_dtype, seq_shard=False))
            # the mixed-step width never exceeds the smallest ring: with
            # more lanes than slots a chunk would overwrite ring entries
            # before its own lanes attend to them
            cap = model.attn_capacity(S)
            if "rg_attn" in kinds:
                cap = min(cap, self.cfg.local_window)
            self.chunk = max(1, min(scfg.prefill_chunk, cap))
            self._ring_cap = cap
        self.prefill_budget = max(1, scfg.prefill_token_budget)
        # each mixed step runs at the smallest bucket width that fits its
        # planned chunks; the full chunk width is always the last bucket
        self._mixed_buckets = sorted(
            {max(1, min(int(w), self.chunk)) for w in scfg.prefill_buckets}
            | {self.chunk})
        # SLO-aware admission: price a queued request's predicted tokens
        # against its own ceilings (None: no check)
        self.cost_model = (CostModel.for_model(scfg.slo_price_model)
                           if scfg.slo_price_model else None)
        self.latency_model = (LatencyModel.for_model(scfg.slo_price_model)
                              if scfg.slo_price_model else None)

        # self-speculative decoding: recurrent state mutates irreversibly,
        # so a rejected draft could not be rolled back — off for mamba /
        # RG-LRU models; a capacity-clamped ring is unsafe too (a rejected
        # lane's write evicts a live in-window token); paged attention
        # models always qualify
        self.spec = (bool(scfg.spec_decode)
                     and getattr(model, "supports_verify", False)
                     and not self._state_layers
                     and (self.paged or self._ring_cap == S))
        self.spec_tokens = max(1, min(scfg.spec_tokens, S - 1))
        self.speculator = (NGramSpeculator(scfg.spec_ngram,
                                           scfg.spec_ngram_min)
                           if self.spec else None)

        self.slots: List[Optional[Request]] = [None] * B
        self.pos = np.zeros(B, np.int64)
        self.next_token = np.zeros(B, np.int64)
        self.queue: deque[Request] = deque()
        # uid -> request for queued/in-flight only (pruned at completion);
        # finished is a bounded notification buffer drained by poll()
        self.requests: Dict[int, Request] = {}
        self.finished: deque[Request] = deque(maxlen=max(64, 16 * B))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(scfg.seed)
        self._ff_version = -1   # prefix-cache version at last fast-forward
        self._admit_counter = 0
        self._pending_copies: List[Tuple[int, int]] = []   # COW (src, dst)
        # Stall detector state: _progress_seq bumps on every commit /
        # prefill advance / admission / finalize; a step that moves it
        # nowhere while rows are in flight counts toward stall_limit.
        self._progress_seq = 0
        self._no_progress = 0
        self.model_steps = {"prefill_tokens": 0, "extend_tokens": 0,
                            "decode_steps": 0, "decode_batch_steps": 0,
                            "decode_tokens": 0,
                            "mixed_steps": 0, "prefill_chunks": 0,
                            "max_step_prefill_tokens": 0, "preemptions": 0,
                            "starved_mixed_steps": 0,
                            "verify_steps": 0, "spec_drafted": 0,
                            "spec_accepted": 0, "slo_rejections": 0,
                            "timeouts": 0, "stalls": 0, "errors": 0,
                            "nan_quarantines": 0, "crash_recoveries": 0,
                            "stuck_rows": 0}

        # The model call of each step kind, on int32 device tensors
        # (tokens, positions[, n_valid][, page table]) -> logits; the cache
        # is updated in place.  With aot_warmup each runs behind a
        # StepGraph, warmed (captured on a card) before the first request.
        model, cache = self.model, self.cache
        self._fns: Dict[str, Callable[..., torch.Tensor]] = {
            "decode": lambda *a: model.decode_step(cache, *a)[0],
            "mixed": lambda *a: model.prefill_extend(cache, *a)[0],
            "verify": lambda *a: model.prefill_extend(
                cache, *a, all_logits=True)[0]}
        if self.mesh is not None:
            self._fns = {k: _on_mesh(f) for k, f in self._fns.items()}
        self._steps: Dict[str, StepGraph] = {}
        self._startup_s = 0.0           # seconds aot warm-up took
        if scfg.aot_warmup:
            self._aot_compile()

    # ------------------------------------------------------------------ API

    def submit(self, req: Request) -> int:
        """Enqueue a request (non-blocking).  Returns its uid for poll().
        Malformed requests — empty prompt, or a prompt + budget cap that
        cannot fit in max_seq — finalize immediately with stop_reason
        "error" instead of poisoning the batch."""
        req.submitted_at = self.clock()
        if not req.prompt:
            self._finalize_abnormal(req, None, "error", "empty prompt")
            return req.uid
        if len(req.prompt) + self._budget_cap(req) >= self.scfg.max_seq:
            self._finalize_abnormal(
                req, None, "error",
                f"prompt ({len(req.prompt)}) + budget cap "
                f"({self._budget_cap(req)}) would overflow "
                f"max_seq ({self.scfg.max_seq})")
            return req.uid
        self.queue.append(req)
        self.requests[req.uid] = req
        return req.uid

    def poll(self, uid: Optional[int] = None
             ) -> Union[Status, List[Request]]:
        """One cooperative scheduler tick.  With ``uid``: advance one step
        and return that request's status.  Without: advance one step and
        return the requests that finished during it."""
        self.step()
        if uid is not None:
            req = self.requests.get(uid)
            return req.status if req is not None else Status.DONE
        done = list(self.finished)
        self.finished.clear()
        return done

    def run(self, max_steps: int = 100_000) -> None:
        """Drive the scheduler until fully idle (blocking convenience)."""
        for _ in range(max_steps):
            if not self.step():
                break

    # ------------------------------------------------------------ statistics

    def _kv_stats(self) -> Dict[str, Any]:
        """Resident KV, in all and on each device: pool leaves count only
        their used pages; dense per-slot leaves (rings, recurrent state)
        are always resident.  The per-device number reads each leaf's
        local shard, so it follows whatever placement the mesh rules
        resolved (pages sharded along 'model')."""
        def nbytes(layers, part=lambda t: t):
            return [part(t).numel() * t.element_size()
                    for i in layers for t in self.cache[i].values()]

        allocated = sum(nbytes(range(len(self.cache))))
        if not self.paged:
            return {"resident_kv_bytes": allocated,
                    "resident_kv_bytes_per_device": sum(
                        nbytes(range(len(self.cache)), SH.local)),
                    "allocated_kv_bytes": allocated}
        used = self.pool.utilization()

        def resident(part=lambda t: t):
            return (sum(int(nb * used)
                        for nb in nbytes(self._pool_layers, part))
                    + sum(nbytes(self._slot_layers, part)))

        return {"resident_kv_bytes": resident(),
                "resident_kv_bytes_per_device": resident(SH.local),
                "allocated_kv_bytes": allocated,
                "kv_pool_pages_used": self.pool.used_pages,
                "kv_pool_pages": self.pool.num_pages}

    def stats(self) -> Dict[str, Any]:
        """Serving counters and the recompile tripwire: after aot_warmup,
        ``step_compiles`` (steps run at a shape that was not warmed) must
        stay 0; without it every step runs eagerly and it reads 0."""
        out = dict(self.model_steps)
        out["step_compiles"] = sum(f.compiles for f in self._steps.values())
        out["step_compiles_by_fn"] = {n: f.compiles
                                      for n, f in self._steps.items()}
        out["aot_warmed"] = sum(f.warmed for f in self._steps.values())
        out["startup_compile_s"] = self._startup_s
        out["device"] = str(self.device)
        out["n_devices"] = self.n_devices
        out["mesh"] = (mesh_axes(self.mesh) if self.mesh is not None
                       else None)
        out["attn_impl"] = self.attn_impl
        out.update(self._kv_stats())
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats_snapshot()
        return out

    def stats_snapshot(self) -> Dict[str, Any]:
        """Compact per-replica counters for fleet aggregation: the
        scheduler counters that sum across replicas, live occupancy, and
        the prefix cache's own snapshot."""
        out = {k: self.model_steps[k] for k in
               ("prefill_tokens", "extend_tokens", "decode_tokens",
                "preemptions", "slo_rejections", "timeouts", "stalls",
                "errors")}
        out["in_flight"] = sum(r is not None for r in self.slots)
        out["queued"] = len(self.queue)
        if self.paged:
            out["kv_pool_pages_used"] = self.pool.used_pages
            out["kv_pool_pages"] = self.pool.num_pages
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats_snapshot()
        return out

    # ----------------------------------------------------------- internals

    def _budget_cap(self, req: Request) -> int:
        caps = {BudgetTier.NONE: req.max_new_tokens,
                BudgetTier.LOW: self.scfg.max_think_tokens_low,
                BudgetTier.HIGH: self.scfg.max_think_tokens_high}
        return min(req.max_new_tokens, caps[req.budget])

    def _new_cache(self, defs: List[Dict[str, LeafDef]]
                   ) -> List[Dict[str, torch.Tensor]]:
        """Empty caches of ``defs``.  On a mesh, the model's parameters and
        the caches are placed as DTensors by ``serve_state_shardings``
        (the reference's placement of both)."""
        if self.mesh is None:
            return [A.empty_cache(d, self.device) for d in defs]
        params, caches = SH.serve_state_shardings(self.model, defs,
                                                  self.mesh)
        self.model = _place_model(self.model, self.mesh, params)
        return _place_cache(defs, caches, self.mesh, self.device)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

    # ------------------------------------------------------ model steps

    def _aot_compile(self) -> None:
        """Warm every step shape the serve loop can reach (the reference's
        ``aot_compile``): decode [B, 1], mixed [B, w] at each bucket width,
        verify [B, 1 + spec_tokens]; then empty the cache IN PLACE, since
        the warm-up runs wrote into it (ring rows, recurrent state) and
        the graphs hold the leaves' addresses."""
        t0 = time.perf_counter()
        B = self.scfg.max_batch
        pool = (torch.cuda.graph_pool_handle()
                if self.device.type == "cuda" else None)
        kinds = ("decode", "mixed") + (("verify",) if self.spec else ())
        self._steps = {k: StepGraph(self._fns[k], self.device, pool)
                       for k in kinds}
        pt = ((B, self.pages_per_seq),) if self.paged else ()
        self._steps["decode"].warm((B, 1), (B,), *pt)
        for w in self._mixed_buckets:
            self._steps["mixed"].warm((B, w), (B,), (B,), *pt)
        if self.spec:
            self._steps["verify"].warm((B, 1 + self.spec_tokens), (B,),
                                       (B,), *pt)
        for layer in self.cache:
            for name, leaf in layer.items():
                SH.local(leaf).fill_(-1 if name == "tok" else 0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._startup_s = time.perf_counter() - t0

    def _run(self, kind: str, *arrays: np.ndarray) -> torch.Tensor:
        """One model step of ``kind`` on host integer arrays, the page
        table appended when paged: a warmed step's replay, else an eager
        call.  Returns the logits (read them before the next step)."""
        if self.paged:
            arrays += (self.page_tables,)
        if self._steps:
            return self._steps[kind](*arrays)
        return self._fns[kind](*(self._tensor(a) for a in arrays))

    # -------------------------------------------------- page-pool plumbing

    @torch.no_grad()
    def _flush_copies(self) -> None:
        """Apply scheduled COW page copies before this step's writes: one
        indexed copy per pool leaf (src pages are read before any dst is
        written; a dst is never another pair's src within a tick)."""
        if not self._pending_copies:
            return
        src = torch.tensor([s for s, _ in self._pending_copies],
                           device=self.device)
        dst = torch.tensor([d for _, d in self._pending_copies],
                           device=self.device)
        self._pending_copies = []
        for i in self._pool_layers:
            for leaf in self.cache[i].values():
                SH.write_rows(leaf, dst, SH.read_rows(leaf, src))

    def _release_slot_pages(self, slot: int) -> None:
        if not self.paged:
            return
        pages = [int(p) for p in self.page_tables[slot] if p >= 0]
        if pages and self._pending_copies:
            # Drop scheduled COW copies targeting this slot's pages: a
            # freed dst can be re-allocated as another slot's COW dst
            # within the same tick.
            mine = set(pages)
            self._pending_copies = [(s, d) for (s, d) in self._pending_copies
                                    if d not in mine]
        if pages:
            self.pool.decref(pages)
        self.page_tables[slot, :] = -1

    def _alloc_page(self, protect: int) -> Optional[int]:
        """One free page, reclaiming under pressure: first evict prompt-
        cache entries, then preempt the youngest-admitted request.
        ``protect`` is the slot asking — it is never its own victim."""
        while True:
            pg = self.pool.alloc()
            if pg is not None:
                return pg
            if self.prefix_cache is not None and self.prefix_cache.evict_lru():
                continue
            if self._preempt_one(protect):
                continue
            return None

    def _preempt_one(self, protect: int) -> bool:
        """Preempt the youngest request that is YOUNGER than the one
        asking for pages (strict FIFO)."""
        asking = self.slots[protect]
        pseq = asking.admit_seq if asking is not None else -1
        cands = [i for i, r in enumerate(self.slots)
                 if r is not None and i != protect and r.admit_seq > pseq]
        if not cands:
            return False
        victim = max(cands, key=lambda i: self.slots[i].admit_seq)
        self._preempt_slot(victim)
        return True

    def _preempt_slot(self, slot: int) -> None:
        """Evict a request from the pool and requeue it at the FRONT of
        the admission queue.  Its generated tokens survive: re-admission
        replays prompt+output, restoring the decode state exactly."""
        req = self.slots[slot]
        self._release_slot_pages(slot)
        if req.status is Status.DECODING:
            # decode positions were billed as output; the replay must not
            # re-bill them as input
            req.billed_prefill = max(req.billed_prefill,
                                     len(req.prompt) + len(req.output))
        req.status = Status.QUEUED
        req.prefill_pos = 0
        req.cached_len = 0
        req.prefill_target = None
        req.preemptions += 1
        self.model_steps["preemptions"] += 1
        self.queue.appendleft(req)
        self.slots[slot] = None

    def _ensure_range(self, slot: int, p0: int, n: int) -> int:
        """Map (alloc / copy-on-write) every logical page the token range
        [p0, p0+n) touches.  Returns how many of the n tokens are backed
        by writable pages — the planner shrinks the chunk to this."""
        ps = self.pool.page_size
        first, last = p0 // ps, (p0 + n - 1) // ps
        for lpage in range(first, last + 1):
            pg = int(self.page_tables[slot, lpage])
            if pg >= 0 and not self.pool.needs_cow(pg):
                continue
            new = self._alloc_page(protect=slot)
            if new is None:
                return max(0, lpage * ps - p0)
            if pg >= 0:
                # copy-on-write of a shared boundary page
                self._pending_copies.append((pg, new))
                self.pool.stats["cow_copies"] += 1
                self.pool.decref([pg])
            self.page_tables[slot, lpage] = new
        return n

    def _free_out_of_window(self, slot: int, extent: int) -> None:
        """Release pages that can never be attended again: future queries
        sit at positions >= ``extent`` and attend only tokens
        > extent - window."""
        if self._window_free is None:
            return
        ps = self.pool.page_size
        nfree = max(0, extent - self._window_free + 1) // ps
        for lpage in range(min(nfree, self.pages_per_seq)):
            pg = int(self.page_tables[slot, lpage])
            if pg >= 0:
                self.pool.decref([pg])
                self.page_tables[slot, lpage] = -1

    def _ensure_decode_pages(self, drafts: Optional[Dict[int, List[int]]]
                             = None) -> None:
        """Every DECODING row writes one token this step — plus its draft
        when speculating; make those pages writable first, oldest rows
        first.  Under pressure a row's draft shrinks to the tokens its
        pages can back before anyone is preempted for draft pages."""
        rows = sorted(
            (i for i, r in enumerate(self.slots)
             if r is not None and r.status is Status.DECODING),
            key=lambda i: self.slots[i].admit_seq)
        for slot in rows:
            if self.slots[slot] is None:               # preempted meanwhile
                continue
            d = drafts.get(slot) if drafts else None
            want = 1 + (len(d) if d else 0)
            got = self._ensure_range(slot, int(self.pos[slot]), want)
            if got == 0:
                # nothing reclaimable: this row itself must wait its turn
                self._preempt_slot(slot)
                if drafts:
                    drafts.pop(slot, None)
            elif d and got < want:
                if got <= 1:
                    drafts.pop(slot)
                else:
                    drafts[slot] = d[:got - 1]

    # ------------------------------------------------- dense per-slot cache

    def _slot_cache(self, slot: int) -> Dict[int, Dict[str, torch.Tensor]]:
        """A copy of one request's dense per-slot cache, by layer index
        (``[1, ...]`` leaves): ring caches and recurrent state; the shared
        page pools are not part of it."""
        return {i: {k: SH.read_rows(v, slice(slot, slot + 1)).clone()
                    for k, v in self.cache[i].items()}
                for i in self._slot_layers}

    def _set_slot_cache(self, slot: int,
                        state: Dict[int, Dict[str, torch.Tensor]]) -> None:
        for i, leaves in state.items():
            for k, v in leaves.items():
                SH.write_rows(self.cache[i][k], slice(slot, slot + 1), v)

    def _blank_slot(self, slot: int) -> None:
        """The blank row: no cache of the previous occupant survives
        (rings empty, tok = -1; state zero)."""
        for i in self._slot_layers:
            for name, leaf in self.cache[i].items():
                SH.write_rows(leaf, slice(slot, slot + 1), torch.full(
                    (1, *leaf.shape[1:]), -1 if name == "tok" else 0,
                    dtype=leaf.dtype, device=self.device))

    # ------------------------------------------------------------ snapshots

    def _make_snapshot(self, slot: int, n_tokens: int) -> PagedSnapshot:
        ps = self.pool.page_size
        npages = -(-n_tokens // ps)
        pages = [int(p) for p in self.page_tables[slot, :npages]]
        # windowed models free slid-out pages (-1 entries): the snapshot
        # stays usable — an adopter's queries can never attend them either
        live = [p for p in pages if p >= 0]
        if self._window_free is None and len(live) != npages:
            raise RuntimeError("snapshot of unmapped pages")
        self.pool.incref(live)
        rec = self._slot_cache(slot) if self._slot_layers else None
        rec_nbytes = sum(t.numel() * t.element_size()
                         for leaves in (rec or {}).values()
                         for t in leaves.values())
        return PagedSnapshot(pages=pages, n_tokens=n_tokens, recurrent=rec,
                             nbytes=len(live) * self._page_nbytes + rec_nbytes,
                             meta={"page_nbytes": self._page_nbytes,
                                   "rec_nbytes": rec_nbytes})

    def _insert_snapshot(self, tokens: List[int], slot: int,
                         boundary: bool = False) -> None:
        """Publish a prefix snapshot: O(1) page pins when paged, a copy of
        the slot's cache with rings."""
        if not tokens:
            return
        on_evict = None
        if self.paged:
            snap = self._make_snapshot(slot, len(tokens))
            on_evict = (lambda pages=tuple(p for p in snap.pages if p >= 0):
                        self.pool.decref(pages))
        else:
            snap = self._slot_cache(slot)
        if boundary:
            self.prefix_cache.insert_boundary(list(tokens), snap, on_evict)
        else:
            self.prefix_cache.insert(list(tokens), snap, on_evict)

    def _adopt_snapshot(self, slot: int, snap, cached: int) -> None:
        """Paged: map a snapshot's physical pages into this slot's table
        (shared, refcounted) and restore dense recurrent state.  Ring: copy
        the snapshot (already truncated to ``cached`` tokens by the lookup)
        into the slot."""
        if not self.paged:
            self._set_slot_cache(slot, snap)
            return
        ps = self.pool.page_size
        npages = -(-cached // ps)
        pages = snap.pages[:npages]
        self.pool.incref([p for p in pages if p >= 0])
        self.page_tables[slot, :npages] = pages
        if snap.recurrent is not None:
            # recurrent state summarizes exactly n_tokens; the lookup
            # rules guarantee untrimmed full hits for stateful models
            if cached != snap.n_tokens:
                raise RuntimeError(f"recurrent snapshot of {snap.n_tokens} "
                                   f"tokens adopted at {cached}")
            self._set_slot_cache(slot, snap.recurrent)

    # ------------------------------------------------------------ admission

    def _slo_reject(self, req: Request) -> bool:
        """Deadline/cost-aware admission: finalize a fresh request whose
        ceilings cannot fund its own predicted tokens (prefill at the
        prefix-cache hit length it would get right now, decode at its
        full budget cap).  Only fresh requests are checked: a preempted
        replay's work already happened and must be resumed, and the
        reflection controller prices each round as its own request."""
        if self.cost_model is None or req.preemptions or req.output:
            return False
        if req.max_cost_usd is None and req.max_latency_s is None:
            return False
        cached = 0
        if self.prefix_cache is not None:
            # peek: a pure length estimate that moves no hit statistics
            # and no LRU order
            res = self.prefix_cache.lookup(list(req.prompt),
                                           record_miss=False, peek=True)
            cached = min(res.cached_len, len(req.prompt) - 1)
        fresh = len(req.prompt) - cached
        pred = TokenUsage(input_tokens=fresh, cache_read_tokens=cached,
                          cache_write_tokens=fresh,
                          output_tokens=self._budget_cap(req))
        cost = self.cost_model.cost(pred)
        lat = self.latency_model.latency(pred)
        if ((req.max_cost_usd is None or cost <= req.max_cost_usd + 1e-12)
                and (req.max_latency_s is None
                     or lat <= req.max_latency_s + DEADLINE_EPS)):
            return False
        req.status = Status.DONE
        req.stop_reason = "slo"
        req.decision_trace.append(
            {"action": "finalize", "reason": "slo",
             "pred_cost_usd": cost, "pred_latency_s": lat,
             "max_cost_usd": req.max_cost_usd,
             "max_latency_s": req.max_latency_s})
        self.model_steps["slo_rejections"] += 1
        self._progress_seq += 1
        self.finished.append(req)
        self.requests.pop(req.uid, None)
        return True

    # ------------------------------------------- reliability (faults.py)

    def _finalize_abnormal(self, req: Request, slot: Optional[int],
                           reason: str, detail: Optional[str] = None) -> None:
        """Terminal finalize outside the normal eos/budget path: billing
        stays frozen at the committed watermark, pages are released, and
        the caller sees a definite stop_reason ("timeout" / "stalled" /
        "error")."""
        req.status = Status.DONE
        req.stop_reason = reason
        if detail is not None:
            req.error = detail
        rec = {"action": "finalize", "reason": reason}
        if detail is not None:
            rec["detail"] = detail
        req.decision_trace.append(rec)
        self.model_steps[{"timeout": "timeouts", "stalled": "stalls",
                          "error": "errors"}[reason]] += 1
        self._progress_seq += 1
        self.finished.append(req)
        self.requests.pop(req.uid, None)
        if slot is not None:
            self._release_slot_pages(slot)
            self.slots[slot] = None

    def _enforce_deadlines(self) -> None:
        """Finalize every queued or in-flight request whose max_latency_s
        has elapsed (stop_reason "timeout").  Partial output survives and
        is billed exactly as committed."""
        now = self.clock()

        def expired(r: Request) -> bool:
            # the admission epsilon: a request accepted exactly at its
            # deadline must not time out on its first tick
            return (r.max_latency_s is not None
                    and r.submitted_at is not None
                    and now - r.submitted_at > r.max_latency_s + DEADLINE_EPS)

        if any(expired(r) for r in self.queue):
            keep: deque[Request] = deque()
            while self.queue:
                r = self.queue.popleft()
                if expired(r):
                    self._finalize_abnormal(r, None, "timeout")
                else:
                    keep.append(r)
            self.queue = keep
        for slot, r in enumerate(self.slots):
            if r is not None and expired(r):
                self._finalize_abnormal(r, slot, "timeout")

    def _nonfinite_rows(self, finite: Optional[np.ndarray], rows: List[int],
                        nv: Optional[np.ndarray] = None,
                        ndraft: Optional[np.ndarray] = None) -> List[int]:
        """Rows (among ``rows``) whose CONSUMED logit lanes are not all
        finite, from the lanes' flags that came back with the sampled ids
        (``finite``: [B], or [B, W] for a verify step; None when
        quarantine is off).  Lanes that are never consumed — nv=0 no-op
        lanes, verify-step padding past nv — are excluded: fully masked
        attention can legitimately produce NaN there."""
        if not rows or finite is None:
            return []
        bad = []
        for s in rows:
            if finite.ndim == 1:
                ok = bool(finite[s])
            elif ndraft is not None and ndraft[s] > 0:
                # verify window: lanes [0, nv) are scored for acceptance
                ok = bool(finite[s, :nv[s]].all())
            else:
                ok = bool(finite[s, nv[s] - 1])
            if not ok:
                bad.append(s)
        return bad

    def _quarantine_rows(self, bad: List[int]) -> None:
        """Non-finite logits: skip the row's commit this step and replay
        it through the preemption path (prefix-cache snapshots and the
        billed_prefill watermark: no recomputed token is billed twice).
        Bounded per request by nan_retry_limit, after which the request
        finalizes with stop_reason "error"."""
        for slot in bad:
            req = self.slots[slot]
            if req is None:
                continue
            req.nan_retries += 1
            self.model_steps["nan_quarantines"] += 1
            req.decision_trace.append(
                {"action": "fault", "kind": "nan_quarantine",
                 "retries": req.nan_retries})
            if req.nan_retries > self.scfg.nan_retry_limit:
                self._finalize_abnormal(
                    req, slot, "error",
                    "non-finite logits persisted past nan_retry_limit")
            else:
                self._preempt_slot(slot)

    def _mark_stuck(self) -> None:
        """Fault hook ("engine.stuck"): one decoding row stops committing
        tokens — its lane still runs, nothing lands.  Reaped by the stall
        detector (or its own deadline)."""
        rows = [i for i, r in enumerate(self.slots)
                if r is not None and r.status is Status.DECODING
                and not r.stuck]
        if not rows:
            return
        req = self.slots[rows[self.faults.pick(len(rows))]]
        req.stuck = True
        self.model_steps["stuck_rows"] += 1
        req.decision_trace.append({"action": "fault", "kind": "stuck"})

    def _crash_recover(self) -> None:
        """Simulated mid-run crash ("engine.crash"): in-flight state is
        lost at a step boundary.  Recovery preempts every occupied slot,
        youngest first, so the oldest admission heads the queue; replay
        re-adopts prefix-cache snapshots and recomputes the rest, and the
        billed_prefill watermarks bill no token twice."""
        self.model_steps["crash_recoveries"] += 1
        occupied = [i for i, r in enumerate(self.slots) if r is not None]
        for slot in sorted(occupied,
                           key=lambda i: -self.slots[i].admit_seq):
            self._preempt_slot(slot)
        self._no_progress = 0

    def _admit(self, req: Request, slot: int) -> None:
        """Assign a queued request to a free slot.  No model work happens
        here — prefill is chunked into subsequent mixed steps.  After a
        preemption the request replays prompt+output (prefill_target)."""
        req.prefill_target = list(req.prompt) + list(req.output)
        target = req.prefill_target
        res = None
        cached_len = 0
        if self.prefix_cache is not None:
            res = self.prefix_cache.lookup(target)
            # a full-prompt hit still needs >=1 suffix token for logits
            cached_len = min(res.cached_len, len(target) - 1)
        self._blank_slot(slot)
        if cached_len > 0 and res.cache is not None:
            self._adopt_snapshot(slot, res.cache, cached_len)
            req.usage += TokenUsage(cache_read_tokens=max(
                0, cached_len - req.billed_prefill))
            req.billed_prefill = max(req.billed_prefill, cached_len)
        else:
            cached_len = 0
        req.prefill_pos = cached_len
        req.cached_len = cached_len
        req.status = Status.PREFILLING
        self._admit_counter += 1
        req.admit_seq = self._admit_counter
        self.slots[slot] = req
        self._progress_seq += 1

    def _maybe_finish(self, slot: int) -> None:
        req = self.slots[slot]
        if req is None:
            return
        cap = self._budget_cap(req)
        if req.eos_id is not None and req.output and req.output[-1] == req.eos_id:
            req.stop_reason = "eos"
        elif len(req.output) >= cap:
            req.stop_reason = ("budget" if cap < req.max_new_tokens
                               else "max_tokens")
        else:
            return
        req.status = Status.DONE
        self.finished.append(req)
        self.requests.pop(req.uid, None)
        if self.prefix_cache is not None:
            # the last sampled token is NOT yet in the cache: snapshot
            # prompt + output[:-1]
            convo = list(req.prompt) + req.output[:-1]
            if len(convo) > 0:
                self._insert_snapshot(convo, slot)
        self._release_slot_pages(slot)
        self.slots[slot] = None

    def _temperatures(self) -> np.ndarray:
        temps = np.zeros(len(self.slots), np.float32)
        for i, r in enumerate(self.slots):
            if r is not None:
                temps[i] = r.temperature
        return temps

    def _guarded(self, logits: torch.Tensor, temps: np.ndarray
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """A guarded step's logits to sample from, and their lanes' finite
        flags (None when quarantine is off).  Only a temperature row can
        carry a non-finite lane into ``torch.multinomial`` — a greedy row
        takes the argmax (NaN counting as the largest, as the reference's
        does) and the sampler gives it a uniform row to draw from — so the
        lanes are replaced only when a row is hot: each eager operation
        costs the host a launch."""
        finite = None
        if (temps > 0).any():
            logits, finite = sampler.guard(logits)
        if not self.scfg.nan_quarantine:
            return logits, None
        if finite is None:
            finite = torch.isfinite(logits).all(dim=-1)
        return logits, finite

    def _sample_rows(self, logits: torch.Tensor, rows: List[int]
                     ) -> Tuple[np.ndarray, List[int]]:
        """One batched sampling call for every row (greedy rows ignore
        the generator; rows without a request are discarded), and the
        rows among ``rows`` to quarantine.  Guarded, a non-finite row is
        replaced before sampling, and with quarantine on the rows' finite
        flags come back in the same copy to the host as the ids."""
        temps = self._temperatures()
        finite = None
        if self._guard:
            logits, finite = self._guarded(logits, temps)
        ids = sampler.sample_batch(logits,
                                   torch.from_numpy(temps).to(self.device),
                                   self.generator)
        if finite is None:
            return ids.cpu().numpy(), []
        host = torch.cat([ids, finite.to(ids.dtype)]).cpu().numpy()
        B = len(self.slots)
        return host[:B], self._nonfinite_rows(host[B:], rows)

    def _fast_forward(self) -> None:
        """In-flight prefix sharing: a PREFILLING slot jumps ahead when a
        longer usable prefix snapshot has appeared since its admission
        (pure page-table metadata).  Skipped when nothing was inserted
        since the last scan."""
        if self.prefix_cache is None:
            return
        if self.prefix_cache.version == self._ff_version:
            return
        self._ff_version = self.prefix_cache.version
        for slot, req in enumerate(self.slots):
            if req is None or req.status is not Status.PREFILLING:
                continue
            target = req.prefill_target
            if req.prefill_pos >= len(target) - 1:
                continue                  # last token must be processed live
            res = self.prefix_cache.lookup(target,
                                           min_len=req.prefill_pos,
                                           record_miss=False)
            cached = min(res.cached_len, len(target) - 1)
            if res.cache is None or cached <= req.prefill_pos:
                continue
            self._release_slot_pages(slot)
            self._adopt_snapshot(slot, res.cache, cached)
            req.usage += TokenUsage(cache_read_tokens=max(
                0, cached - max(req.billed_prefill, req.prefill_pos)))
            req.billed_prefill = max(req.billed_prefill, cached)
            req.prefill_pos = cached
            req.cached_len = cached

    def _make_drafts(self) -> Dict[int, List[int]]:
        """Prompt-lookup drafting for every DECODING row (host-side).
        Draft length is clamped to the row's output budget and max_seq."""
        drafts: Dict[int, List[int]] = {}
        for slot, req in enumerate(self.slots):
            if req is None or req.status is not Status.DECODING or req.stuck:
                continue
            rem = self._budget_cap(req) - len(req.output)
            kmax = min(self.spec_tokens, rem,
                       self.scfg.max_seq - 1 - int(self.pos[slot]))
            if kmax <= 0:
                continue
            d = None
            if req.external_draft is not None:
                d = external_draft_proposal(req.external_draft, req.output,
                                            kmax)
            if d is None:
                d = self.speculator.propose(
                    draft_corpus(req.prompt, req.output, req.spec_context),
                    kmax)
            if d:
                drafts[slot] = d
        return drafts

    def _clamp_drafts_to_budget(self, drafts: Dict[int, List[int]]) -> None:
        """Shrink drafted lanes so speculation never consumes the whole
        step token budget while a request is PREFILLING (youngest drafted
        rows lose lanes first)."""
        cap = self.prefill_budget
        if any(r is not None and r.status is Status.PREFILLING
               for r in self.slots):
            cap -= 1
        total = sum(len(d) for d in drafts.values())
        if total <= cap:
            return
        for slot in sorted(drafts,
                           key=lambda s: -self.slots[s].admit_seq):
            cut = min(len(drafts[slot]), total - cap)
            total -= cut
            if cut == len(drafts[slot]):
                del drafts[slot]
            else:
                drafts[slot] = drafts[slot][:len(drafts[slot]) - cut]
            if total <= cap:
                return

    def _plan_chunks(self, width: Optional[int] = None,
                     budget: Optional[int] = None) -> Dict[int, int]:
        """Token-budget admission of prefill work into this step: each
        PREFILLING slot gets min(chunk, remaining, budget-left) lanes,
        oldest admission first, shrunk to the tokens whose pages are
        allocatable right now.  ``width``/``budget`` override the defaults
        when prefill rides a verify step."""
        plan: Dict[int, int] = {}
        width = self.chunk if width is None else width
        budget = self.prefill_budget if budget is None else budget
        waiting = sorted(
            (i for i, r in enumerate(self.slots)
             if r is not None and r.status is Status.PREFILLING),
            key=lambda i: self.slots[i].admit_seq)
        for slot in waiting:
            if budget <= 0:
                break
            req = self.slots[slot]
            if req is None or req.status is not Status.PREFILLING:
                continue                  # preempted during an earlier alloc
            n = min(width, req.prefill_remaining, budget)
            if n > 0 and self.paged:
                n = self._ensure_range(slot, req.prefill_pos, n)
            if n > 0:
                plan[slot] = n
                budget -= n
        return {s: n for s, n in plan.items() if self.slots[s] is not None}

    def _postprocess_prefill(self, slot: int, n: int,
                             sampled: np.ndarray) -> None:
        req = self.slots[slot]
        target = req.prefill_target
        self._progress_seq += 1
        req.prefill_pos += n
        req.prefill_chunks += 1
        req.prefill_steps += 1
        self.model_steps["prefill_chunks"] += 1
        if req.cached_len > 0:
            self.model_steps["extend_tokens"] += n
        else:
            self.model_steps["prefill_tokens"] += n
        # bill only positions never billed before: a preemption replay
        # recomputes tokens the user already paid for
        billable = max(0, req.prefill_pos - max(req.billed_prefill,
                                                req.prefill_pos - n))
        req.usage += TokenUsage(input_tokens=billable,
                                cache_write_tokens=billable)
        req.billed_prefill = max(req.billed_prefill, req.prefill_pos)
        if req.prefill_remaining == 0:
            # prompt fully in cache: sample the first token
            tok = int(sampled[slot])
            req.output.append(tok)
            req.usage.output_tokens += 1
            req.status = Status.DECODING
            self.pos[slot] = len(target)
            self.next_token[slot] = tok
            self._free_out_of_window(slot, len(target))
            if self.prefix_cache is not None:
                self._insert_snapshot(list(target), slot)
            self._maybe_finish(slot)
        else:
            self._free_out_of_window(slot, req.prefill_pos)
            if (self.prefix_cache is not None
                    and self.scfg.cache_prefill_chunks
                    and self.prefix_cache.wants_boundary(
                        target[:req.prefill_pos])):
                self._insert_snapshot(list(target[:req.prefill_pos]), slot,
                                      boundary=True)

    def _postprocess_decode(self, slot: int, sampled: np.ndarray) -> None:
        req = self.slots[slot]
        self._progress_seq += 1
        tok = int(sampled[slot])
        req.output.append(tok)
        req.usage.output_tokens += 1
        req.decode_steps += 1
        self.model_steps["decode_tokens"] += 1
        self.pos[slot] += 1
        self.next_token[slot] = tok
        self._free_out_of_window(slot, int(self.pos[slot]))
        self._maybe_finish(slot)

    def _postprocess_verify(self, slot: int, n_emit: int,
                            emit_row: np.ndarray, drafted: int) -> None:
        """Commit one decode row's verify outcome — the accepted draft
        prefix plus the model-sampled token — then roll back page-table
        tail pages that hold only rejected positions.  Only committed
        tokens are billed."""
        req = self.slots[slot]
        self._progress_seq += 1
        P = int(self.pos[slot])
        req.spec_drafted += drafted
        req.spec_accepted += n_emit - 1
        req.decode_steps += 1
        self.model_steps["spec_drafted"] += drafted
        self.model_steps["spec_accepted"] += n_emit - 1
        for i in range(n_emit):
            tok = int(emit_row[i])
            req.output.append(tok)
            req.usage.output_tokens += 1
            self.model_steps["decode_tokens"] += 1
            self.pos[slot] = P + i + 1
            self.next_token[slot] = tok
            self._maybe_finish(slot)
            if self.slots[slot] is None:      # finished (eos / cap): pages
                return                        # are already released
        if not self.paged:
            return          # rejected ring writes are masked and rewritten
        # free tail pages holding ONLY rejected draft positions; the page
        # holding the committed frontier stays
        ps = self.pool.page_size
        keep = int(self.pos[slot]) // ps + 1
        if (P + drafted) // ps >= keep:
            self.pool.truncate_tail(self.page_tables[slot], keep)
        self._free_out_of_window(slot, int(self.pos[slot]))

    # ----------------------------------------------------------------- step

    def step(self) -> bool:
        """One scheduler tick.  Returns False when fully idle.

        Reliability wrapper around the scheduling core (_step_inner):
        fault hooks fire at the step boundary (crash, stuck row, latency
        spikes on the plan's virtual clock), expired deadlines finalize
        before any new work is planned, and the stall detector reaps the
        in-flight rows after stall_limit consecutive steps without
        progress — all off by default."""
        if self.faults is not None:
            self.faults.on_step()
            if self.faults.fire("engine.crash") is not None:
                self._crash_recover()
                return (bool(self.queue)
                        or any(r is not None for r in self.slots))
            if self.faults.fire("engine.stuck") is not None:
                self._mark_stuck()
        if self.scfg.enforce_deadlines:
            self._enforce_deadlines()
        p0 = self._progress_seq
        busy = self._step_inner()
        if self.scfg.stall_limit > 0:
            if (self._progress_seq == p0
                    and any(r is not None for r in self.slots)):
                self._no_progress += 1
                if self._no_progress >= self.scfg.stall_limit:
                    for slot, r in enumerate(self.slots):
                        if r is not None:
                            self._finalize_abnormal(r, slot, "stalled")
                    self._no_progress = 0
                    busy = (bool(self.queue)
                            or any(r is not None for r in self.slots))
            else:
                self._no_progress = 0
        return busy

    def _step_inner(self) -> bool:
        """The scheduling core: admission, planning, one model call."""
        # admit queued requests into free slots (no model work yet);
        # SLO-unfundable requests finalize without taking a slot
        for slot in range(len(self.slots)):
            while self.slots[slot] is None and self.queue:
                req = self.queue.popleft()
                if not self._slo_reject(req):
                    self._admit(req, slot)
        if not any(r is not None for r in self.slots):
            return bool(self.queue)

        self._fast_forward()
        # speculative drafts first: decode rows outrank prefill for pages
        # and the step token budget, but never eat the whole budget while
        # someone is prefilling
        drafts = self._make_drafts() if self.spec else {}
        if drafts:
            self._clamp_drafts_to_budget(drafts)
        if self.paged:
            self._ensure_decode_pages(drafts)
        plan = self._plan_chunks(
            width=min(self.chunk, 1 + self.spec_tokens) if drafts else None,
            budget=(self.prefill_budget
                    - sum(len(d) for d in drafts.values()))
            if drafts else None)
        if self.paged:
            self._flush_copies()
        decode_rows = [i for i, r in enumerate(self.slots)
                       if r is not None and r.status is Status.DECODING]
        drafts = {s: d for s, d in drafts.items()
                  if self.slots[s] is not None
                  and self.slots[s].status is Status.DECODING}
        if not plan and not decode_rows:
            # pool pressure can leave a step with nothing runnable
            return bool(self.queue) or any(r is not None for r in self.slots)
        starved = any(r is not None and r.status is Status.PREFILLING
                      for r in self.slots) and not plan
        if starved:
            self.model_steps["starved_mixed_steps"] += 1

        if drafts:
            return self._verify_step(plan, decode_rows, drafts)

        if not plan and not starved:
            # decode fast path: taken only when NO row is PREFILLING (the
            # decode step has no validity mask, so a page-starved
            # prefilling row must ride the mixed step as an nv=0 no-op)
            logits = self._run("decode", self.next_token[:, None], self.pos)
            self.model_steps["decode_batch_steps"] += 1
            self.model_steps["decode_steps"] += len(decode_rows)
            if self.faults is not None:
                logits = self.faults.corrupt_logits("engine.logits", logits,
                                                    decode_rows)
            sampled, bad = self._sample_rows(logits, decode_rows)
            self._quarantine_rows(bad)
            for slot in decode_rows:
                req = self.slots[slot]
                if req is None or req.stuck:   # quarantined / fault-stuck
                    continue
                self._postprocess_decode(slot, sampled)
            return True

        # mixed step: decode rows ride in lane 0; prefill rows get chunks,
        # at the smallest bucket width that fits this step's chunks
        B = len(self.slots)
        need = max(plan.values()) if plan else 1
        W = next(w for w in self._mixed_buckets if w >= need)
        toks, pos0, nv = self._lanes(B, W, plan, decode_rows, {})
        logits = self._run("mixed", toks, pos0, nv)
        self.model_steps["mixed_steps"] += 1
        self.model_steps["decode_steps"] += len(decode_rows)
        self.model_steps["max_step_prefill_tokens"] = max(
            self.model_steps["max_step_prefill_tokens"],
            int(sum(plan.values())))
        consumed = decode_rows + list(plan)
        if self.faults is not None:
            logits = self.faults.corrupt_logits("engine.logits", logits,
                                                consumed)
        sampled, bad = self._sample_rows(logits, consumed)
        self._quarantine_rows(bad)
        for slot, n in plan.items():
            if self.slots[slot] is None:       # quarantined this step
                continue
            self._postprocess_prefill(slot, n, sampled)
        for slot in decode_rows:
            req = self.slots[slot]
            if req is None or req.stuck:
                continue
            self._postprocess_decode(slot, sampled)
        return True

    def _lanes(self, B: int, W: int, plan: Dict[int, int],
               decode_rows: List[int], drafts: Dict[int, List[int]]):
        """Host-side lane arrays of a mixed or verify step: decode rows
        carry [next token, draft...] at their position, prefill rows their
        planned chunk.  Returns (tokens [B,W], pos0 [B], n_valid [B])."""
        toks = np.zeros((B, W), np.int32)
        pos0 = np.zeros(B, np.int32)
        nv = np.zeros(B, np.int32)
        for slot in decode_rows:
            d = drafts.get(slot, [])
            toks[slot, 0] = self.next_token[slot]
            toks[slot, 1:1 + len(d)] = d
            pos0[slot] = self.pos[slot]
            nv[slot] = 1 + len(d)
        for slot, n in plan.items():
            req = self.slots[slot]
            toks[slot, :n] = req.prefill_target[req.prefill_pos:
                                                req.prefill_pos + n]
            pos0[slot] = req.prefill_pos
            nv[slot] = n
        return toks, pos0, nv

    def _verify_step(self, plan: Dict[int, int], decode_rows: List[int],
                     drafts: Dict[int, List[int]]) -> bool:
        """One speculative verify step: score every row's committed token
        + drafted continuation in a single [B, 1 + spec_tokens] model call
        with per-lane logits, then commit the longest accepted prefix per
        row.  Prefill rows consume their planned (narrow) chunks."""
        B, W = len(self.slots), 1 + self.spec_tokens
        toks, pos0, nv = self._lanes(B, W, plan, decode_rows, drafts)
        ndraft = np.zeros(B, np.int32)
        for slot in decode_rows:
            ndraft[slot] = len(drafts.get(slot, []))
        logits_all = self._run("verify", toks, pos0, nv)
        self.model_steps["verify_steps"] += 1
        self.model_steps["decode_steps"] += len(decode_rows)
        self.model_steps["max_step_prefill_tokens"] = max(
            self.model_steps["max_step_prefill_tokens"],
            int(sum(plan.values())))
        consumed = decode_rows + list(plan)
        if self.faults is not None:
            logits_all = self.faults.corrupt_logits("engine.logits",
                                                    logits_all, consumed)
        temps = self._temperatures()
        finite = None
        if self._guard:
            logits_all, finite = self._guarded(logits_all, temps)
        n_emit, emit = sampler.verify_batch(
            logits_all, self._tensor(toks), self._tensor(nv),
            self._tensor(ndraft), torch.from_numpy(temps).to(self.device),
            self.generator)
        bad: List[int] = []
        if finite is None:
            n_emit, emit = n_emit.cpu().numpy(), emit.cpu().numpy()
        else:
            # one copy to the host: accepted counts, tokens, lane flags
            host = torch.cat([n_emit[:, None], emit, finite.to(emit.dtype)],
                             dim=1).cpu().numpy()
            n_emit, emit = host[:, 0], host[:, 1:1 + W]
            bad = self._nonfinite_rows(host[:, 1 + W:], consumed, nv, ndraft)
        self._quarantine_rows(bad)
        # prefill rows: emit[:, 0] is the sample at their last valid lane
        for slot, n in plan.items():
            if self.slots[slot] is None:       # quarantined this step
                continue
            self._postprocess_prefill(slot, n, emit[:, 0])
        for slot in decode_rows:
            req = self.slots[slot]
            if req is None or req.stuck:
                continue
            self._postprocess_verify(slot, int(n_emit[slot]), emit[slot],
                                     int(ndraft[slot]))
        return True
