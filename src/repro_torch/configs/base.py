"""Configuration dataclasses for models and serving.

A copy of the reference package's ``configs/base.py``: ``ModelConfig``,
the assigned input shapes (``ShapeConfig``, ``SHAPES``,
``LONG_CONTEXT_WINDOW``), ``TrainConfig``, ``ServeConfig`` and the block
patterns ``dense_pattern``, ``moe_pattern``, ``mamba_pattern`` and
``recurrentgemma_pattern``.
Field names, defaults and meanings are unchanged, so a config built for
one package reads the same in the other.  ``ServeConfig.mesh`` places the
engine on a ``torch.distributed`` device mesh (launch/mesh.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture definition.

    ``block_pattern`` lists the residual-block type of every layer in order;
    supported types: ``attn``, ``moe``, ``mamba``, ``rglru``, ``rg_attn``
    (RecurrentGemma local-attention block).  The transformer groups the
    pattern into scanned stages automatically.
    """

    name: str
    arch_type: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    block_pattern: Tuple[str, ...]

    # attention details
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # None = full causal attention
    local_window: int = 2048               # RecurrentGemma local-attn window
    mlp_act: str = "swiglu"                # swiglu | relu2 | gelu

    # mixture-of-experts
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # state-space (mamba-1)
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0                   # 0 -> ceil(d_model/16)

    # RG-LRU (hybrid)
    rnn_width: int = 0                     # 0 -> d_model

    # encoder-decoder (audio) / vlm frontend stubs
    encoder_layers: int = 0
    encoder_seq: int = 1500                # precomputed frame embeddings
    num_patches: int = 256                 # precomputed patch embeddings

    # numerics
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"                # activation dtype
    param_dtype: str = "float32"           # storage dtype (bf16 for mega archs)
    # KV-cache storage dtype: "model" stores K/V in the activation dtype
    # (bit-identical baseline); "int8" quantizes at write time with
    # per-slot-per-head scales (asymmetric K, symmetric V — see
    # kernels/kv_quant.py) and dequantizes at read, ~3.5-4x smaller
    # resident KV.  ServeConfig.kv_dtype overrides this per engine.
    kv_dtype: str = "model"
    tie_embeddings: bool = False

    # Megatron-style sequence parallelism: residual stream sharded along
    # seq over the 'model' axis between blocks (mega-archs only).
    shard_seq_activations: bool = False

    # citation for the public pool entry
    source: str = ""

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def lru_width(self) -> int:
        return self.rnn_width or self.d_model

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def dense_pattern(n: int) -> Tuple[str, ...]:
    return ("attn",) * n


def moe_pattern(n: int) -> Tuple[str, ...]:
    return ("moe",) * n


def mamba_pattern(n: int) -> Tuple[str, ...]:
    return ("mamba",) * n


def recurrentgemma_pattern(n: int) -> Tuple[str, ...]:
    """RecurrentGemma interleaves recurrent and local-attention blocks 2:1."""
    pat = []
    while len(pat) < n:
        pat.extend(["rglru", "rglru", "rg_attn"])
    return tuple(pat[:n])


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                              # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The four assigned input shapes.
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# Sliding-window used when a full-attention arch runs long_500k.
LONG_CONTEXT_WINDOW = 8_192


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    optimizer: str = "adamw"               # adamw | adafactor
    microbatch: int = 0                    # 0 = no gradient accumulation
    remat: bool = True
    z_loss: float = 1e-4
    loss_chunk: int = 0                    # 0 = unchunked cross-entropy
    seed: int = 0


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_seq: int = 2048
    # One page granularity for the whole serving stack: KV page-pool pages
    # AND prefix-cache snapshot boundaries (they must agree — snapshots pin
    # whole pages).
    page_size: int = 256
    prefix_cache: bool = True
    # ---- paged KV cache (docs/SERVING.md) ---------------------------------
    # Shared page pool + per-request page tables replacing the dense
    # [B, C] ring caches: memory proportional to UNIQUE tokens (best-of-N
    # fan-out and reflection rounds share physical prefix pages), O(1)
    # zero-copy prompt-cache snapshots, preemption + requeue on
    # exhaustion.  False restores the ring caches (A/B baseline; also the
    # fallback for models without a paged cache layout, e.g. whisper).
    paged_kv: bool = True
    # Physical pages in the pool.  0 = auto: max_batch * ceil(max_seq /
    # page_size) — enough that no request mix can deadlock; set lower to
    # trade memory for preemptions, higher to keep more snapshots pinned.
    num_pages: int = 0
    # KV-cache storage dtype for this engine: None inherits
    # ModelConfig.kv_dtype; "model" pins the fp baseline (bit-identical
    # to unquantized serving); "int8" quantizes K/V pages at write time
    # (per-slot-per-head scales travel with their pages through COW
    # copies and snapshot pins).  Accuracy caveat + A/B recipe:
    # docs/SERVING.md#quantized-kv-cache-int8.
    kv_dtype: Optional[str] = None
    # Paged-attention READ implementation: "pallas" walks page tables
    # with the fused extend/verify + decode kernels (page-read-once, no
    # dense pool copy); "xla" densifies via the gather path (the parity
    # reference, and the only fast option off-TPU — Pallas interpret
    # mode is orders of magnitude slower).  None = auto: pallas on TPU,
    # xla elsewhere.  Greedy outputs are token-identical either way
    # (tests/test_paged_extend.py pins this).  docs/SERVING.md.
    attn_impl: Optional[str] = None
    max_think_tokens_low: int = 1024       # paper's "low" thinking budget
    max_think_tokens_high: int = 4096      # paper's "high" thinking budget
    temperature: float = 0.0
    seed: int = 0

    # ---- mesh-sharded serving ----------------------------------------------
    # Device mesh for the engine as a "DxM" string (data x model), e.g.
    # "1x2": params get the tensor-parallel rules (launch/rules.serve_rules),
    # the paged KV pool + int8 scale sidecars shard by physical page along
    # 'model'.  None = single-device.  "1x1" starts a one-process group by
    # itself; a mesh of D*M > 1 needs that many ranks already in the
    # default process group (torchrun --nproc-per-node D*M; CPU only:
    # launch/mesh.py, launch/serve.py --mesh).
    mesh: Optional[str] = None
    # Startup AOT compilation: lower + compile every step executable the
    # serve loop can hit (decode, each mixed prefill+decode bucket width,
    # spec-verify, COW page-copy) before the first request, maxtext-style.
    # After warmup Engine.stats()["step_compiles"] must stay 0 — the
    # recompile tripwire (tests/test_engine_fuzz.py).
    aot_warmup: bool = False
    # Extra mixed-step lane widths to pre-compile besides prefill_chunk;
    # at runtime each mixed step picks the smallest bucket that fits the
    # planned chunks (padding with idle lanes), so prefill bursts of any
    # size hit a warmed executable.  () = single-width legacy behavior.
    prefill_buckets: Tuple[int, ...] = ()

    # ---- SLO-aware admission (docs/SERVING.md#slo-routing) ---------------
    # Pricing model (core/accounting.py PAPER_PRICES/PAPER_LATENCY key)
    # used to convert a queued request's predicted tokens into dollars /
    # seconds and check them against the request's own ceilings
    # (Request.max_cost_usd / max_latency_s): a fresh request whose
    # remaining ceiling cannot fund its predicted tokens is FINALIZED
    # (stop_reason "slo", empty output) instead of occupying a slot —
    # its pages and step budget go to requests that can still finish
    # inside their SLOs.  None disables the check entirely
    # (bit-identical to pre-SLO behavior).
    slo_price_model: Optional[str] = None

    # ---- reliability (docs/SERVING.md#reliability) ------------------------
    # Runtime deadline enforcement: at every step boundary, finalize any
    # queued or in-flight request whose max_latency_s has elapsed since
    # submit() (stop_reason "timeout", pages refcount-released, billing
    # frozen at the committed watermark).  Time comes from the engine's
    # clock — time.monotonic by default, or a FaultPlan's VirtualClock
    # when one is installed, so chaos tests never sleep.
    enforce_deadlines: bool = False
    # Quarantine rows whose logits come back NaN/Inf: the row's commit is
    # skipped and the request replays through the PR-2 preemption path
    # (billed_prefill watermark → no double billing), up to
    # nan_retry_limit times, after which it finalizes with stop_reason
    # "error".  Off by default: the per-step finiteness check costs a
    # device->host sync on the hot path.
    nan_quarantine: bool = False
    nan_retry_limit: int = 2
    # Stall detector: if no slot makes progress (token commit, prefill
    # advance, admission) for this many consecutive steps while rows are
    # in flight, finalize the stuck rows with stop_reason "stalled"
    # instead of silently spinning to run(max_steps).  0 disables.
    stall_limit: int = 0

    # ---- chunked-prefill scheduler (docs/SERVING.md) ----------------------
    # Lane width of the mixed prefill+decode step: every scheduler tick
    # processes a [max_batch, prefill_chunk] token block; a decoding row
    # occupies one lane, a prefilling row up to prefill_chunk lanes.
    prefill_chunk: int = 32
    # Max fresh prefill tokens admitted into one mixed step, across all
    # rows.  This is the knob that bounds per-step work — and therefore
    # tail decode-step latency — while prompts stream in.
    prefill_token_budget: int = 64
    # Snapshot partial prefixes into the prefix cache at page-aligned
    # chunk boundaries (concurrent same-prompt requests hit mid-prefill).
    cache_prefill_chunks: bool = True

    # ---- self-speculative decoding (docs/SERVING.md) ----------------------
    # Draft-free speculation for decode rows: a host-side n-gram drafter
    # (serving/speculator.py) proposes up to ``spec_tokens`` continuation
    # tokens per row by prompt-lookup over the request's own context
    # (prompt + prior output + Request.spec_context), and one jitted
    # VERIFY step scores all 1+spec_tokens lanes in a single model call,
    # committing the longest accepted prefix plus one model-sampled
    # token.  Greedy output is bit-identical to non-speculative decode;
    # temperature rows use exact rejection sampling.  Auto-disabled for
    # recurrent-state models (mamba/RG-LRU state cannot be rolled back)
    # and for window-capped ring caches (a rejected lane's ring write
    # evicts a live token) — paged engines (the default) support every
    # attention/MoE arch.  Drafted lanes count against
    # prefill_token_budget (and are trimmed so prefilling rows always
    # keep >= 1 budget token), bounding per-step work without starving
    # prefill.  A larger budget leaves more room for full-length drafts
    # alongside prefill chunks.
    spec_decode: bool = False
    # Max drafted tokens per decode row per verify step (the verify step
    # is a fixed [max_batch, 1 + spec_tokens] compiled shape).
    spec_tokens: int = 4
    # Longest / shortest suffix n-gram the drafter tries to match.
    spec_ngram: int = 3
    spec_ngram_min: int = 1
