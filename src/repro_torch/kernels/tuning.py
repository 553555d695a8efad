"""Tuned launch parameters of the split walks, per card and shape bucket.

Port of ``repro/kernels/tuning.py``.  Three kernels split the walk of
each (request, kv head, row tile) across blocks and add the splits with a
combine: paged decode (``paged_attention.py``), paged extend
(``paged_extend.py``) and ring decode (``decode_attention.py``, table key
``decode``, the reference's name).  How many splits is a trade of blocks
in flight against the combine's work, and the right count depends on the
card and the shape.  The wrappers take it from :func:`splits`: a
COMMITTED per-(kernel, card, shape-bucket) table, ``tuning_table.json``,
read once on the host, else the heuristic the wrappers used before the
table (``cuda_lib.paged_splits`` / ``cuda_lib.ring_splits``: about two
blocks per SM, from the shapes only).  So a missing table, or a shape the
sweep did not tune, gives exactly the heuristic's count.

Table layout::

    { kernel: { backend: { shape_key: {"params": {"splits": n},
                                       "us": measured, "heuristic_us": ...,
                                       "model_us": bound, "device": ...,
                                       "power_limit_w": ...} } } }

``backend`` is the card's name as ``torch.cuda.get_device_name`` gives it,
normalised (``nvidia_h100_80gb_hbm3``), or ``cpu``; there is no ``any``
fallback, because an entry is a measurement on one card.  ``shape_key``
buckets each dimension the heuristic reads to the next power of two (the
batch ``b``, kv heads ``k``, row ``tiles`` of paged extend, the ``slots``
of the page table or ring, ``hd``), never a position: the count fixes the
shape of the partials scratch (``cuda_lib.partials_shape``), so a CUDA
graph and its replays must get the same count.  A table count is clamped
to ``[1, slots // stage_slots(hd)]``, as the heuristic's is.

Where the reference's parameters went: flash's ``bq`` / ``bk`` are the
port's compiled tiles (128 query rows a block, ``cuda_lib.key_tile`` keys;
``flash_tc.cuh``), ring decode's ``bk`` and paged extend's
``pages_per_block`` are the staged walk's stage (``cuda_lib.stage_slots``,
compiled into ``paged_common.cuh``), and paged extend's ``bq`` is
``cuda_lib.extend_rows`` (one or two wgmma warpgroups, or 1024 / hd rows
in float32), all fixed at build time.  The flash backward's head groups
(``cuda_lib.bwd_splits``) stay in code too: their ``max_group`` is an
accuracy limit of the float32 body, not a speed choice.  What the table
tunes is the split count of the three split walks, and nothing else.

Regenerate on a card with ``python3 scripts/tune_splits.py`` (it times
each candidate count in turns with the heuristic's and keeps only counts
that win by more than the spread), which records beside each winner the
roofline bound of its shape (:func:`extend_cost_model_us` and the two
decode models), over the H100 peaks of ``repro_torch/launch/mesh.py``.
"""
from __future__ import annotations

import functools
import json
import os
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_FP32

TABLE_PATH = os.path.join(os.path.dirname(__file__), "tuning_table.json")

# The tunable parameters of each kernel; None means the heuristic's count.
DEFAULTS: Dict[str, Dict] = {
    "paged_decode": {"splits": None},
    "paged_extend": {"splits": None},
    "decode": {"splits": None},
}

# kernel -> the heuristic's count from its shape key's dims
HEURISTICS = {
    "paged_decode": lambda b, k, slots, hd: cuda_lib.paged_splits(
        b, k, 1, slots, hd),
    "paged_extend": lambda b, k, tiles, slots, hd: cuda_lib.paged_splits(
        b, k, tiles, slots, hd),
    "decode": lambda b, k, slots, hd: cuda_lib.ring_splits(b, k, slots, hd),
}

_cache: Optional[Dict] = None


@functools.lru_cache(maxsize=None)
def _device_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def backend_key(device: Union[None, str, torch.device] = None) -> str:
    """The table's key for ``device``'s kind: the normalised card name
    (``nvidia_h100_80gb_hbm3``), or ``cpu``.  None is the current CUDA
    device where there is one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return "".join(c if c.isalnum() else "_"
                   for c in _device_name(index).lower())


def _bucket(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def shape_key(**dims) -> str:
    """Stable pow2-bucketed key, e.g. ``b8_hd64_k4_slots2048``."""
    return "_".join(f"{k}{_bucket(int(v))}" for k, v in sorted(dims.items()))


def _check(table: Dict) -> Dict:
    """ValueError unless every kernel is one this module tunes and every
    entry's params name only that kernel's parameters, with a positive
    integer count."""
    for kernel, backends in table.items():
        if kernel not in DEFAULTS:
            raise ValueError(f"tuning table: unknown kernel {kernel!r} "
                             f"(tunable: {sorted(DEFAULTS)})")
        for be, entries in backends.items():
            for key, entry in entries.items():
                params = entry.get("params", {})
                extra = set(params) - set(DEFAULTS[kernel])
                if extra:
                    raise ValueError(f"tuning table: {kernel}/{be}/{key} "
                                     f"names {sorted(extra)}, not in "
                                     f"{sorted(DEFAULTS[kernel])}")
                n = params.get("splits")
                if n is not None and (not isinstance(n, int)
                                      or isinstance(n, bool) or n < 1):
                    raise ValueError(f"tuning table: {kernel}/{be}/{key} "
                                     f"splits must be a positive int, got "
                                     f"{n!r}")
    return table


def load_table(refresh: bool = False) -> Dict:
    """The table at ``TABLE_PATH`` (empty where there is no file), read
    once and checked; ``refresh`` reads it again."""
    global _cache
    if _cache is None or refresh:
        _splits.cache_clear()
        if os.path.exists(TABLE_PATH):
            with open(TABLE_PATH) as f:
                _cache = _check(json.load(f))
        else:
            _cache = {}
    return _cache


def lookup(kernel: str, device: Union[None, str, torch.device] = None,
           **dims) -> Dict:
    """Best-known params for ``kernel`` at this shape on ``device``'s
    backend; always the full param dict (defaults fill gaps; ``{}`` for a
    kernel this module does not tune)."""
    entry = load_table().get(kernel, {}).get(backend_key(device), {})
    out = dict(DEFAULTS.get(kernel, {}))
    out.update(entry.get(shape_key(**dims), {}).get("params", {}))
    return out


def splits(kernel: str, device: Union[str, torch.device],
           **dims) -> Tuple[int, str]:
    """``(count, source)``: the split count a wrapper launches ``kernel``
    with at these dims on ``device``, from the table (``"table"``, clamped
    to the heuristic's range) or from the heuristic (``"heuristic"``).
    Resolved once a (kernel, device, dims) on the host, so every launch
    at a shape, captured or not, gets the same count."""
    return _splits(kernel, torch.device(device), tuple(sorted(dims.items())))


@functools.lru_cache(maxsize=None)
def _splits(kernel: str, device: torch.device, dims: tuple):
    dims = dict(dims)
    n = lookup(kernel, device, **dims)["splits"]
    if n is None:
        return HEURISTICS[kernel](**dims), "heuristic"
    most = dims["slots"] // cuda_lib.stage_slots(dims["hd"])
    return max(1, min(n, most)), "table"


def record(kernel: str, key: str, params: Dict, *, us: float,
           model_us: float, backend: Optional[str] = None,
           path: Optional[str] = None, **meta) -> None:
    """Write one sweep winner into the table at ``path`` (``TABLE_PATH``
    by default, which is then read again) with its measurement metadata
    (``heuristic_us``, ``device``, ``power_limit_w``, ...)."""
    path = path or TABLE_PATH
    table = {}
    if os.path.exists(path):
        with open(path) as f:
            table = _check(json.load(f))
    be = backend or backend_key()
    table.setdefault(kernel, {}).setdefault(be, {})[key] = {
        "params": params, "us": round(us, 3), "model_us": round(model_us, 3),
        **meta}
    _check(table)
    with open(path, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    if path == TABLE_PATH:
        load_table(refresh=True)


def _bound_us(nbytes: float, flops: float, dtype: torch.dtype) -> float:
    peak = PEAK_FLOPS_FP32 if dtype == torch.float32 else PEAK_FLOPS_BF16
    return max(flops / peak, nbytes / HBM_BW) * 1e6


def extend_cost_model_us(*, B: int, Sx: int, K: int, G: int, hd: int,
                         ctx: int, quant: bool = False, NP: int = 0,
                         dtype: torch.dtype = torch.float32) -> float:
    """Two-term roofline for one paged-extend call (page-read-once), the
    reference's: bytes = each of the ``ctx`` mapped KV slots of a row ONCE
    (int8 with its three float32 sidecars when ``quant``) + q/out, flops =
    QK^T + PV of every lane over ``ctx`` slots; here with ``dtype``'s
    element size and peak (bf16 989, float32 67 TFLOP/s) and the
    [B, NP] page table and [B] positions the kernel reads, so that it is
    the bound ``chip_smoke.py`` prints for a batch whose every lane sees
    the same ``ctx`` slots."""
    item = torch.empty((), dtype=dtype).element_size()
    kv_bytes = 2 * B * ctx * K * hd * (1 if quant else item)
    if quant:
        kv_bytes += 3 * B * ctx * K * 4                    # scale sidecars
    io_bytes = 2 * B * Sx * K * G * hd * item              # q + out
    flops = 2 * 2 * B * Sx * K * G * hd * ctx              # QK^T + PV
    return _bound_us(kv_bytes + io_bytes + 4 * B * (NP + 1), flops, dtype)


def paged_decode_cost_model_us(*, B: int, K: int, G: int, hd: int,
                               ctx: int, quant: bool = False, NP: int = 0,
                               dtype: torch.dtype = torch.float32) -> float:
    """The paged decode walk's roofline: one query lane a request, the
    same form as :func:`extend_cost_model_us` at ``Sx = 1``."""
    return extend_cost_model_us(B=B, Sx=1, K=K, G=G, hd=hd, ctx=ctx,
                                quant=quant, NP=NP, dtype=dtype)


def decode_cost_model_us(*, B: int, K: int, G: int, hd: int, ctx: int,
                         C: int, quant: bool = False,
                         dtype: torch.dtype = torch.float32) -> float:
    """The ring decode walk's roofline, of the same form: ``ctx`` valid
    slots a row read once from a ring of ``C``, whose [B, C] token list
    is read whole, + q/out and the [B] positions; QK^T + PV over the
    ``ctx`` slots.  (Its exponentials, G * K * ctx a row over the SMs'
    special-function rate, stay below the bytes term at every head dim
    the kernel takes.)"""
    item = torch.empty((), dtype=dtype).element_size()
    kv_bytes = 2 * B * ctx * K * hd * (1 if quant else item)
    if quant:
        kv_bytes += 3 * B * ctx * K * 4
    io_bytes = 2 * B * K * G * hd * item
    flops = 2 * 2 * B * K * G * hd * ctx
    return _bound_us(kv_bytes + io_bytes + 4 * B * (C + 1), flops, dtype)
