"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries go
to ``build/kernels/`` at the root of the checkout, named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  ``build()`` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = {"paged_decode": "paged_decode.cu",
           "paged_extend": "paged_extend.cu",
           "decode_attention": "decode_attention.cu",
           "flash_attention": "flash_attention.cu",
           "mamba_scan": "mamba_scan.cu",
           "rglru_scan": "rglru_scan.cu"}
HEADERS = ("paged_common.cuh", "flash_tc.cuh")

# Kernel launches per kernel since the last reset: each wrapper adds one
# where it launches its kernel, and nowhere else.
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures:
#   paged_*:    (dtype, q, kp, vp, ks, kz, vs, page_table, pos, out,
#                part, B, [Sx,] K, G, hd, ps, NP, window, splits, stream)
#   decode_attention: (dtype, q, k, v, ks, kz, vs, tok, pos, out, part,
#                B, K, G, hd, C, window, splits, stream)
#   flash_attention:  (dtype, q, k, v, lengths, out, B, K, G, hd, S,
#                window, stream)
#   mamba_scan: (x_dtype, dt, Bm, Cm, x, A, Dsk, h0, y, h, B, S, D, N,
#                stream)
#   rglru_scan: (a, b, h0, hs, h, B, S, W, stream)
_ARGTYPES = {
    "paged_decode": [_I] + [_P] * 10 + [_I] * 8 + [_P],
    "paged_extend": [_I] + [_P] * 10 + [_I] * 9 + [_P],
    "decode_attention": [_I] + [_P] * 10 + [_I] * 7 + [_P],
    "flash_attention": [_I] + [_P] * 5 + [_I] * 6 + [_P],
    "mamba_scan": [_I] + [_P] * 9 + [_I] * 4 + [_P],
    "rglru_scan": [_P] * 5 + [_I] * 3 + [_P],
}
_FNS: Dict[str, ctypes._CFuncPtr] = {}
_ERR: Dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, str]:
    """Compile every named kernel library that is not built yet, one
    ``nvcc`` process per source, all started together.  Returns each
    kernel's compiler log (``-Xptxas -v``: registers, shared memory,
    spills), kept beside its library.  Raises if a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        so = _library_path(name)
        if not so.exists():
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / SOURCES[name])]
            running[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so, tmp)
    for name, (proc, so, tmp) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCES[name]}:\n{log}")
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)
    return {name: _library_path(name).with_suffix(".log").read_text()
            for name in names}


def _function(name: str):
    fn = _FNS.get(name)
    if fn is None:
        build([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        err = lib.cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _FNS[name], _ERR[name] = fn, err
    return fn


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C launcher with ``args`` (pointers and ints,
    the stream last) and count the launch; raises if the launch failed."""
    err = _function(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({_ERR[name](err).decode()})")
    LAUNCHES[name] += 1


# Kernel dtype codes: (activation dtype of q, pool dtype) -> C dtype.
DTYPE_CODES = {
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.bfloat16): 1,
    (torch.float32, torch.int8): 2,
    (torch.bfloat16, torch.int8): 3,
}
HEAD_DIMS = (32, 64, 128, 256)
MAX_SMEM_BYTES = 232448                 # opt-in shared memory of a block


def stage_slots(hd: int) -> int:
    """Slots of one stage of the page walk (``paged::stage_slots``):
    4096 / hd, but at least 32 so a stage splits into one slot a lane."""
    return max(32, 4096 // hd)


MAX_DECODE_G = 16      # query heads per group a decode block holds


def decode_rows(G: int) -> int:
    """Query rows of a paged or ring decode block (``by_rows`` in
    ``paged_decode.cu`` and ``decode_attention.cu``)."""
    return 4 if G <= 4 else 8 if G <= 8 else 16


SMS = 132              # streaming multiprocessors of an H100 SXM


def ring_splits(B: int, K: int, C: int, hd: int) -> int:
    """Segments a ring-decode row (request, kv head) is split into, one
    block each (``decode_attention.cu``): about two blocks per SM over the
    B * K rows, but at least one stage of slots a segment."""
    want = -(-2 * SMS // (B * K))
    return max(1, min(want, C // stage_slots(hd)))


def paged_splits(B: int, K: int, tiles: int, n_slots: int, hd: int) -> int:
    """Segments the attendable range of each (request, kv head, row tile)
    of a paged kernel is split into, one block each (``paged_decode.cu``,
    ``paged_extend.cu``): about two blocks per SM over the B * K * tiles
    tiles, never more than the stages in a table of ``n_slots`` slots.  A
    function of the shapes only: the kernels read the positions on the
    device and split each tile's own range into whole stages."""
    want = -(-2 * SMS // (B * K * tiles))
    return max(1, min(want, n_slots // stage_slots(hd)))


def partials_shape(B: int, K: int, rows: int, hd: int, splits: int) -> tuple:
    """Float scratch of a split walk: each split's unnormalized (acc [hd],
    m, l) for each of the ``rows`` query rows of a (request, kv head) (G
    for decode, Sx * G for extend)."""
    return (B, K, splits, rows, hd + 2)


TC_CODES = (1, 3)      # bf16 q: paged extend runs on the tensor cores
TC_ROWS = 64           # query rows of a warpgroup (wgmma's M)


def key_tile(hd: int) -> int:
    """Slots of a tensor-core key tile (``flash_tc::key_tile``)."""
    return 32 if hd == 256 else 64


def extend_rows(hd: int, rows: int, code: int) -> int:
    """Query rows of a paged-extend block for ``rows`` = Sx * G rows of a
    (request, kv head): bf16 q (``TC_CODES``) 64 (one warpgroup) up to 64
    rows and 128 (two) above; float32 q 1024 / hd, 16 at hd 256
    (``paged_extend.cu``)."""
    if code in TC_CODES:
        return TC_ROWS if rows <= TC_ROWS else 2 * TC_ROWS
    return 16 if hd == 256 else 1024 // hd


def smem_bytes(hd: int, rows: int, n_table: int) -> int:
    """Dynamic shared memory of a staged-walk block (``paged::smem_bytes``):
    q rows, one stage of K and V slots, its probabilities, and the walk's
    table (a page-table row, or a ring's slot list)."""
    slots = stage_slots(hd)
    return 4 * (rows * hd + slots * (hd + 4) + slots * hd + rows * slots
                + 2 * rows) + 4 * n_table


def tc_smem_bytes(hd: int, rows: int, n_table: int) -> int:
    """Dynamic shared memory of a tensor-core paged-extend block
    (``paged_extend.cu::tc_smem_bytes``): bf16 Q rows, two stages of K and
    V key tiles with a byte a slot of flags, and the page-table row."""
    return (2 * hd * (rows + 2 * 2 * key_tile(hd)) + 2 * key_tile(hd)
            + 4 * n_table)


def check_smem(nbytes: int, n_table: int) -> None:
    """ValueError when a block would need more than the card's shared
    memory, which only a long table can make it."""
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(f"a table of {n_table} entries is too long for one "
                         "block")


def check_operands(kind: str, tensors, q) -> None:
    """Every operand on q's CUDA device and contiguous, or ValueError."""
    for t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{kind} kernels take CUDA tensors on one "
                             "device")
        if not t.is_contiguous():
            raise ValueError(f"{kind} kernels take contiguous tensors")


def check_kv_inputs(kind: str, q, k, v, index, pos, k_scale, k_zero,
                    v_scale, rows_shape) -> int:
    """Validate the operands of a paged or ring attention launch; returns
    the dtype code.  ``q`` is [B, ..., K, G, hd]; K/V are ``rows_shape +
    (K, hd)`` (pools [P, ps] or rings [B, C]) with ``[*rows_shape, K]``
    float32 sidecars in int8 mode; ``index`` is the [B, n] int32 page
    table or ring tokens.  Raises ValueError on anything the kernels do
    not take (the caller checks the block's shared memory,
    ``check_smem``)."""
    tensors = [q, k, v, index, pos]
    quant = k_scale is not None
    if quant != (k_zero is not None) or quant != (v_scale is not None):
        raise ValueError("k_scale, k_zero and v_scale come together")
    if quant:
        tensors += [k_scale, k_zero, v_scale]
    check_operands(kind, tensors, q)
    code = DTYPE_CODES.get((q.dtype, k.dtype))
    if code is None or v.dtype != k.dtype or (code >= 2) != quant:
        raise ValueError(f"unsupported dtypes q={q.dtype} "
                         f"kv={k.dtype} quantized={quant}")
    if index.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("page tables, tokens and positions must be int32")
    B, K, G, hd = q.shape[0], q.shape[-3], q.shape[-2], q.shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if k.shape != (*rows_shape, K, hd) or v.shape != k.shape:
        raise ValueError(f"K/V shape {tuple(k.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if quant and any(s.shape != (*rows_shape, K) or s.dtype != torch.float32
                     for s in (k_scale, k_zero, v_scale)):
        raise ValueError(f"scale sidecars must be float32 "
                         f"{[*rows_shape, K]}")
    if index.dim() != 2 or index.shape[0] != B or pos.shape != (B,):
        raise ValueError("page_table / tok must be [B, n] and positions [B]")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("K/V must be 16-byte aligned")
    return code


def pointer(t) -> int:
    """Device address of a tensor, or 0 for an absent operand."""
    return 0 if t is None else t.data_ptr()
