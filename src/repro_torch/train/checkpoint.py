"""Checkpoints in the reference's byte format (port of
``repro/train/checkpoint.py``).

A checkpoint is one msgpack map ``{"step": int, "arrays": {path: {"d":
dtype, "s": shape, "b": raw bytes}}}``, each array keyed by its path in
the reference's parameter tree, joined by ``/`` (``scan/0/attn/wq``),
bfloat16 stored as its ``uint16`` bits under ``"d": "bfloat16"``.  The
port writes the same bytes as the reference for the same tree, so a
checkpoint written by either package loads in the other; the model's
state goes through ``bridge.reference_tree`` (each repeated unit's layers
stacked into one leaf).

msgpack itself is not a dependency: the encoder and decoder below cover
the subset the format uses (map, str, int, list, bin) and encode as
``msgpack.packb(..., use_bin_type=True)`` does, with the smallest form
of each value.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.bridge import reference_groups, reference_tree, unstacked

# ---------------------------------------------------------------------------
# msgpack subset
# ---------------------------------------------------------------------------


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < top:
                out += bytes([code]) + struct.pack(fmt, n)
                return
        raise OverflowError(n)
    else:
        for code, fmt, bot in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)),
                               (0xD3, ">q", -(1 << 63))):
            if n >= bot:
                out += bytes([code]) + struct.pack(fmt, n)
                return
        raise OverflowError(n)


def _pack_len(n: int, fix: int, fix_max: int, codes, out: bytearray) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` ((code, struct format, limit)) that holds ``n``."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in codes:
        if n < top:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise OverflowError(n)


def _pack(obj: Any, out: bytearray) -> None:
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"{obj!r} is outside the checkpoint format")
    if isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, ((0xD9, ">B", 1 << 8),
                                      (0xDA, ">H", 1 << 16),
                                      (0xDB, ">I", 1 << 32)), out)
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), None, 0, ((0xC4, ">B", 1 << 8),
                                      (0xC5, ">H", 1 << 16),
                                      (0xC6, ">I", 1 << 32)), out)
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, ((0xDC, ">H", 1 << 16),
                                      (0xDD, ">I", 1 << 32)), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, ((0xDE, ">H", 1 << 16),
                                      (0xDF, ">I", 1 << 32)), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"{type(obj).__name__} is outside the checkpoint "
                        "format")


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj`` (dicts, str, int, lists, bytes)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_ARR = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}


def _unpack(buf: bytes, i: int) -> Tuple[Any, int]:
    c = buf[i]
    i += 1

    def read(fmt):
        n = struct.calcsize(fmt)
        return struct.unpack(fmt, buf[i:i + n])[0], i + n

    if c < 0x80:
        return c, i
    if c >= 0xE0:
        return c - 0x100, i
    if c in _FIXED:
        return read(_FIXED[c])
    if 0xA0 <= c < 0xC0 or c in _STR:
        n, i = (c & 0x1F, i) if c < 0xC0 else read(_STR[c])
        return buf[i:i + n].decode("utf-8"), i + n
    if c in _BIN:
        n, i = read(_BIN[c])
        return bytes(buf[i:i + n]), i + n
    if 0x90 <= c < 0xA0 or c in _ARR:
        n, i = (c & 0x0F, i) if c < 0xA0 else read(_ARR[c])
        items = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            items.append(v)
        return items, i
    if 0x80 <= c < 0x90 or c in _MAP:
        n, i = (c & 0x0F, i) if c < 0x90 else read(_MAP[c])
        d = {}
        for _ in range(n):
            k, i = _unpack(buf, i)
            d[k], i = _unpack(buf, i)
        return d, i
    raise ValueError(f"msgpack type byte {c:#x} is outside the checkpoint "
                     "format")


def unpackb(buf: bytes) -> Any:
    obj, i = _unpack(buf, 0)
    if i != len(buf):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


# ---------------------------------------------------------------------------
# trees of arrays
# ---------------------------------------------------------------------------

def _leaves(tree: Any, prefix: Tuple = ()):
    """(path, leaf) in the reference's flattening order: dict keys sorted,
    sequences in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _record(leaf) -> Dict:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().view(np.uint16)
            return {"d": "bfloat16", "s": list(t.shape),
                    "b": bits.tobytes()}
        a = t.numpy()
    else:
        a = np.ascontiguousarray(leaf)
        if a.dtype.name == "bfloat16":
            return {"d": "bfloat16", "s": list(a.shape),
                    "b": a.view(np.uint16).tobytes()}
    return {"d": a.dtype.str, "s": list(a.shape), "b": a.tobytes()}


def _tensor(rec: Dict) -> torch.Tensor:
    if rec["d"] == "bfloat16":
        a = np.frombuffer(rec["b"], np.int16).reshape(rec["s"])
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    a = np.frombuffer(rec["b"], np.dtype(rec["d"])).reshape(rec["s"])
    return torch.from_numpy(a.copy())


def save(path: str, tree: Any, step: int = 0) -> None:
    """Write ``tree`` (dicts, lists and tuples of torch tensors or numpy
    arrays) to ``path``, atomically."""
    flat = {_path_str(p): _record(leaf) for p, leaf in _leaves(tree)}
    payload = {"step": step, "arrays": flat}
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(packb(payload))
    os.replace(tmp, path)


def restore(path: str, like: Any) -> Tuple[Any, int]:
    """``like``'s structure with each leaf read from ``path`` (CPU torch
    tensors in the stored dtype), and the stored step."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    arrays = payload["arrays"]

    def rebuild(node, prefix):
        if isinstance(node, dict):
            return {k: rebuild(v, prefix + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, prefix + (i,))
                              for i, v in enumerate(node))
        if node is None:
            return None
        return _tensor(arrays[_path_str(prefix)])

    return rebuild(like, ()), payload["step"]


def save_model(path: str, model, step: int = 0) -> None:
    """The model's parameters in the reference's tree: the file the
    reference's ``ckpt.save(path, params, step)`` writes for the same
    weights."""
    save(path, reference_tree(model.state_dict(), model.cfg), step)


@torch.no_grad()
def restore_model(path: str, model) -> int:
    """Load a checkpoint of the reference's parameter tree into ``model``
    (written by either package); returns its step."""
    state = model.state_dict()
    tree, step = restore(path, reference_tree(state, model.cfg))
    leaves = dict(_leaves(tree))
    for p, names in reference_groups(state.keys(), model.cfg).items():
        for name, part in unstacked(leaves[p], names).items():
            if part.shape != state[name].shape:
                raise ValueError(f"{_path_str(p)}: stored "
                                 f"{tuple(part.shape)}, model "
                                 f"{tuple(state[name].shape)}")
            state[name].copy_(part.to(state[name].dtype))
    return step
