"""Weight bridge from the JAX package's parameter tree to the port.

``params_from_jax`` takes the tree ``TransformerLM.init`` builds in
``repro`` — already converted to numpy arrays by the caller, so this
module needs no JAX — and returns a ``state_dict`` for the port's
``TransformerLM``.  The port keeps the reference's weight layouts
(``wq [d, H, hd]``, ``wo [H, hd, d]``, ``wi [d, ff]``, ...), so each leaf
is a copy.  The one structural change: the reference stacks the repeating
layer unit along a leading ``layers`` axis under ``params["scan"]`` (a
tuple over the unit's positions), followed by unstacked ``params["tail"]``
blocks; here every layer is its own ``blocks.<i>`` module, for any mix of
attention, mamba and RG-LRU blocks (recurrentgemma-9b: a stacked
(rglru, rglru, rg_attn) unit and a (rglru, rglru) tail).  Whisper's tree
stacks its encoder and decoder blocks under ``enc`` and ``dec`` (always
with the ``layers`` axis), which become ``enc.<i>`` and ``dec.<i>``
(``STACKS``).  Leaves keep their dtypes: mamba's ``A_log`` and ``D`` and
RG-LRU's ``lam`` stay float32 under bfloat16 parameters.

``params_to_jax`` is the inverse: the port's ``state_dict`` back in the
reference's tree, each ``scan`` leaf re-stacked from its layers.
``reference_groups`` lists, for each reference leaf, the port parameters
stacked into it, in stack order; the trainer's Adafactor
(``train/optimizer.py``), which factors and clips per reference leaf, and
the checkpoint (``train/checkpoint.py``) use it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

MAX_UNIT = 6
Path = Tuple[Any, ...]
# whisper's stacked block lists: every leaf under them has a leading
# ``layers`` axis, whatever the number of layers
STACKS = ("enc", "dec")


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            _flatten(v, f"{prefix}.{k}" if prefix else str(k), out)
    else:
        out[prefix] = np.asarray(tree)


def _unstack_blocks(scan: Any, tail: Any) -> List[Mapping]:
    """Per-layer block trees, in layer order, from the scan-stacked unit
    and the tail.  A unit repeated once is stored unstacked."""
    unit = list(scan)
    # every block kind has a leading RMSNorm: "ln1" (attention) or "ln"
    # (mamba, rglru); its scale is [d], or [repeats, d] when stacked
    norm = (np.asarray(unit[0].get("ln1", unit[0].get("ln"))["scale"])
            if unit else None)
    stacked = norm is not None and norm.ndim == 2
    repeats = norm.shape[0] if stacked else 1

    def layer(tree, r):
        if isinstance(tree, Mapping):
            return {k: layer(v, r) for k, v in tree.items()}
        return np.asarray(tree)[r] if stacked else tree

    blocks = [layer(unit[u], r) for r in range(repeats)
              for u in range(len(unit))]
    return blocks + list(tail)


def params_from_jax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> the port's ``state_dict``."""
    state: Dict[str, np.ndarray] = {}
    for name in ("embed", "unembed"):
        if name in params_np:
            state[name] = np.asarray(params_np[name])
    for name in ("ln_f", "enc_ln"):
        if name in params_np:
            _flatten(params_np[name], name, state)
    if "enc" in params_np:                              # whisper
        for name in STACKS:
            flat: Dict[str, np.ndarray] = {}
            _flatten(params_np[name], "", flat)
            for key, leaf in flat.items():
                for i in range(leaf.shape[0]):
                    state[f"{name}.{i}.{key}"] = leaf[i]
    else:
        for i, blk in enumerate(_unstack_blocks(params_np["scan"],
                                                params_np.get("tail", ()))):
            _flatten(blk, f"blocks.{i}", state)
    return {k: _tensor(v) for k, v in state.items()}


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A torch copy of a numpy leaf; bfloat16 leaves (numpy's ml_dtypes
    extension type, which torch cannot read) go through float32, which
    holds every bfloat16 value exactly."""
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(np.ascontiguousarray(a))


def find_unit(pattern: Tuple[str, ...]
              ) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """Minimal repeating unit + repeat count + unrolled tail: the
    reference's grouping of the layer pattern (``repro/models/
    transformer.py::find_unit``), copied."""
    best = (pattern, 1, ())
    best_covered = len(pattern)  # unit-len * 1
    for ulen in range(1, min(MAX_UNIT, len(pattern)) + 1):
        unit = pattern[:ulen]
        r = 1
        while pattern[:(r + 1) * ulen] == unit * (r + 1):
            r += 1
        covered = r * ulen
        if r >= 2 and (covered > best_covered or best[1] < 2):
            best = (unit, r, pattern[covered:])
            best_covered = covered
    if best[1] < 2:
        return pattern, 1, ()
    return best


def reference_groups(names, cfg) -> Dict[Path, List[str]]:
    """For each leaf of the reference's parameter tree (its path, a tuple
    of dict keys and sequence indices: ``("scan", 0, "attn", "wq")``), the
    port's parameter names stacked into it along the ``layers`` axis, in
    layer order; one name for an unstacked leaf.  ``names`` are the port's
    ``state_dict`` keys; the order of the result is the reference's
    flattening order (dict keys sorted, sequences in order)."""
    unit, repeats, tail = find_unit(tuple(cfg.block_pattern))
    groups: Dict[Path, List[str]] = {}
    for name in names:
        parts = name.split(".")
        if parts[0] in STACKS:
            path = (parts[0],) + tuple(parts[2:])
        elif parts[0] != "blocks":
            path = tuple(parts)
        else:
            i, keys = int(parts[1]), tuple(parts[2:])
            n_unit = len(unit) * repeats
            path = (("scan", i % len(unit)) if i < n_unit
                    else ("tail", i - n_unit)) + keys
        groups.setdefault(path, []).append(name)
    for path, members in groups.items():
        if path[0] in STACKS or (path[0] == "scan" and repeats > 1):
            members.sort(key=lambda n: int(n.split(".")[1]))
        elif len(members) != 1:
            raise ValueError(f"{path} maps to {members}")
    return dict(sorted(groups.items(), key=lambda kv: _sort_key(kv[0])))


def _sort_key(path: Path):
    return tuple((0, k) if isinstance(k, int) else (1, k) for k in path)


def is_stacked(names: List[str]) -> bool:
    """Does a group's reference leaf carry the ``layers`` axis: a
    repeated unit's leaf, or any leaf of whisper's ``enc``/``dec``."""
    return len(names) > 1 or names[0].split(".")[0] in STACKS


def stacked(state: Mapping[str, torch.Tensor],
            names: List[str]) -> torch.Tensor:
    """The reference leaf of a group: its members stacked along a new
    leading axis, or the one member itself."""
    if is_stacked(names):
        return torch.stack([state[n] for n in names])
    return state[names[0]]


def unstacked(leaf: torch.Tensor, names: List[str]) -> Dict[str, torch.Tensor]:
    """Inverse of ``stacked``: each member's slice of a reference leaf."""
    if is_stacked(names):
        return dict(zip(names, leaf.unbind(0)))
    return {names[0]: leaf}


def reference_tree(state: Mapping[str, torch.Tensor], cfg) -> Dict:
    """The port's ``state_dict`` as the reference's parameter tree (dicts,
    and tuples for ``scan`` and ``tail``) of torch tensors."""
    tree: Dict = {}
    for path, names in reference_groups(state.keys(), cfg).items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = stacked(state, names)
    return _tuples(tree)


def _tuples(node):
    """``scan`` and ``tail``'s index-keyed dicts -> tuples."""
    if not isinstance(node, dict):
        return node
    out = {k: _tuples(v) for k, v in node.items()}
    for k in ("scan", "tail"):
        if k in out:
            out[k] = tuple(out[k][i] for i in range(len(out[k])))
    return out


def params_to_jax(state: Mapping[str, torch.Tensor], cfg) -> Dict:
    """The port's ``state_dict`` -> the reference's parameter tree with
    numpy leaves (bfloat16 as ``ml_dtypes.bfloat16``, the type JAX
    gives numpy): the inverse of ``params_from_jax``."""
    tree = reference_tree(state, cfg)
    if "tail" not in tree and "enc" not in tree:
        tree["tail"] = ()
    return _numpy(tree)


def _numpy(node):
    if isinstance(node, dict):
        return {k: _numpy(v) for k, v in node.items()}
    if isinstance(node, tuple):
        return tuple(_numpy(v) for v in node)
    t = node.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()
