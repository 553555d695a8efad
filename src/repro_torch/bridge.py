"""Weight bridge from the JAX package's parameter tree to the port.

``params_from_jax`` takes the tree ``TransformerLM.init`` builds in
``repro`` — already converted to numpy arrays by the caller, so this
module needs no JAX — and returns a ``state_dict`` for the port's
``TransformerLM``.  The port keeps the reference's weight layouts
(``wq [d, H, hd]``, ``wo [H, hd, d]``, ``wi [d, ff]``, ...), so each leaf
is a copy.  The one structural change: the reference stacks the repeating
layer unit along a leading ``layers`` axis under ``params["scan"]`` (a
tuple over the unit's positions), followed by unstacked ``params["tail"]``
blocks; here every layer is its own ``blocks.<i>`` module.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch


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
    stacked = bool(unit) and np.asarray(unit[0]["ln1"]["scale"]).ndim == 2
    repeats = np.asarray(unit[0]["ln1"]["scale"]).shape[0] if stacked else 1

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
    _flatten(params_np["ln_f"], "ln_f", state)
    for i, blk in enumerate(_unstack_blocks(params_np["scan"],
                                            params_np.get("tail", ()))):
        _flatten(blk, f"blocks.{i}", state)
    return {k: torch.tensor(np.ascontiguousarray(v))
            for k, v in state.items()}
