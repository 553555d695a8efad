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
(rglru, rglru, rg_attn) unit and a (rglru, rglru) tail).  Leaves keep
their dtypes: mamba's ``A_log`` and ``D`` and RG-LRU's ``lam`` stay
float32 under bfloat16 parameters.
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
    _flatten(params_np["ln_f"], "ln_f", state)
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
