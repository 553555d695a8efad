"""Logical-axis -> mesh placement of parameters, caches, batches and
optimizer state (port of ``repro/launch/sharding.py``).

MaxText-style: parameters and cache leaves declare *logical* axes (embed,
ff, heads, vocab, experts, batch, kv_seq, pages, ...: ``layers.param``'s
``axes``, ``layers.LeafDef``); ``launch/rules.py`` maps them onto the
mesh.  A rule that does not divide the dim — or whose mesh axis an earlier
dim of the same tensor took — is dropped (replication), which is what
lets minitron's 24 heads and whisper's 6 heads coexist with a 16-way model
axis.

A *defs tree* is a model (its named parameters), a dict, list or tuple of
defs trees, or a leaf: anything with ``shape`` and ``axes`` (a parameter
made by ``layers.param``, a ``LeafDef``).  ``specs_for_defs`` gives each
leaf's spec (``rules.spec_for``), ``sharding_for_defs`` its DTensor
placements (``rules.placements``) for ``torch.distributed.tensor``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.bridge import is_stacked
from repro_torch.launch.rules import (DEFAULT_RULES, is_placed,
                                      is_replicated, placements,
                                      serve_rules, shard_box, spec_for)
from repro_torch.models.layers import LeafDef

Tree = Any


def is_def(x) -> bool:
    return hasattr(x, "axes") and hasattr(x, "shape")


def map_defs(fn, defs: Tree) -> Tree:
    """``fn`` over every leaf of a defs tree, keeping its structure (a
    model becomes a dict of its parameter names)."""
    if is_def(defs):
        return fn(defs)
    if isinstance(defs, nn.Module):
        return {n: fn(p) for n, p in defs.named_parameters()}
    if isinstance(defs, dict):
        return {k: map_defs(fn, v) for k, v in defs.items()}
    if isinstance(defs, (list, tuple)):
        return type(defs)(map_defs(fn, v) for v in defs)
    raise TypeError(f"not a defs tree: {type(defs).__name__}")


def tree_defs(defs: Tree) -> list:
    """The leaves of a defs tree, in its order."""
    out = []
    map_defs(out.append, defs)
    return out


def specs_for_defs(defs: Tree, mesh, rules=None) -> Tree:
    """Defs tree -> spec tree (``rules.spec_for`` per leaf)."""
    return map_defs(lambda d: spec_for(d.shape, d.axes, mesh, rules), defs)


def sharding_for_defs(defs: Tree, mesh, rules=None) -> Tree:
    """Defs tree -> tree of DTensor placements lists."""
    return map_defs(
        lambda d: placements(spec_for(d.shape, d.axes, mesh, rules), mesh),
        defs)


def batch_sharding(mesh, ndim: int = 2, rules=None) -> list:
    """[batch, ...] activations: batch over (pod, data)."""
    rules = rules or DEFAULT_RULES
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    axes = tuple(m for m in rules["batch"] if m in names)
    return placements((axes,) if axes else (), mesh)


def batch_sharding_for(mesh, shape: Sequence[int], rules=None) -> list:
    """Like batch_sharding but with divisibility fallback on dim 0."""
    rules = rules or DEFAULT_RULES
    spec = spec_for(shape, ("batch",) + (None,) * (len(shape) - 1), mesh,
                    rules)
    return placements(spec, mesh)


def replicated(mesh) -> list:
    return placements((), mesh)


def serve_state_shardings(param_defs: Tree, cache_defs: Tree, mesh,
                          rules=None) -> Tuple[Tree, Tree]:
    """(params, cache) placements trees for a mesh-placed Engine.

    Defaults to ``rules.serve_rules()``: tensor-parallel params
    (replicated along 'data', sharded along 'model' where divisible) and
    the paged pool's 'pages' axis sharded along 'model' — per-device
    resident KV is num_pages/M pages of every layer."""
    rules = rules or serve_rules()
    return (sharding_for_defs(param_defs, mesh, rules),
            sharding_for_defs(cache_defs, mesh, rules))


# ---------------------------------------------------------------------------
# Optimizer state: mirror the param placement for same-shaped slots
# ---------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def opt_state_defs(param_defs: Tree, optimizer: str,
                   groups: Optional[Dict[tuple, list]] = None) -> Dict:
    """The defs (float32 ``LeafDef``s) of ``train/optimizer.py``'s state
    for a model's parameters.  AdamW: ``m`` and ``v`` mirror each
    parameter.  Adafactor: one slot a reference leaf (``groups``, from
    ``bridge.reference_groups``: a stacked leaf gets the ``layers`` axis
    in front; without groups each parameter is its own leaf), factored
    into ``vr`` (the last dim dropped) and ``vc`` (the second-to-last
    dropped) where both of its last two dims exceed 1."""
    params = map_defs(lambda d: d, param_defs)
    f32 = torch.float32
    if optimizer == "adamw":
        m = {n: LeafDef(d.shape, f32, d.axes) for n, d in params.items()}
        return {"m": m, "v": dict(m), "step": LeafDef((), f32, ())}
    groups = groups or {(n,): [n] for n in params}
    slots = {}
    for path, names in groups.items():
        d = params[names[0]]
        shape, axes = tuple(d.shape), tuple(d.axes)
        if is_stacked(names):
            shape, axes = (len(names),) + shape, ("layers",) + axes
        if _factored(shape):
            slots[path] = {
                "vr": LeafDef(shape[:-1], f32, axes[:-1]),
                "vc": LeafDef(shape[:-2] + shape[-1:], f32,
                              axes[:-2] + axes[-1:])}
        else:
            slots[path] = {"v": LeafDef(shape, f32, axes)}
    return {"slots": slots, "step": LeafDef((), f32, ())}


def opt_state_shardings(param_defs: Tree, mesh, optimizer: str,
                        rules=None,
                        groups: Optional[Dict[tuple, list]] = None) -> Dict:
    """Placements of the optimizer state: AdamW slots mirror the param
    layout; Adafactor's factored slots inherit the param's logical axes
    minus the reduced dim."""
    return sharding_for_defs(opt_state_defs(param_defs, optimizer, groups),
                             mesh, rules or DEFAULT_RULES)


# ---------------------------------------------------------------------------
# Placed tensors: whole rows in, each rank's shard written
# ---------------------------------------------------------------------------

def local(t: torch.Tensor) -> torch.Tensor:
    """The tensor this rank holds: a DTensor's local shard, else ``t``."""
    return t.to_local() if is_placed(t) else t


def distribute(t: torch.Tensor, mesh, place: list) -> torch.Tensor:
    """``t`` placed on ``mesh`` (every rank holds the same ``t``): each rank
    keeps its shard; a replicated placement keeps ``t`` itself."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if all(p.is_replicate() for p in place):
        return DTensor.from_local(t, mesh, place, run_check=False)
    return distribute_tensor(t, mesh, place)


def read_rows(leaf: torch.Tensor, idx) -> torch.Tensor:
    """Rows ``idx`` (a slice or an index tensor) along dim 0 of ``leaf``,
    whole on every rank: a DTensor is gathered first (nothing to gather
    where it is replicated)."""
    return (leaf.full_tensor() if is_placed(leaf) else leaf)[idx]


def write_rows(leaf: torch.Tensor, idx, rows: torch.Tensor) -> None:
    """``leaf[idx] = rows`` in place, for whole rows ``rows``; a DTensor
    writes into its local shard the rows it holds, each cut to the
    shard."""
    if not is_placed(leaf):
        leaf[idx] = rows
        return
    mine = leaf.to_local()
    if is_replicated(leaf):
        mine[idx] = rows
        return
    if isinstance(idx, slice):
        idx = torch.arange(leaf.shape[0], device=mine.device)[idx]
    (o0, *orow), (n0, *nrow) = shard_box(leaf)
    keep = (idx >= o0) & (idx < o0 + n0)
    part = rows[(keep,) + tuple(slice(o, o + n) for o, n in zip(orow, nrow))]
    mine[idx[keep] - o0] = part
