"""Logical-axis rules and activation sharding (port of
``repro/launch/rules.py``).

Import-light (torch only, no ``repro_torch.models``) so model code can
call ``shard_activation`` without cycles.  ``spec_for`` is the reference's
mapping with its divisibility fallback and its used-axis rule; a spec is a
tuple with one entry per tensor dim (None, a mesh axis name, or a tuple of
names), trailing Nones dropped: the entries of the reference's
``PartitionSpec``.  ``placements`` turns a spec into the DTensor
``Shard`` / ``Replicate`` list of a ``torch.distributed`` device mesh.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

Spec = Tuple[Optional[object], ...]

# logical axis -> ordered tuple of mesh axes to try
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    # KV-cache sequence dim: model axis first (flash-decoding layout, since
    # 8 kv-heads can't divide model=16); batch-1 long decode also absorbs
    # the unused (pod, data) axes = context parallelism.
    "kv_seq": ("model", "pod", "data"),
    "seq_act": ("model",),          # Megatron-style sequence parallelism
    "embed": ("data",),             # FSDP shard of weight matrices
    "vocab": ("model",),
    "ff": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "experts": ("model",),
    # Paged KV pool leaves ([pages, page_size, kv_heads, hd]): the pool is
    # sharded by PHYSICAL PAGE along 'model' — every device owns
    # num_pages/M pages of every layer.  kv_heads on the same leaf then
    # falls back to replicated (spec_for's used-axis rule): page-granular
    # placement keeps the write scatter and COW copies local to one shard,
    # while GQA kv_heads (2-8) rarely divide a wide model axis anyway.
    "pages": ("model",),
    "layers": (),                   # stacked-layer axis: never sharded
}


def tp_rules() -> dict:
    """Tensor-parallel-only rules (no FSDP): weights replicated along
    'data', sharded along 'model' where divisible.  Used for every arch
    whose params and optimizer state fit a device without FSDP."""
    r = dict(DEFAULT_RULES)
    r["embed"] = ()
    return r


def serve_rules() -> dict:
    """Serving-engine rules (mesh-placed Engine): tensor-parallel param
    placement — weights replicated along 'data', sharded along 'model'
    where divisible — plus the paged pool's 'pages' axis sharded along
    'model'.  Decode never wants FSDP: an embed->data shard would gather
    the weights on every step for no memory benefit at serving batch
    sizes."""
    return tp_rules()


def decode_rules() -> dict:
    """Row-parallel weight layout for the largest archs' DECODE: weights
    stored [embed -> model, heads/ff/vocab -> data] stay 2-D sharded while
    the contraction dim is 'model'-sharded, so the partial sums reduce
    over small [B, 1, *] decode activations instead of gathering the
    weights every step."""
    r = dict(DEFAULT_RULES)
    r.update(embed=("model",), heads=("data",), kv_heads=("data",),
             ff=("data",), vocab=("data",), experts=("data",))
    return r


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size of a mesh: a ``torch.distributed`` DeviceMesh, a
    ``launch.mesh.MeshShape`` (names and shape only), or any object with
    the reference's ``axis_names`` and ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                               # DeviceMesh
        return dict(zip(names, mesh.mesh.shape))
    shape = (mesh.shape if hasattr(mesh, "shape")
             else mesh.devices.shape)
    return dict(zip(mesh.axis_names, tuple(shape)))


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
             mesh, rules=None) -> Spec:
    """Map logical axes to a spec with divisibility fallback: each dim
    takes, in rule order, the mesh axes it divides that no earlier dim of
    the tensor took."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_axes(mesh)
    used = set()
    entries = []
    for dim, ax in zip(shape, axes):
        if ax is None or ax not in rules:
            entries.append(None)
            continue
        picked = []
        prod = 1
        for m in rules[ax]:
            if m not in sizes or m in used:
                continue
            if dim % (prod * sizes[m]) == 0:
                picked.append(m)
                prod *= sizes[m]
        if not picked:
            entries.append(None)
        else:
            used.update(picked)
            entries.append(tuple(picked) if len(picked) > 1 else picked[0])
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def placements(spec: Spec, mesh) -> list:
    """A spec as DTensor placements, one per mesh dim: ``Shard(d)`` where
    tensor dim d names the mesh dim, else ``Replicate()``.  A mesh dim of
    size 1 is always ``Replicate()``: a shard over one device is the whole
    tensor, and DTensor then never plans a collective over it.  A dim
    split over several mesh dims is split in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_axes(mesh)
    owner = {}
    for d, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            owner[name] = d
    return [Shard(owner[name]) if name in owner and size > 1
            else Replicate() for name, size in sizes.items()]


def shard_bytes(shape: Sequence[int], dtype: torch.dtype, spec: Spec,
                mesh) -> int:
    """Bytes of one device's shard of a tensor placed by ``spec``."""
    sizes = mesh_axes(mesh)
    n = 1
    for d, dim in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        div = 1
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            div *= sizes[name]
        n *= dim // div
    return n * torch.empty((), dtype=dtype).element_size()


def shard_activation(x: torch.Tensor, axes: Tuple[Optional[str], ...],
                     rules=None) -> torch.Tensor:
    """Place an activation by the logical rules on its DTensor's mesh.

    No-op when no mesh is active — ``x`` is a plain tensor (CPU tests,
    the unmeshed engine) — or when nothing in the spec is shardable."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = spec_for(x.shape, axes, x.device_mesh, rules)
    if not any(spec):
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


# ---------------------------------------------------------------------------
# Local regions of a mesh-placed model
# ---------------------------------------------------------------------------

def is_placed(x) -> bool:
    """Is ``x`` a DTensor (a tensor placed on a device mesh)?"""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def is_replicated(x) -> bool:
    """Does every device of ``x``'s mesh hold all of it?"""
    return all(p.is_replicate() for p in x.placements)


def shard_box(x) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(global offset, local shape) of this rank's shard of DTensor ``x``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return tuple(offset), tuple(shape)


def run_local(fn, *args, n_out: int = 1, **kw):
    """``fn(*args, **kw)`` on plain tensors: the attention reads and the
    scans of a mesh-placed model, whose hand-written kernels (and plain
    versions) take whole tensors.  Without a DTensor among the arguments,
    ``fn`` itself.  With one, through ``local_map`` (PyTorch's counterpart
    of ``shard_map``): every DTensor input is replicated first — nothing
    to do on a one-device mesh, where the kernels run on the local
    tensors; a gather on more, so the plain reads run on the gathered
    pool, the reference's own choice under more than one device — and
    the ``n_out`` outputs come back replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    flat = list(args) + list(kw.values())
    placed = next((a for a in flat if isinstance(a, DTensor)), None)
    if placed is None:
        return fn(*args, **kw)
    mesh = placed.device_mesh
    rep = [Replicate()] * mesh.ndim
    names, n_args = list(kw), len(args)

    def body(*a):
        return fn(*a[:n_args], **dict(zip(names, a[n_args:])))

    return local_map(
        body, out_placements=rep if n_out == 1 else (rep,) * n_out,
        in_placements=tuple(rep if isinstance(a, DTensor) else None
                            for a in flat),
        device_mesh=mesh, redistribute_inputs=True)(*flat)
