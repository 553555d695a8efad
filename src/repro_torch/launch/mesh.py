"""Device meshes (port of ``repro/launch/mesh.py``).

``make_serve_mesh("DxM")`` builds a ``torch.distributed`` DeviceMesh with
dims ``("data", "model")`` over the default process group.  A 1x1 mesh
needs no launcher: with no group initialised it starts a one-rank group
itself over an in-process ``HashStore`` (gloo on the CPU, NCCL on the
card), so ``ServeConfig(mesh="1x1")`` works in any process.  A mesh of
D*M > 1 needs D*M ranks in the default group already, one process each:
``torchrun --nproc-per-node D*M`` (launch/serve.py --mesh), or processes
the caller spawns.

``make_production_mesh`` describes the dry run's meshes — 16x16 ``(data,
model)``, or 2x16x16 ``(pod, data, model)`` with ``multi_pod`` — by
names and shape only (``MeshShape``): no device is touched, and
``launch/rules.py`` and ``launch/sharding.py`` read nothing else of a
mesh.

The hardware constants are one NVIDIA H100 SXM's (NVIDIA's data sheet,
dense rates, at the full 700 W power limit): they are what the dry run's
roofline terms divide by.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

# NVIDIA H100 80GB HBM3 (SXM), power limit 700 W.
PEAK_FLOPS_BF16 = 989e12          # per card, FLOP/s, dense bf16
PEAK_FLOPS_FP32 = 67e12           # per card, FLOP/s, float32 outside the
                                  # tensor cores
HBM_BW = 3.35e12                  # per card, B/s, HBM3
NVLINK_BW = 450e9                 # per card and direction, B/s (NVLink 4:
                                  # 18 links, 900 GB/s both ways together)
# torch.cuda.get_device_properties(0).total_memory on an NVIDIA H100 80GB
# HBM3 at 700.00 W (chip_smoke.py's [mesh] phase prints and checks it)
HBM_BYTES = 85_017_493_504

AXES = ("data", "model")


@dataclass(frozen=True)
class MeshShape:
    """A mesh described by its axis names and shape only."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(AXES, (16, 16))


def parse_mesh_spec(spec: str) -> Tuple[int, int]:
    """``"DxM"`` -> (D, M); the reference's errors for a malformed spec or
    a non-positive axis."""
    m = re.fullmatch(r"(\d+)x(\d+)", spec.strip().lower())
    if not m:
        raise ValueError(f"mesh spec {spec!r} is not of the form 'DxM' "
                         f"(e.g. '1x2')")
    d, t = int(m.group(1)), int(m.group(2))
    if d < 1 or t < 1:
        raise ValueError(f"mesh spec {spec!r} has a non-positive axis")
    return d, t


def _start_local_group(device_type: str) -> None:
    """A one-rank default process group over an in-process store: no
    launcher, no address, no network."""
    import torch.distributed as dist
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_serve_mesh(spec: str, device_type: Optional[str] = None):
    """Serving mesh from a ``"DxM"`` string (e.g. ``"1x2"``): dims
    ``("data", "model")`` — replica groups x tensor-parallel shards — on
    ``device_type`` (the card unless the caller asks for ``"cpu"``).
    Validates against the default process group's world size; a 1x1 mesh
    starts a one-rank group when there is none."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    d, t = parse_mesh_spec(spec)
    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device_type='cpu' for a "
            "CPU mesh")
    need = d * t
    if not dist.is_initialized():
        if need > 1:
            raise ValueError(
                f"mesh {spec} needs {need} ranks but no process group is "
                f"initialised — launch with torchrun --nproc-per-node "
                f"{need} (CPU), or use mesh 1x1")
        _start_local_group(device_type)
    have = dist.get_world_size()
    if need > have:
        raise ValueError(
            f"mesh {spec} needs {need} ranks but the process group has "
            f"{have} — launch with torchrun --nproc-per-node {need}, or "
            f"use fewer shards")
    return DeviceMesh(device_type, torch.arange(need).view(d, t),
                      mesh_dim_names=AXES)


def make_host_mesh():
    """1-device CPU mesh for tests and examples (same axis names)."""
    return make_serve_mesh("1x1", "cpu")


def mesh_chips(mesh) -> int:
    """Devices in a mesh: a DeviceMesh or a ``MeshShape``."""
    return mesh.size()
