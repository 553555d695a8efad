"""Device dispatch of the port's kernels (port of ``repro/kernels/ops.py``).

One rule replaces the reference's ``attn_impl`` switch and its
``interpret`` flag: a CPU tensor goes to the kernel's plain PyTorch
version, a CUDA tensor goes to the hand-written kernel, or the call
raises.  There is no fallback from the kernel to the plain version.
``LAUNCHES`` counts kernel launches, so a run can show that its main path
went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cuda_lib import LAUNCHES, reset_launches
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels.paged_extend import paged_extend_attention
from repro_torch.kernels.rglru_scan import rglru_scan

__all__ = ["LAUNCHES", "reset_launches", "flash_attention",
           "decode_attention", "paged_decode_attention",
           "paged_extend_attention", "mamba_scan", "rglru_scan",
           "resolve_attn_impl"]


def resolve_attn_impl(device: torch.device) -> str:
    """Which read implementation attention uses on ``device``:
    ``"cuda"`` (the hand-written kernels) on a CUDA device, ``"plain"``
    (the PyTorch versions in kernels/ref.py) on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "plain"
