"""FLOPs and bytes of one step, counted over a run on the ``meta`` device.

This takes the role of the reference's ``launch/hlocost.py``, which walks
XLA's optimized HLO text (a text PyTorch does not produce) and multiplies
while-loop bodies by their trip counts.  Here the step simply runs, on
``meta`` tensors (shapes and dtypes, no data, no memory), and is counted
as it dispatches:

  flops — ``torch.utils.flop_counter.FlopCounterMode``: 2 * M * N * K per
          matrix product (mm, bmm, addmm, einsum's products, convolution),
          as hlocost counts dots; plus each hand-written kernel's products
          (below);
  bytes — every dispatched op's tensor operands and results (views and
          aliases move nothing and are skipped), as hlocost sums operand
          and result bytes per materialized instruction;
  kernels — the port's kernels run as one op each (``kernel_stand_ins``):
          on ``meta`` tensors a stand-in gives outputs of the kernel's
          shapes and counts the kernel's own work — its inputs read and
          outputs written once, and the products of the (query, key)
          pairs it attends (2 * hd per pair for scores, as much for the
          values; a backward 2.5 times its forward) or, for the mamba
          scan, its ``h . C`` contraction.  The plain versions' per-step
          Python loops (the scans) would otherwise take hours at 32K
          tokens.

The counts are of the whole, unpartitioned step: no compiler decides
here how the step splits over a mesh, so there is no per-device split,
no temporary-buffer size and no collective traffic (ROADMAP A17).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


aten = torch.ops.aten
# ops that move no data
_FREE = {aten.detach, aten.alias, aten.lift_fresh, aten.empty,
         aten.empty_strided, aten.empty_like, aten.new_empty,
         aten.new_empty_strided}


class _ByteCounter(TorchDispatchMode):
    """Sums each dispatched op's operand and result bytes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.overloadpacket not in _FREE:
            self.bytes += _nbytes(tree_leaves((args, kwargs))) + \
                _nbytes(tree_leaves(out))
            self.ops += 1
        return out


class KernelCost:
    """The hand-written kernels' work while ``kernel_stand_ins`` is on."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0
        self.calls: Dict[str, int] = {}

    def add(self, name: str, flops: float, nbytes: int) -> None:
        self.flops += flops
        self.bytes += nbytes
        self.calls[name] = self.calls.get(name, 0) + 1


def attended_pairs(S: int, window: Optional[int], prefix_len: int) -> int:
    """(query, key) pairs of causal attention over S positions, each
    query seeing at most ``window`` keys, the first ``prefix_len``
    positions seeing each other (a bidirectional prefix)."""
    i = np.arange(S, dtype=np.int64)
    n = np.where(i < prefix_len, prefix_len, i + 1)
    if window is not None:
        n = np.where(i < prefix_len, n, np.minimum(n, window))
    return int(n.sum())


def _empty(t: torch.Tensor, shape, dtype=None) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype or t.dtype, device=t.device)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, cost, window, prefix_len):
        B, H, S, hd = q.shape
        ctx.cost, ctx.flops = cost, 4.0 * B * H * hd * attended_pairs(
            S, window, prefix_len)
        out = _empty(q, q.shape)
        cost.add("flash_attention", ctx.flops, _nbytes((q, k, v, out)))
        ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _empty(q, q.shape), _empty(k, k.shape), _empty(v, v.shape)
        # q, k, v, o, do and the lse in; dq, dk, dv out
        ctx.cost.add("flash_attention_bwd", 2.5 * ctx.flops,
                     _nbytes((q, k, v, do, do, dq, dk, dv))
                     + q.shape[0] * q.shape[1] * q.shape[2] * 4)
        return dq, dk, dv, None, None, None


class _Scan(torch.autograd.Function):
    """A scan: outputs ``shapes`` (float32), a backward of twice the
    forward's products."""

    @staticmethod
    def forward(ctx, cost, name, flops, shapes, *inputs):
        ctx.cost, ctx.name, ctx.flops = cost, name, flops
        outs = tuple(_empty(inputs[0], s, torch.float32) for s in shapes)
        cost.add(name, flops, _nbytes(inputs) + _nbytes(outs))
        ctx.save_for_backward(*inputs)
        return outs

    @staticmethod
    def backward(ctx, *douts):
        ins = ctx.saved_tensors
        grads = tuple(_empty(t, t.shape) for t in ins)
        ctx.cost.add(ctx.name + "_bwd", 2.0 * ctx.flops,
                     _nbytes(ins) + _nbytes(douts) + _nbytes(grads))
        return (None, None, None, None) + grads


@contextlib.contextmanager
def kernel_stand_ins(cost: KernelCost):
    """Within the block, ``kernels/ops.py``'s kernels called on ``meta``
    tensors give outputs of their shapes and add their work to
    ``cost``; on other tensors they run as always."""
    from repro_torch.kernels import ops
    real = {n: getattr(ops, n) for n in ("flash_attention",
                                         "decode_attention",
                                         "mamba_scan", "rglru_scan")}

    def flash(q, k, v, *, window=None, lengths=None, prefix_len=0):
        if not q.is_meta:
            return real["flash_attention"](q, k, v, window=window,
                                           lengths=lengths,
                                           prefix_len=prefix_len)
        return _Flash.apply(q, k, v, cost, window, prefix_len)

    def decode(q, k, v, tok, pos, *, k_scale=None, k_zero=None,
               v_scale=None, window=None):
        if not q.is_meta:
            return real["decode_attention"](
                q, k, v, tok, pos, k_scale=k_scale, k_zero=k_zero,
                v_scale=v_scale, window=window)
        B, K, G, hd = q.shape
        C = k.shape[1] if window is None else min(k.shape[1], window)
        out = _empty(q, q.shape)
        cost.add("decode_attention", 4.0 * B * K * G * hd * C,
                 _nbytes((q, k, v, tok, pos, k_scale, k_zero, v_scale,
                          out)))
        return out

    def mamba(dt, Bm, Cm, x, A, Dsk, h0):
        if not dt.is_meta:
            return real["mamba_scan"](dt, Bm, Cm, x, A, Dsk, h0)
        B, S, D = dt.shape
        return _Scan.apply(cost, "mamba_scan", 2.0 * B * S * D * A.shape[1],
                           [(B, S, D), tuple(h0.shape)],
                           dt, Bm, Cm, x, A, Dsk, h0)

    def rglru(a, b, h0):
        if not a.is_meta:
            return real["rglru_scan"](a, b, h0)
        return _Scan.apply(cost, "rglru_scan", 0.0,
                           [tuple(a.shape), tuple(h0.shape)], a, b, h0)

    stand = {"flash_attention": flash, "decode_attention": decode,
             "mamba_scan": mamba, "rglru_scan": rglru}
    for n, f in stand.items():
        setattr(ops, n, f)
    try:
        yield cost
    finally:
        for n, f in real.items():
            setattr(ops, n, f)


def count(step: Callable[[], object]) -> Dict:
    """Run ``step`` (on ``meta`` tensors) and count it: ``flops`` and
    ``bytes`` of the whole step, the dispatched ``ops``, and the
    kernels' share (``kernel_flops``, ``kernel_bytes``,
    ``kernel_calls``)."""
    kernels = KernelCost()
    flop_mode = FlopCounterMode(display=False)
    bytes_mode = _ByteCounter()
    with kernel_stand_ins(kernels), flop_mode, bytes_mode:
        step()
    return {"flops": float(flop_mode.get_total_flops()) + kernels.flops,
            "bytes": bytes_mode.bytes + kernels.bytes,
            "ops": bytes_mode.ops,
            "kernel_flops": kernels.flops, "kernel_bytes": kernels.bytes,
            "kernel_calls": dict(kernels.calls)}
