"""Serving steps captured once as CUDA graphs and replayed from then on
(the port of ``_StepFn`` and ``Engine.aot_compile`` in
``repro/serving/engine.py``).

A :class:`StepGraph` holds one kind of engine step (decode, mixed or
verify): a function of int32 device tensors — tokens, positions, the
valid-lane counts and the page table, as the step takes them — that runs
the model on the engine's cache in place and returns the logits.  A
signature is the shapes of those inputs.  ``warm(*shapes)`` makes one
ready before serving:

* on a CUDA device it allocates static input buffers (and pinned host
  buffers that feed them), runs the step once eagerly on a side stream —
  which builds and loads the kernels, sizes the cuBLAS workspaces and
  fills the parameters' cast copies (``layers.cast``), so that nothing is
  allocated for them during capture — and captures it as a
  ``torch.cuda.CUDAGraph``;
* on the CPU, which has no graphs, it runs the step once through the same
  static buffers, so the CPU tests drive the buffer plumbing.

A call copies its host arrays into the signature's buffers and replays
the graph (on the CPU: runs the step), and returns the static logits.
The graphs of one engine share one memory pool, so the logits hold until
the next replay of any of its steps: read them before that.  A call whose
signature was never warmed runs the step eagerly on the same device,
through the same kernels, and counts one ``compiles``: the recompile
tripwire of the reference.  Nothing is captured after warm-up, and a
capture that fails raises; nothing falls back to eager execution.

Kernel launches are counted on the host (``ops.LAUNCHES``), where a
replay makes no call: each graph keeps the launches its capture made and
adds them on every replay, so the counts still say which kernels ran.  A
graph reads the weights' cast copies made before it was captured: after
the weights change, build a new engine.
"""
from __future__ import annotations

import gc
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops

Shape = Tuple[int, ...]


class _Signature:
    """The buffers, graph and launch counts of one warmed signature."""

    def __init__(self, shapes: Tuple[Shape, ...], device: torch.device):
        cuda = device.type == "cuda"
        self.static = [torch.zeros(s, dtype=torch.int32, device=device)
                       for s in shapes]
        # host staging (pinned, so the copy is asynchronous) on a card;
        # on the CPU the static buffers are written directly
        self.host = ([torch.zeros(s, dtype=torch.int32, pin_memory=True)
                      for s in shapes] if cuda else self.static)
        self.copied = torch.cuda.Event() if cuda else None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}


class StepGraph:
    def __init__(self, fn: Callable[..., torch.Tensor],
                 device: torch.device, pool=None):
        """``fn`` runs the step on int32 device tensors; ``pool`` is the
        graph memory pool shared by one engine's steps, which replay one
        at a time on one stream."""
        self._fn = fn
        self.device = torch.device(device)
        self._pool = pool
        self._sigs: Dict[Tuple[Shape, ...], _Signature] = {}
        self.warmed = 0
        self.compiles = 0

    def warm(self, *shapes: Shape) -> None:
        """Make the signature ``shapes`` ready: capture it (CUDA) or run it
        once through its buffers (CPU).  The warm-up run writes into the
        cache with all-zero inputs; the caller restores the cache."""
        key = tuple(tuple(s) for s in shapes)
        if key in self._sigs:
            return
        sig = _Signature(key, self.device)
        if self.device.type != "cuda":
            self._fn(*sig.static)
        else:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._fn(*sig.static)
            torch.cuda.current_stream(self.device).wait_stream(side)
            before = dict(ops.LAUNCHES)
            sig.graph = torch.cuda.CUDAGraph()
            # no garbage collection inside the capture: a dead cycle that
            # holds another engine's graphs would be freed there, a CUDA
            # call the capture forbids (the process aborts)
            was_enabled = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(sig.graph, pool=self._pool):
                    sig.out = self._fn(*sig.static)
            finally:
                if was_enabled:
                    gc.enable()
            # capture records launches without running them
            sig.launches = {k: n - before[k] for k, n in ops.LAUNCHES.items()
                            if n != before[k]}
            ops.LAUNCHES.update(before)
            torch.cuda.synchronize(self.device)
        self._sigs[key] = sig
        self.warmed += 1

    def __call__(self, *arrays: np.ndarray) -> torch.Tensor:
        """Run the step on host integer arrays; returns its logits."""
        sig = self._sigs.get(tuple(a.shape for a in arrays))
        if sig is None:
            self.compiles += 1
            return self._fn(*(torch.from_numpy(
                np.ascontiguousarray(a, np.int32)).to(self.device)
                for a in arrays))
        if sig.copied is not None:
            sig.copied.synchronize()   # the last call's copies have read
        for h, a in zip(sig.host, arrays):
            h.numpy()[...] = a
        if sig.graph is None:
            return self._fn(*sig.static)
        for s, h in zip(sig.static, sig.host):
            s.copy_(h, non_blocking=True)
        sig.copied.record()
        sig.graph.replay()
        for k, n in sig.launches.items():
            ops.LAUNCHES[k] += n
        return sig.out
