"""Steps of a solve captured as CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package compiles a whole IRLS solve into one XLA program. Here a
:class:`CapturedStep` wraps a function of no arguments that reads and
writes tensors whose addresses never change (its *buffers*: the solve's
state, the objective's constants and shifts). On a CUDA device its first
call warms the function up on a side stream (library handles and the
kernels' build happen there), puts the buffers back as they were, captures
the function into a ``torch.cuda.CUDAGraph``, and replays it; every later
call replays it. The graph's scratch comes from a private memory pool,
which the steps of one solve may share (``pool``): they replay one after
another on one stream and none keeps scratch alive past its end (what it
computes goes into the buffers), so one step's scratch can be the next one's. A replay costs one launch from
the host however many kernels the function launches. A capture that fails
raises: there is no eager path behind it. On the CPU every call runs the
function eagerly, so the CPU runs the same steps the card replays.

The fused objective's counters (``ops/cuda/degrade.py``) see a capture once
and a replay never, so the step adds what its capture launched to them on
every replay. Its graph also keeps the fold state of every evaluation it
captured and ORs their ``late`` flags into :attr:`CapturedStep.late`, a
device word that stays nonzero once any replay's cost fold stopped waiting.
"""

from __future__ import annotations

import gc
from typing import Callable, Sequence

import torch

from super_resolution_tpu_torch.ops.cuda import degrade

__all__ = ["CapturedStep", "capture_counts"]

# Graphs captured since the module was imported, by every CapturedStep.
capture_counts: dict[str, int] = {"graphs": 0}
# One warm-up stream per device: memory cached for it is reused by the next warm-up.
_warm_up_streams: dict[torch.device, torch.cuda.Stream] = {}


class CapturedStep:
    """``fn`` as a CUDA graph on a CUDA ``device``, eager on the CPU.

    ``buffers``: every tensor ``fn`` writes that must keep its value across
    the warm-up (the warm-up runs ``fn`` once on the real buffers, which are
    then restored). ``pool``: a ``torch.cuda.graph_pool_handle()`` shared
    with other steps, or ``None`` for a pool of its own. ``replays`` counts
    the replays since construction.
    """

    def __init__(self, fn: Callable[[], None], device, buffers: Sequence[torch.Tensor], pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.buffers = tuple(buffers)
        self.pool = pool
        self.graph: torch.cuda.CUDAGraph | None = None
        self.replays = 0
        self.late: torch.Tensor | None = None
        self._launches = None
        self._folds: list[torch.Tensor] = []

    def __call__(self) -> None:
        if self.device.type != "cuda":
            self.fn()
            return
        if self.graph is None:
            self._capture()
        with torch.cuda.device(self.device):
            self.graph.replay()
        self.replays += 1
        degrade.add_counts(self._launches)

    def _capture(self) -> None:
        with torch.cuda.device(self.device):
            saved = [b.clone() for b in self.buffers]
            side = _warm_up_streams.get(self.device)
            if side is None:
                side = _warm_up_streams[self.device] = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with degrade.recording_launches(), torch.cuda.stream(side):  # the warm-up counts for nothing
                self.fn()
            torch.cuda.current_stream().wait_stream(side)
            for buffer, value in zip(self.buffers, saved):
                buffer.copy_(value)
            del saved

            graph = torch.cuda.CUDAGraph()
            late = torch.zeros((), dtype=torch.int32, device=self.device)
            # No garbage collection inside the capture: a collected object
            # that held a graph would destroy it mid-capture, which CUDA
            # refuses (``torch.cuda.graph`` collects once before it starts).
            collecting = gc.isenabled()
            gc.disable()
            try:
                with degrade.recording_launches() as record, torch.cuda.graph(graph, pool=self.pool):
                    self.fn()
                    if record.folds:
                        flags = torch.stack([fold.view(torch.int32)[1] for fold in record.folds])
                        torch.maximum(late, flags.amax(), out=late)
            finally:
                if collecting:
                    gc.enable()
        self.graph, self.late = graph, late
        self._launches, self._folds = record.counts, record.folds
        capture_counts["graphs"] += 1
