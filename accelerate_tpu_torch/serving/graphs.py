"""The serving engine's fixed-shape steps under CUDA graphs.

The JAX engine compiles each of its steps once and runs the executable
thereafter; the counterpart here is a CUDA graph. A step is a function of
no arguments that reads its inputs from static tensors (the engine copies
each call's inputs into them, never rebinding them) and writes its outputs
into static tensors. :class:`StepGraphs` runs a step by name:

* on the card, the first call runs the step eagerly (the real call; it also
  warms the library handles and the allocator on the engine's stream), then
  captures it into a ``torch.cuda.CUDAGraph``; every later call replays the
  graph. All graphs share one memory pool: the engine replays them one at a
  time on one stream, and their outputs are static tensors allocated
  outside the pool. A step that cannot be captured raises: the engine does
  not fall back to running it eagerly.
* on the CPU, every call runs the step eagerly.

Either way each call is reported to a
:class:`~accelerate_tpu_torch.utils.profiling.GraphCaptureWatcher`: on the
card once per capture, on the CPU once per run, so that after warmup a new
event there means a step ran with inputs of a new shape.
"""

from __future__ import annotations

import time

import torch


class StepGraphs:
    """Capture-once, replay-after runner of named fixed-shape steps (see
    the module docstring). ``stream`` is the CUDA stream the engine runs
    on; capture happens on it, in the calling thread (the engine's)."""

    def __init__(self, device: torch.device, watcher, stream=None):
        self.on_card = device.type == "cuda"
        self.watcher = watcher
        self._stream = stream
        self._graphs: dict = {}
        self._pool = None

    @property
    def captured(self) -> list:
        """Names of the steps captured so far, in capture order."""
        return list(self._graphs)

    def run(self, name: str, step, signature) -> None:
        """Run step ``name``: replay its graph, or (first call on the card)
        run it and capture it; on the CPU run it."""
        if not self.on_card:
            self.watcher.record(name, signature)
            step()
            return
        graph = self._graphs.get(name)
        if graph is not None:
            graph.replay()
            return
        step()
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode="thread_local"):
            step()
        self._graphs[name] = graph
        self.watcher.record(name, signature, time.perf_counter() - t0)
