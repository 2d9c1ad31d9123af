"""CUDA graphs: the port's counterpart of the JAX package's compile once,
replay many (``jax.jit``, ``lower().compile()``).

A ``GraphCache`` belongs to one model's sampler or one train state. It
holds a side
stream on which each of its graphs is warmed up and captured, the
graphs by key, and one memory pool that they share, so that the buckets
of one model do not each hold their own activations. Sharing is safe because
the graphs of a cache replay one at a time on the current stream and
their callers copy each output out before the next replay.

A body that is captured keeps three rules:
- no copy between host and device and no synchronisation (the capture
  raises on one): numbers reach the graph through static tensors that
  the caller fills before each replay;
- no random draw: the caller draws into static tensors before the
  replay, in the order the eager body draws;
- every Python value it branches on or passes to a kernel is frozen into
  the graph, so it belongs in the key.

A capture or a replay that fails raises; nothing falls back to the eager
body.
"""

from __future__ import annotations

import gc
import time
from typing import Callable

import torch

from diffsci_tpu_torch import kernels


class Graph:
    """One captured graph: ``outputs`` is what the body returned (static:
    every replay writes it again), ``launches`` the kernel launches each
    replay makes, ``capture_seconds`` the host time of the capture."""

    def __init__(self, graph: torch.cuda.CUDAGraph, outputs, launches: dict,
                 capture_seconds: float):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.capture_seconds = capture_seconds
        self.inputs = None

    def replay(self) -> None:
        self.graph.replay()
        kernels.add_launches(self.launches)


class GraphCache:
    """The graphs of one model's sampler or one train state on ``device``,
    by key."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.graphs: dict = {}
        self._stream = None
        self._pool = None

    def _side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            kernels.load_all()
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    def warmup(self, fn: Callable):
        """Run ``fn`` eagerly on the stream the capture will use, as
        PyTorch's capture recipe asks: lazy state (an optimizer's moments,
        cuBLAS workspaces, cast copies, tables on the device) is made
        outside the graph. Returns what ``fn`` returns."""
        stream = self._side_stream()
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = fn()
        current.wait_stream(stream)
        return out

    def capture(self, key, fn: Callable) -> Graph:
        """Capture ``fn`` (warmed up before) into the cache under ``key``.
        The body runs once as Python, enqueueing into the graph. Python's
        cyclic collector is paused meanwhile: a ``CUDAGraph`` it frees
        there (an earlier cache's, left in a reference cycle) destroys its
        graph inside the capture, which invalidates the capture."""
        stream = self._side_stream()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with kernels.counting_capture() as launches:
                with torch.cuda.graph(graph, pool=self._pool, stream=stream):
                    outputs = fn()
        finally:
            if collecting:
                gc.enable()
        self.graphs[key] = Graph(graph, outputs, launches,
                                 time.perf_counter() - t0)
        return self.graphs[key]


def condition_key(y):
    """A condition's part of a graph key: None, or the shapes and dtypes
    of its tensors (a graph reads its values from static copies)."""
    if y is None:
        return None
    if isinstance(y, dict):
        return tuple((k, tuple(v.shape), v.dtype) for k, v in y.items())
    return (tuple(y.shape), y.dtype)


def static_like(y, device):
    """Static tensors for a condition (None, a tensor or a flat dict of
    tensors) on ``device``."""
    if y is None:
        return None
    if isinstance(y, dict):
        return {k: torch.empty_like(v, device=device) for k, v in y.items()}
    return torch.empty_like(y, device=device)


def fill(static, y) -> None:
    """Copy a condition's values into its static tensors."""
    if static is None:
        return
    if isinstance(static, dict):
        for k, v in static.items():
            v.copy_(y[k])
    else:
        static.copy_(y)
