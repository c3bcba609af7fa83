"""Captured decode loops: a region of kernel launches recorded once as a CUDA
graph and replayed, the port's counterpart of the reference's jitted
``lax.scan`` programs (``launch.serve.generate``'s decode steps and the
engine's burst).

A :class:`Replay` owns one region: a callable that reads its inputs from
static tensors (its owner refreshes them with ``copy_`` before each run)
and returns its outputs.  On a CUDA device, ``ready()`` first warms a
region up on a side stream, so that what a kernel sets up at its first
launch (``cudaFuncSetAttribute`` for large shared memory, the packed
decode's cluster-occupancy table, cuBLAS's workspace, the allocator's
blocks) happens outside the capture, and then captures it with
``torch.cuda.graph``.  ``run()`` replays the graph and returns the tensors
that the capture returned, which every replay overwrites.  The CPU has no
graphs: there ``run()`` calls the region over the same static tensors (as
a CPU tensor runs a kernel's plain version), so the tests reach every line
but the capture.

Nothing falls back: an error in the warm-up, the capture or a replay
propagates, and a region whose capture failed is not kept.  A graph bakes
in the address of every tensor it reads, the parameters included, so its
owner keys it by the params dict it was captured on and the ``Replay``
holds that dict.  A graph's memory pool is freed with the ``Replay``, which
lives on the object that owns its static tensors (a ``Model``, an
``Engine``).

Launch counts.  A wrapper counts a launch when it runs, which for a
captured region is at the warm-up and at the capture (where nothing is
launched).  ``Replay`` puts every count of ``kernels.counted()`` back to
its value before the warm-up and adds the capture's change at each replay,
so a run through graphs reports the launches that the same steps report
when they run from Python.  The warm-up is set-up, and not counted, as the
reference does not count a compile.
"""
from __future__ import annotations

import gc
import time

import torch

from repro_torch.kernels import counted

# the decode loops of ``launch.serve.generate`` and the engine: captured
# and replayed (default), or launched step by step from Python (debug)
LOOPS = ("graph", "python")


def read_counts() -> dict:
    """{name: (launches, {kernel: launches})} of every counted wrapper."""
    return {name: (fn.launches, dict(getattr(fn, "by_kernel", {})))
            for name, fn in counted().items()}


def _diff(after: dict, before: dict) -> dict:
    return {name: (n - before[name][0],
                   {k: v - before[name][1].get(k, 0) for k, v in by.items()})
            for name, (n, by) in after.items()}


def write_counts(counts: dict) -> None:
    """Set every counted wrapper's counts to a ``read_counts()`` snapshot."""
    for name, fn in counted().items():
        fn.launches, by = counts[name]
        if by:
            fn.by_kernel.update(by)


def _add_counts(delta: dict) -> None:
    for name, fn in counted().items():
        n, by = delta[name]
        fn.launches += n
        for k, v in by.items():
            fn.by_kernel[k] += v


class CudaGraphs:
    """How a :class:`Replay` warms a region up and captures it on the card
    (a test substitutes a stand-in)."""

    def warm_up(self, fn) -> None:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)

    def capture(self, fn):
        """(graph, the outputs ``fn`` returned under capture).  Python's
        cyclic garbage collector is off while the region is captured: a
        collection then could free an unreachable owner of another graph,
        whose destruction the capture does not permit (it invalidates the
        capture); what is garbage is collected after it."""
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                out = fn()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize()
        return graph, out


class Replay:
    """One captured region.  ``region()`` runs the whole loop and
    ``warm_up()`` (default: the region) one step of it, at the shapes of
    every step; ``params`` is the params dict whose tensors the graph
    reads."""

    graphs = CudaGraphs()

    def __init__(self, region, device, *, warm_up=None, params=None):
        self.region = region
        self.warm_up = warm_up if warm_up is not None else region
        self.device = torch.device(device)
        self.params = params
        self.graph = None
        self.outputs = None
        self.delta: dict = {}
        self.capture_s = 0.0
        self.replays = 0

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def ready(self) -> float:
        """Capture the region on the card unless it is captured; returns
        the seconds this call spent (warm-up and capture), 0.0 when it
        captured nothing (already captured, or on the CPU)."""
        if self.graph is not None or self.device.type != "cuda":
            return 0.0
        t0 = time.perf_counter()
        before = read_counts()
        try:
            self.graphs.warm_up(self.warm_up)
            start = read_counts()
            graph, outputs = self.graphs.capture(self.region)
            delta = _diff(read_counts(), start)
        finally:
            write_counts(before)
        self.graph, self.outputs, self.delta = graph, outputs, delta
        self.capture_s = time.perf_counter() - t0
        return self.capture_s

    def run(self):
        """The region's outputs for the current static inputs: a replay of
        its graph on the card (captured first if need be), a call of the
        region on the CPU."""
        if self.device.type != "cuda":
            return self.region()
        self.ready()
        self.graph.replay()
        _add_counts(self.delta)
        self.replays += 1
        return self.outputs
