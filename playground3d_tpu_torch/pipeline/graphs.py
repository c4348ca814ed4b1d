"""Tracker programs over static buffers, each one CUDA graph on the card.

The JAX package compiles a tracker step, a clip branch or a whole clip into
one program (``jax.jit``). The port's counterpart is a function over static
buffers - the tracker state and the step's inputs and outputs - that reads
the buffers and writes its results back into them. On the card each such
program is captured once as a CUDA graph and a step is one replay; on the
CPU the same buffers and write-backs run without capture, so the CPU tests
reach the code the card replays.

Capture rules (what a program may do): anything it makes from host data
must exist on the device before the capture (a host->device copy cannot be
captured), and it may not read the device (``.item()``, ``bool(t)``,
boolean indexing). The warm-up before each capture makes the lazily built
constants, plans, workspaces and counters.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import torch

from playground3d_tpu_torch.ops.cuda_build import credit, launches_recorded
from playground3d_tpu_torch.pipeline.tracker_state import TrackState
from playground3d_tpu_torch.track.kf import KFSlots
from playground3d_tpu_torch.utils.profiling import Spans


def state_leaves(state: TrackState) -> List[torch.Tensor]:
    """The tensors of a tracker state, in a fixed order."""
    return [*state.kf, *state[1:]]


def clone_state(state: TrackState) -> TrackState:
    return TrackState(KFSlots(*(x.clone() for x in state.kf)), *(x.clone() for x in state[1:]))


def copy_into(dst, src) -> None:
    """Copy each tensor of ``src`` into its static buffer in ``dst``."""
    for d, s in zip(dst, src):
        d.copy_(s)


class StaticGraphs:
    """Named programs over one owner's static buffers.

    ``run(name, body)`` runs ``body(write_back)``, a function that reads the
    buffers and, when ``write_back`` is true, writes its results into them.
    On the card each name is captured as one CUDA graph at
    its first run, after an eager warm-up on a side stream that writes
    nothing back, and every later run is one replay. The graphs share one
    memory pool: they only ever run one after another on one stream (the
    current stream of their device, which is made the current device for
    the capture and each replay). A
    capture that fails raises; nothing falls back to eager. The kernels'
    launch counters are Python integers, so each graph's launches are
    tallied at capture and credited once at every replay. On the CPU the
    body runs eagerly over the same buffers. Each run is a span
    ``replay.<name>`` of :attr:`spans`; while :class:`Spans` records, a
    replay is also timed on the device by two events around it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.capture = device.type == "cuda"
        self.graphs: Dict[str, Tuple[torch.cuda.CUDAGraph, dict]] = {}  # name -> (graph, launch tally)
        self.capture_s: Dict[str, Tuple[float, float]] = {}  # name -> host seconds (capture, instantiate)
        self.pool = None
        self.capture_stream = None  # torch.cuda.graph's default capture stream lies on the first card it met
        self.spans = Spans()

    def run(self, name: str, body: Callable[[bool], None]) -> None:
        if not self.capture:
            with self.spans("replay." + name):
                body(True)
            return
        with torch.cuda.device(self.device):  # a graph is captured and replayed on its own card's streams
            graph, tally = self.graphs.get(name) or self._capture(name, body)
            with self.spans("replay." + name) as span:
                if span is None:
                    graph.replay()
                else:
                    start, end = Spans.device_timer(span, self.device)
                    start.record()
                    graph.replay()
                    end.record()
        credit(tally)

    def _capture(self, name: str, body: Callable[[bool], None]):
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body(False)  # warm-up: outputs dropped, buffers untouched
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)  # the capture's time below holds none of the warm-up's
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.capture_stream = torch.cuda.Stream(dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept for its node count
        t0 = time.perf_counter()
        with launches_recorded() as tally:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.capture_stream,
                                  capture_error_mode="thread_local"):
                body(True)
        t1 = time.perf_counter()
        graph.instantiate()
        self.capture_s[name] = (t1 - t0, time.perf_counter() - t1)
        self.graphs[name] = (graph, dict(tally))
        return self.graphs[name]
