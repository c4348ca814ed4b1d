"""Host spans of the trackers' loops, on the clock of PyTorch's profiler
(the port's counterpart of the stage timers of
``playground3d_tpu/utils/profiling.py``, the reference's ``time_metrics``
dict, MC3D_crop_tracker.py:168-181).

A tracker times each stage of its loop as a named span of a
:class:`Spans`, which always adds the span's seconds to a total a name
(``totals``, a plain dict; the trackers expose it as ``timers``). While
:class:`Spans` records, it also keeps every span whole in :attr:`Spans.log`:
its name, start and end on ``time.perf_counter_ns``, parent span, thread
and clip, and, for a CUDA graph replay, the device milliseconds between two
events around it. It records during a
:meth:`~playground3d_tpu_torch.pipeline.multi_cam.MultiCameraTracker.track_clips`
call that starts while a ``torch.profiler`` runs, so spans are kept exactly
when there is a device trace to lay them on; each such call clears the log
of the one before.

How an operator records a call and lays its spans on the device trace::

    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        tracker.track_clips(sources)
    offset = Spans.offset_ns()  # perf_counter ns -> the profiler's realtime ns
    for s in Spans.log:
        print(s.name, s.clip, s.start_ns + offset, s.end_ns + offset, s.device_ms)
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

_local = threading.local()  # each thread's open spans, innermost last, while recording


def _open_spans() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _realtime_offset_ns() -> int:
    """realtime ns - perf_counter ns, now (the profiler stamps realtime)."""
    return time.time_ns() - time.perf_counter_ns()


class Span:
    """One recorded span: ``name``, ``[start_ns, end_ns)`` on
    ``time.perf_counter_ns``, the span it ran inside (``parent``, None at
    the root), the ``thread`` (``threading.get_ident``) it ran on and the
    ``clip`` it served (that clip's first frame index in its call, taken
    from the parent unless given). A graph replay timed on the device gets
    ``device_ms`` once its clip is read back."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "thread", "clip", "events", "device_ms")

    def __init__(self, name: str, parent: Optional["Span"], clip: Optional[int]):
        self.name, self.parent = name, parent
        self.clip = clip if clip is not None or parent is None else parent.clip
        self.thread = threading.get_ident()
        self.start_ns = self.end_ns = 0
        self.events = None  # (start, end, their device) CUDA events around a replay, until settled
        self.device_ms: Optional[float] = None


class _Timing:
    """The context of one span: its seconds go to ``totals`` always, the
    span itself to the log while recording (``__enter__`` returns it, else
    None)."""

    __slots__ = ("totals", "name", "clip", "span", "t0")

    def __init__(self, totals: Dict[str, float], name: str, clip: Optional[int]):
        self.totals, self.name, self.clip = totals, name, clip

    def __enter__(self) -> Optional[Span]:
        span = None
        if Spans.recording:
            stack = _open_spans()
            span = Span(self.name, stack[-1] if stack else None, self.clip)
            stack.append(span)
        self.span = span
        self.t0 = time.perf_counter_ns()
        return span

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        self.totals[self.name] = self.totals.get(self.name, 0.0) + (t1 - self.t0) / 1e9
        span = self.span
        if span is not None:
            span.start_ns, span.end_ns = self.t0, t1
            _open_spans().pop()
            Spans.log.append(span)
        return False


class Spans:
    """Named host spans: ``with spans("stage", clip):`` adds the block's
    seconds to ``totals["stage"]``, and while recording keeps the span in
    the class-wide :attr:`log` (it outlives the tracker that wrote it, as
    :class:`~playground3d_tpu_torch.ops.topk.HostSyncs` does its counts).

    ``offsets_ns`` holds realtime minus ``perf_counter`` ns sampled when
    recording started and when it stopped: added to a span's times they
    put it on the clock of PyTorch's profiler."""

    recording = False
    log: List[Span] = []
    offsets_ns: Tuple[int, int] = (0, 0)
    _unsettled: List[Span] = []  # replays whose events have not been read
    _free_events: Dict[torch.device, list] = {}  # device -> (start, end) timing events to reuse

    def __init__(self, names: Iterable[str] = ()):
        self.totals: Dict[str, float] = dict.fromkeys(names, 0.0)

    def __call__(self, name: str, clip: Optional[int] = None) -> _Timing:
        return _Timing(self.totals, name, clip)

    @classmethod
    @contextlib.contextmanager
    def recorded_if_profiled(cls):
        """Record the block when a ``torch.profiler`` runs as it starts (a
        process-wide flag: the block's other threads are covered too)."""
        if not torch.autograd.profiler._is_profiler_enabled:
            yield
            return
        cls.log, cls._unsettled = [], []
        cls.offsets_ns = (_realtime_offset_ns(), 0)
        cls.recording = True
        try:
            yield
        finally:
            cls.recording = False
            cls.offsets_ns = (cls.offsets_ns[0], _realtime_offset_ns())
            cls.settle()

    @classmethod
    def offset_ns(cls) -> int:
        """perf_counter ns -> realtime ns over the last recording (the mean
        of its two samples)."""
        return (cls.offsets_ns[0] + cls.offsets_ns[1]) // 2

    @staticmethod
    @contextlib.contextmanager
    def within(span: Optional[Span]):
        """Spans this thread opens in the block are children of ``span``
        (one open on another thread); a no-op for None."""
        if span is None:
            yield
            return
        stack = _open_spans()
        stack.append(span)
        try:
            yield
        finally:
            stack.pop()

    @classmethod
    def device_timer(cls, span: Span, device: torch.device):
        """A (start, end) pair of timing events for ``span``, to record on
        the stream of ``device`` that runs the work it times; :meth:`settle`
        reads them."""
        free = cls._free_events.setdefault(device, [])
        start, end = free.pop() if free else (
            torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        span.events = (start, end, device)
        cls._unsettled.append(span)
        return start, end

    @classmethod
    def settle(cls, clip: Optional[int] = None) -> None:
        """Read the device milliseconds of the timed spans of ``clip``
        (every one for None), whose work has ended when the clip's results
        have been read back, and free their events."""
        keep = []
        for span in cls._unsettled:
            if clip is not None and span.clip != clip:
                keep.append(span)
                continue
            start, end, device = span.events
            end.synchronize()  # already over after the clip's read
            span.device_ms = start.elapsed_time(end)
            span.events = None
            cls._free_events[device].append((start, end))
        cls._unsettled = keep
