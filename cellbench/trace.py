"""The device's side of a traced window, from PyTorch's profiler (CUDA
activity only: kernels, copies and fills on every stream), and the
benchmark's own host spans that label where the device sat idle."""

from __future__ import annotations

import re
import time
from typing import Dict, List, Tuple

import numpy as np

_ANON = re.compile(r"\(anonymous namespace\)::(\w+)")


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its argument list, cut to ``width``."""
    name = name.replace("void ", "", 1).replace("(anonymous namespace)", "anon")
    return name.split("(", 1)[0][:width]


def busy_and_gaps(starts, ends, lo_ns: int, hi_ns: int, n_gaps: int = 10):
    """(seconds in which some interval [start, end) ran within [lo_ns,
    hi_ns], the ``n_gaps`` longest idle (start, end), longest first)."""
    order = np.argsort(np.asarray(starts, np.int64), kind="stable")
    s = np.clip(np.asarray(starts, np.int64)[order], lo_ns, hi_ns)
    e = np.clip(np.asarray(ends, np.int64)[order], lo_ns, hi_ns)
    reach = np.maximum.accumulate(e)  # the latest end so far: an interval starting past it opens a gap
    gap_lo = np.concatenate([[lo_ns], reach])
    gap_hi = np.concatenate([s, [hi_ns]])
    idle = np.clip(gap_hi - gap_lo, 0, None)
    top = np.argsort(-idle, kind="stable")[:n_gaps]
    return (hi_ns - lo_ns - int(idle.sum())) / 1e9, [(int(gap_lo[i]), int(gap_hi[i])) for i in top if idle[i] > 0]


class DeviceTrace:
    """Start before the window, stop after it; then :meth:`read`."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.kernels: Dict[str, List[float]] = {}  # name -> [device seconds, launches]
        self.busy_s = 0.0
        self.gaps: List[Tuple[int, int]] = []  # idle (start, end) realtime ns, longest first
        self.events = 0

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()  # synchronizes the device first

    def read(self, lo_ns: int, hi_ns: int) -> None:
        """Busy time, kernels by name and idle gaps over [lo_ns, hi_ns]
        (realtime ns, the profiler's clock)."""
        from torch.autograd import DeviceType

        starts, ends = [], []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            s = ev.start_ns()
            e = s + ev.duration_ns()
            starts.append(s)
            ends.append(e)
            slot = self.kernels.setdefault(ev.name(), [0.0, 0])
            slot[0] += (e - s) / 1e9
            slot[1] += 1
        self.events = len(starts)
        if starts:
            self.busy_s, self.gaps = busy_and_gaps(starts, ends, lo_ns, hi_ns)

    def kernel_seconds(self, names) -> Tuple[float, int]:
        """Device seconds and launches of the kernels of the port named
        ``names`` (each a function in an anonymous namespace of a
        ``csrc/*.cu``)."""
        want, secs, n = set(names), 0.0, 0
        for name, (s, k) in self.kernels.items():
            m = _ANON.search(name)
            if m and m.group(1) in want:
                secs += s
                n += k
        return secs, n

    def top_ops(self, n: int = 10) -> List[list]:
        by_short: Dict[str, float] = {}
        for name, (s, _) in self.kernels.items():
            key = short_name(name)
            by_short[key] = by_short.get(key, 0.0) + s
        return [[k, v] for k, v in sorted(by_short.items(), key=lambda kv: -kv[1])[:n]]


def label_gaps(gaps: List[Tuple[int, int]], calls: List[Tuple[int, int]], handed: List[int],
               offset_ns: int) -> List[list]:
    """Each gap [name, seconds], named by what the host was doing when the
    device fell idle: ``in_enqueue`` inside a clip call, ``await_producer``
    between calls while the next clip's last frame had not been handed
    over, ``between_calls`` otherwise (the read-back and unpacking of the
    clip three behind, the packing of the rows), ``before_first_call``
    (the first clip's fill) or ``after_last_call``. ``calls`` and
    ``handed`` are perf_counter ns (``offset_ns`` converts them to the
    gaps' realtime ns); ``handed[j]`` is when window clip ``j``'s last
    frame was handed over, ``calls[j]`` the span of its call."""
    starts = np.asarray([c[0] + offset_ns for c in calls], np.int64)
    out = []
    for lo, hi in gaps:
        j = int(np.searchsorted(starts, lo, side="right")) - 1  # the last call begun by lo
        if j < 0:
            what = "before_first_call"
        elif lo < calls[j][1] + offset_ns:
            what = "in_enqueue"
        elif j + 1 >= len(calls):
            what = "after_last_call"
        elif j + 1 < len(handed) and handed[j + 1] + offset_ns > lo:
            what = "await_producer"
        else:
            what = "between_calls"
        out.append([what, (hi - lo) / 1e9])
    return out


def clock_offset_ns() -> int:
    """realtime ns - perf_counter ns, now."""
    return time.time_ns() - time.perf_counter_ns()
