"""The share of the program's recorded ``track_clips`` call in which no
kernel, copy or fill ran on the device while the tracker's consumer waited
for the producer's next staged clip (its ``get_wait`` span): the card
starved by the producer.

The device's idle intervals within the call (profiler, CUDA activity) are
laid over the consumer's spans, moved onto the profiler's clock by the
program's recorded offset. :func:`split` labels every idle nanosecond of
the call; ``idle_consumer_host_pct`` reads the same split."""

from typing import Optional

import numpy as np

from cellbench.trace import busy_and_gaps

UNIT = "%"
LAYER = "clip loop (pipeline/multi_cam.py track_clips)"
MOVES = "camera_frames_per_s"
SOURCE = "program_span"
TRACED = True


def recorded_spans():
    """(the program's span log, its perf_counter -> realtime ns offset), or
    None where the program keeps no such log or recorded nothing."""
    try:
        from playground3d_tpu_torch.utils.profiling import Spans
    except ImportError:
        return None
    if not Spans.log:
        return None
    return Spans.log, Spans.offset_ns()


def device_intervals(prof):
    """(starts, ends) realtime ns of every CUDA activity in the profiler's
    trace."""
    from torch.autograd import DeviceType

    starts, ends = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            starts.append(ev.start_ns())
            ends.append(ev.start_ns() + ev.duration_ns())
    return starts, ends


def split(spans, offset_ns: int, starts, ends) -> Optional[dict]:
    """Idle ns of the device within the recorded ``track_clips`` call (its
    span moved by ``offset_ns``), by what the consumer was doing:
    ``await_producer`` (in ``get_wait``), ``consumer_host`` (in ``enqueue``,
    or in ``drain`` outside its ``drain_wait``), ``drain_wait``, and
    ``elsewhere`` (outside the consumer's spans); ``call``: the call's ns.
    None without one recorded call or any device activity."""
    roots = [s for s in spans if s.name == "track_clips" and s.parent is None]
    if len(roots) != 1 or not len(starts):
        return None
    root = roots[0]
    lo, hi = root.start_ns + offset_ns, root.end_ns + offset_ns
    _, gaps = busy_and_gaps(starts, ends, lo, hi, n_gaps=len(starts) + 1)
    gaps = np.asarray(sorted(gaps), np.int64).reshape(-1, 2)  # disjoint: by start
    length = gaps[:, 1] - gaps[:, 0]
    before = np.concatenate([[0], np.cumsum(length)])  # idle ns before each gap

    def idle_until(t):
        """Idle ns of the call before each realtime ns of ``t``."""
        k = np.searchsorted(gaps[:, 0], t, side="right") - 1
        j = np.maximum(k, 0)
        return np.where(k < 0, 0, before[j] + np.clip(t - gaps[j, 0], 0, length[j]))

    def idle_in(intervals) -> int:
        if not intervals or not len(gaps):
            return 0
        a = np.asarray(intervals, np.int64) + offset_ns
        return int((idle_until(a[:, 1]) - idle_until(a[:, 0])).sum())

    consumer = [s for s in spans if s.parent is root and s.thread == root.thread]
    drains = {s for s in consumer if s.name == "drain"}
    waits = [(s.start_ns, s.end_ns) for s in spans if s.name == "drain_wait" and s.parent in drains]
    out = {
        "await_producer": idle_in([(s.start_ns, s.end_ns) for s in consumer if s.name == "get_wait"]),
        "consumer_host": idle_in([(s.start_ns, s.end_ns) for s in consumer if s.name in ("enqueue", "drain")]),
        "drain_wait": idle_in(waits),
    }
    out["consumer_host"] -= out["drain_wait"]
    out["elsewhere"] = int(before[-1]) - sum(out.values())
    out["call"] = hi - lo
    return out


def idle_shares(ctx) -> Optional[dict]:
    """:func:`split` of the window's call as shares of the call, %; kept on
    ``ctx`` for the readers that share it."""
    if not hasattr(ctx, "idle_split"):
        ctx.idle_split = None
        rec = recorded_spans()
        if rec is not None and ctx.trace is not None:
            parts = split(*rec, *device_intervals(ctx.trace.prof))
            if parts is not None:
                ctx.idle_split = {k: 100.0 * v / parts["call"] for k, v in parts.items() if k != "call"}
    return ctx.idle_split


def read(ctx):
    shares = idle_shares(ctx)
    return None if shares is None else shares["await_producer"]
