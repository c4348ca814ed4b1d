"""The readers of the program's spans on hand-made spans, offsets and CUDA
intervals: ``host_gather_ms_per_frame``, ``idle_await_producer_pct``,
``idle_consumer_host_pct`` and ``detect_frame_ms``. Each reads None where
the program recorded nothing."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from cellbench.manifest import Manifest
from playground3d_tpu_torch.utils.profiling import Span, Spans

MAN = Manifest()
OFFSET = 10_000  # perf_counter ns -> the profiler's realtime ns
NEW = ("host_gather_ms_per_frame", "idle_await_producer_pct", "idle_consumer_host_pct", "detect_frame_ms")


def span(name, start, end, parent=None, clip=None, thread=1, device_ms=None):
    sp = Span(name, parent, clip)
    sp.start_ns, sp.end_ns, sp.thread, sp.device_ms = start, end, thread, device_ms
    return sp


def clip_loop():
    """A call [0, 1000) perf ns: the consumer's two cycles and a producer's
    span on another thread."""
    root = span("track_clips", 0, 1000)
    drain = span("drain", 300, 500, root, 0)
    return [
        root,
        span("get_wait", 0, 100, root, 0), span("enqueue", 100, 300, root, 0), drain,
        span("drain_wait", 320, 400, drain), span("replay.frame", 120, 140, span("enqueue", 100, 300, root, 0)),
        span("get_wait", 500, 600, root, 4), span("enqueue", 600, 800, root, 4), span("drain", 800, 950, root, 4),
        span("stage", 0, 990, root, 4, thread=2),
    ]


class Ev:
    def __init__(self, start, end, device=DeviceType.CUDA):
        self.s, self.e, self.d = start, end, device

    def device_type(self):
        return self.d

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.e - self.s


# device activity, realtime ns: idle over the call [10,000, 11,000) at
# [10,050, 10,150) (get_wait's end and enqueue's start: 50 + 50),
# [10,330, 10,360) (inside drain_wait), [10,400, 10,450) (drain past its
# wait) and [10,950, 11,000) (after the consumer's last span)
BUSY = [(9_900, 10_050), (10_150, 10_330), (10_200, 10_250), (10_360, 10_400), (10_450, 10_950),
        (11_000, 11_100)]


def prof(busy=BUSY):
    events = [Ev(s, e) for s, e in busy] + [Ev(10_000, 11_000, DeviceType.CPU)]  # a host event: not the card's
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))


def ctx(**kw):
    base = dict(camera_frames=600, timers={"stage": 0.3, "source": 0.1, "stack": 0.2},
                trace=SimpleNamespace(prof=prof()))
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.fixture
def recorded(monkeypatch):
    def put(log, offsets=(OFFSET, OFFSET)):
        monkeypatch.setattr(Spans, "log", log)
        monkeypatch.setattr(Spans, "offsets_ns", offsets)
    return put


def test_host_gather_reads_source_and_stack():
    assert MAN.reader("host_gather_ms_per_frame").read(ctx()) == pytest.approx(0.5)
    # a program without the producer's gather spans (the totals it had before them)
    assert MAN.reader("host_gather_ms_per_frame").read(ctx(timers={"stage": 0.3})) is None


def test_idle_split_labels_each_idle_ns(recorded):
    split = MAN.reader("idle_await_producer_pct").split
    parts = split(clip_loop(), OFFSET, [s for s, _ in BUSY], [e for _, e in BUSY])
    assert parts == {"await_producer": 50, "consumer_host": 50 + 50, "drain_wait": 30, "elsewhere": 50, "call": 1000}
    # the offset moves the spans: 50 ns later, the first gap lies in get_wait alone
    later = split(clip_loop(), OFFSET + 50, [s for s, _ in BUSY], [e for _, e in BUSY])
    assert later["await_producer"] == 100 and later["call"] == 1000
    recorded(clip_loop())
    c = ctx()
    assert MAN.reader("idle_await_producer_pct").read(c) == pytest.approx(5.0)
    assert MAN.reader("idle_consumer_host_pct").read(c) == pytest.approx(10.0)
    # the labels add up to the card's idle share of the call
    assert sum(c.idle_split.values()) == pytest.approx(23.0)


def test_idle_split_without_a_gap(recorded):
    recorded(clip_loop())
    c = ctx(trace=SimpleNamespace(prof=prof([(9_000, 12_000)])))
    assert MAN.reader("idle_await_producer_pct").read(c) == 0.0
    assert MAN.reader("idle_consumer_host_pct").read(c) == 0.0


def test_detect_frame_ms_reads_the_replays_events(recorded):
    root = span("track_clips", 0, 1000)
    enq = span("enqueue", 0, 900, root, 0)
    recorded([root, enq] + [span(f"replay.{name}", 10 * i, 10 * i + 5, enq, device_ms=ms) for i, (name, ms) in
                            enumerate([("frame", 40.0), ("detect", 1.5), ("crop", 2.0), ("passthrough", 0.2),
                                       ("frame", 41.0), ("detect", 1.5)])])
    assert MAN.reader("detect_frame_ms").read(ctx()) == pytest.approx((40.0 + 1.5 + 41.0 + 1.5) / 2)


def test_readers_read_none_without_a_recording(recorded):
    recorded([])
    for name in NEW[1:]:
        assert MAN.reader(name).read(ctx()) is None, name
    recorded(clip_loop())
    for name in NEW[1:3]:
        assert MAN.reader(name).read(ctx(trace=None)) is None, name  # no device trace
    assert MAN.reader("detect_frame_ms").read(ctx()) is None  # replays not timed on a device


def test_new_metrics_are_the_cells():
    mine = {m["name"]: m for m in MAN.data["per_layer"] if m["name"] in NEW}
    assert set(mine) == set(NEW)
    for name, m in mine.items():
        reader = MAN.reader(name)
        assert (m["unit"], m["layer"], m["moves"], m["source"]) == (reader.UNIT, reader.LAYER, reader.MOVES,
                                                                   reader.SOURCE)
        assert m["workloads"] == ["r50_s2d_int8.pole6_yuv_backlog"]
