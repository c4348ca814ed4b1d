"""The source that feeds ``MultiCameraTracker.track_clips`` and the spans the
benchmark keeps around what it hands over and what it calls.

The source is a closed-loop backlog: every camera's frames are ready, so
the tracker's producer thread takes the next one as soon as it asks. The
frames come from a ring made in set-up; only the program's own work
happens per frame. A run of the source stops at a clip boundary, after a
fixed number of frames (warm-up) or once a deadline has passed (the
window).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np


class Backlog:
    """Per-camera streams of (frame, timestamp) over global frames from
    ``first``: camera ``c``'s frame ``k`` is ``rings[c, (k + offs[c]) %
    ring]`` at ``t0 + k / fps + jitter[c]``. The streams stop together at a
    clip boundary: after ``n_frames`` frames, or at the first boundary
    reached after ``deadline`` (``time.perf_counter()`` seconds)."""

    def __init__(self, rings: np.ndarray, offs: List[int], t0: float, fps: float, jitter: np.ndarray,
                 clip_len: int, first: int, n_frames: Optional[int] = None, deadline: Optional[float] = None):
        self.rings, self.offs, self.t0, self.fps, self.jitter = rings, offs, t0, fps, jitter
        self.clip_len, self.first, self.n_frames, self.deadline = clip_len, first, n_frames, deadline
        self._go: dict = {}  # global frame -> whether the streams hand it over
        self._lock = threading.Lock()
        self.handed: List[int] = []  # perf_counter ns at which each clip's last frame was handed over
        self.end = first  # one past the last global frame handed over

    def _more(self, k: int) -> bool:
        with self._lock:
            go = self._go.get(k)
            if go is None:
                if (k - self.first) % self.clip_len:
                    go = True
                elif self.n_frames is not None:
                    go = k - self.first < self.n_frames
                else:
                    go = time.perf_counter() < self.deadline
                self._go[k] = go
            return go

    def timestamp(self, c: int, k: int) -> float:
        return self.t0 + k / self.fps + float(self.jitter[c])

    def _camera(self, c: int):
        ring = self.rings.shape[1]
        k = self.first
        while self._more(k):
            frame = self.rings[c, (k + self.offs[c]) % ring]
            if c == len(self.offs) - 1:
                self.end = k + 1
                if (k + 1 - self.first) % self.clip_len == 0:
                    self.handed.append(time.perf_counter_ns())
            yield frame, self.timestamp(c, k)
            k += 1

    def streams(self):
        return [self._camera(c) for c in range(self.rings.shape[0])]


class Recorder:
    """The clip step the tracker runs, passed through: each call's inputs
    (the state, clock bias and camera times it starts from, and its first
    global frame) and its span on the host clock are kept. The state a call
    starts from is the one the call before returned, so consecutive calls
    hand the check each clip's start and end."""

    def __init__(self, clip):
        self.clip = clip
        self.runners, self.shard_runners = clip.runners, clip.shard_runners
        self.base = 0  # global frame of the current ``track_clips`` call's frame 0
        self.calls: list = []  # (state, ts_bias, cam_times, global first frame)
        self.spans: list = []  # (start, end) perf_counter ns of each call

    def __call__(self, state, ts_bias, frames, cam_times, frame0: int):
        t0 = time.perf_counter_ns()
        out = self.clip(state, ts_bias, frames, cam_times, frame0)
        self.spans.append((t0, time.perf_counter_ns()))
        self.calls.append((state, ts_bias, cam_times, self.base + int(frame0)))
        return out
