"""Tracking-data playback and resampling (reference datareader.py; copy of
``playground3d_tpu/evaluation/datareader.py``).

Parses 46-column tracking CSVs into time-indexed structures, supports
constant-velocity rollforward of states to arbitrary query times (the
reference's synchronized multi-camera playback, datareader.py:294-345), and
uniform-rate reinterpolation (datareader.py:401-452), plus the
duplicate-frame/timestamp integrity check (datareader.py:586-653).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from playground3d_tpu_torch.evaluation.csv_io import load_i24_csv_by_time


@dataclass
class TimeIndexedTracks:
    """All rows of a time-indexed tracking CSV, grouped by object id."""

    times: Dict[int, np.ndarray]  # id -> [t] sorted timestamps
    states: Dict[int, np.ndarray]  # id -> [t,7] state7 rows
    classes: Dict[int, str]

    @classmethod
    def from_csv(cls, path: str) -> "TimeIndexedTracks":
        rows = load_i24_csv_by_time(path)
        times: Dict[int, List[float]] = {}
        states: Dict[int, List[np.ndarray]] = {}
        classes: Dict[int, str] = {}
        for t, oid, cname, state in rows:
            times.setdefault(oid, []).append(t)
            states.setdefault(oid, []).append(state)
            classes[oid] = cname
        out_t, out_s = {}, {}
        for oid in times:
            order = np.argsort(times[oid])
            out_t[oid] = np.asarray(times[oid])[order]
            out_s[oid] = np.stack(states[oid])[order]
        return cls(times=out_t, states=out_s, classes=classes)

    def ids(self) -> List[int]:
        return sorted(self.times.keys())

    def span(self) -> Tuple[float, float]:
        lo = min(t[0] for t in self.times.values())
        hi = max(t[-1] for t in self.times.values())
        return lo, hi


def rollforward(state7: np.ndarray, dt: float) -> np.ndarray:
    """Constant-velocity advance: x += dir * v * dt
    (reference datareader.py:343-345)."""
    out = np.array(state7, dtype=np.float64, copy=True)
    out[..., 0] = out[..., 0] + out[..., 5] * out[..., 6] * dt
    return out


def states_at(tracks: TimeIndexedTracks, t_query: float, max_extrapolate: float = 0.5):
    """States of all objects alive at ``t_query``: nearest earlier sample
    rolled forward at constant velocity. Returns (ids, [n,7] states)."""
    ids, states = [], []
    for oid in tracks.ids():
        ts = tracks.times[oid]
        if t_query < ts[0] - 1e-9 or t_query > ts[-1] + max_extrapolate:
            continue
        k = int(np.searchsorted(ts, t_query, side="right")) - 1
        k = max(k, 0)
        states.append(rollforward(tracks.states[oid][k], t_query - ts[k]))
        ids.append(oid)
    return ids, (np.stack(states) if states else np.zeros((0, 7)))


def reinterpolate(
    tracks: TimeIndexedTracks, hz: float = 30.0, t0: Optional[float] = None
) -> TimeIndexedTracks:
    """Resample every track onto a uniform clock by linear interpolation of
    the state (velocity-consistent for x; sizes interpolate smoothly)
    (reference datareader.py:401-452)."""
    lo, hi = tracks.span()
    if t0 is None:
        t0 = lo
    grid_all = t0 + np.arange(0, hi - t0 + 1e-9, 1.0 / hz)

    out_t, out_s = {}, {}
    for oid in tracks.ids():
        ts = tracks.times[oid]
        st = tracks.states[oid]
        sel = (grid_all >= ts[0] - 1e-9) & (grid_all <= ts[-1] + 1e-9)
        grid = grid_all[sel]
        if len(grid) == 0:
            continue
        # interpolate in epoch-relative time: UNIX-seconds magnitudes eat
        # float64 precision inside interp
        cols = [np.interp(grid - t0, ts - t0, st[:, j]) for j in range(7)]
        new = np.stack(cols, axis=1)
        new[:, 5] = np.sign(new[:, 5]) + (new[:, 5] == 0)  # direction stays +-1
        out_t[oid] = grid
        out_s[oid] = new
    return TimeIndexedTracks(times=out_t, states=out_s, classes=dict(tracks.classes))


def test_integrity(timestamps: Sequence[float]) -> Dict[str, int]:
    """Count duplicate/backward timestamps in a sequence (the data-quality
    check of reference datareader.py:586-653, minus the raw-video frame
    diffing which needs the original recordings)."""
    ts = np.asarray(timestamps, dtype=np.float64)
    d = np.diff(ts)
    return {
        "n": len(ts),
        "duplicate_ts": int((d == 0).sum()),
        "backward_ts": int((d < 0).sum()),
        "gaps_over_100ms": int((d > 0.1).sum()),
    }
