"""Ground-truth annotation session: the reference manual annotators' label
operations, headless.

A numpy copy of ``playground3d_tpu/tools/annotator.py`` with its imports pointed
at the port's modules.

The reference ships four generations of interactive OpenCV annotators
(manual_annotator_state*.py, up to 4.4k LoC) whose value is the *operations*
on the label store, not the keybinding shell. This module implements those
operations on a time-indexed label store so they are scriptable and
testable; an interactive shell can wrap them where a GUI stack exists.

Implemented operation parity (reference file:line in manual_annotator_state_v3.py):
  * box add / delete / shift / dimension edit / class edit in *state* space
  * copy-paste forward and constant-velocity interpolation between keyframes
  * crop-detector-assisted auto-labeling (``automate``/:644, crop_detect:699)
  * spline trajectory fitting (``create_trajectory``/:1209)
  * per-camera time-bias solve from trajectories
    (``adjust_ts_with_trajectories``/:1518)
  * homography re-fit from accumulated correspondences
    (``replace_homography``/:1801)
  * outlier removal by trajectory residual (:2364)
  * reprojection-error analysis (:2421-2775)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from playground3d_tpu_torch.evaluation import geometry_np as G


@dataclass
class Label:
    t: float
    state7: np.ndarray  # [7]
    class_id: int


@dataclass
class AnnotationSession:
    """Label store keyed by object id; all edits in roadway-state space."""

    labels: Dict[int, List[Label]] = field(default_factory=dict)
    next_id: int = 0

    # -- basic edits ---------------------------------------------------------
    def add_box(self, t: float, state7, class_id: int, obj_id: Optional[int] = None) -> int:
        if obj_id is None:
            obj_id = self.next_id
            self.next_id += 1
        self.next_id = max(self.next_id, obj_id + 1)
        self.labels.setdefault(obj_id, []).append(
            Label(t, np.asarray(state7, np.float64).copy(), class_id)
        )
        self.labels[obj_id].sort(key=lambda l: l.t)
        return obj_id

    def delete_box(self, obj_id: int, t: float, tol: float = 1e-6) -> None:
        self.labels[obj_id] = [l for l in self.labels[obj_id] if abs(l.t - t) > tol]

    def shift(self, obj_id: int, t: float, dx: float = 0.0, dy: float = 0.0) -> None:
        for l in self.labels[obj_id]:
            if abs(l.t - t) < 1e-6:
                l.state7[0] += dx
                l.state7[1] += dy

    def resize(self, obj_id: int, t: float, dl=0.0, dw=0.0, dh=0.0) -> None:
        for l in self.labels[obj_id]:
            if abs(l.t - t) < 1e-6:
                l.state7[2] += dl
                l.state7[3] += dw
                l.state7[4] += dh

    def set_class(self, obj_id: int, class_id: int) -> None:
        for l in self.labels[obj_id]:
            l.class_id = class_id

    def paste_forward(self, obj_id: int, t_from: float, t_to: float) -> None:
        """Copy the label at t_from to t_to with constant-velocity rollforward
        (the annotators' copy-paste-advance workflow)."""
        src = min(self.labels[obj_id], key=lambda l: abs(l.t - t_from))
        s = src.state7.copy()
        s[0] += s[5] * s[6] * (t_to - t_from)
        self.add_box(t_to, s, src.class_id, obj_id)

    def interpolate(self, obj_id: int, hz: float = 30.0) -> None:
        """Fill between keyframes at uniform rate by linear interpolation of
        the state (v3 interpolate workflow)."""
        ls = sorted(self.labels[obj_id], key=lambda l: l.t)
        if len(ls) < 2:
            return
        out = []
        for a, b in zip(ls[:-1], ls[1:]):
            n = max(int(round((b.t - a.t) * hz)), 1)
            for k in range(n):
                f = k / n
                s = a.state7 * (1 - f) + b.state7 * f
                s[5] = a.state7[5]
                out.append(Label(a.t + f * (b.t - a.t), s, a.class_id))
        out.append(ls[-1])
        self.labels[obj_id] = out

    # -- trajectory fitting ---------------------------------------------------
    def fit_trajectory(self, obj_id: int, smoothing: float = 1.0):
        """Smoothing-spline x(t), y(t) fit (reference create_trajectory,
        v3:1209). Returns callables (fx, fy)."""
        from scipy.interpolate import UnivariateSpline

        ls = sorted(self.labels[obj_id], key=lambda l: l.t)
        ts = np.array([l.t for l in ls])
        xs = np.array([l.state7[0] for l in ls])
        ys = np.array([l.state7[1] for l in ls])
        t0 = ts[0]
        k = min(3, len(ts) - 1)
        fx = UnivariateSpline(ts - t0, xs, k=k, s=smoothing * len(ts))
        fy = UnivariateSpline(ts - t0, ys, k=k, s=smoothing * len(ts))
        return (lambda t: fx(np.asarray(t) - t0)), (lambda t: fy(np.asarray(t) - t0))

    def remove_outliers(self, obj_id: int, sigma: float = 3.0, window: int = 5) -> int:
        """Drop labels whose x deviates > sigma robust-stds from the local
        median trajectory (reference v3:2364; a smoothing spline chases
        isolated spikes, so the residual baseline is a rolling median).
        Returns number removed."""
        ls = sorted(self.labels[obj_id], key=lambda l: l.t)
        if len(ls) < 5:
            return 0
        from scipy.signal import medfilt

        xs = np.array([l.state7[0] for l in ls])
        pad = window // 2
        padded = np.concatenate([xs[:1].repeat(pad), xs, xs[-1:].repeat(pad)])
        res = xs - medfilt(padded, window)[pad:-pad]
        mad = np.median(np.abs(res - np.median(res)))
        # absolute floor: near-noiseless tracks have MAD ~ 0 and would flag
        # ordinary labels; deviations under 2 ft are never outliers
        thresh = max(sigma * 1.4826 * mad, 2.0)
        keep = np.abs(res) <= thresh
        removed = int((~keep).sum())
        self.labels[obj_id] = [l for l, k in zip(ls, keep) if k]
        return removed

    def solve_ts_bias(
        self,
        camera_observations: Dict[str, List[Tuple[int, float, float]]],
        reference_camera: str,
    ) -> Dict[str, float]:
        """Least-squares per-camera clock bias from trajectories
        (reference adjust_ts_with_trajectories, v3:1518).

        camera_observations: camera -> [(obj_id, t_reported, x_observed)].
        Fits each object's x(t) spline from the session labels, then solves
        bias_c = mean over observations of (t_true(x_obs) - t_reported),
        anchored at the reference camera.
        """
        biases = {}
        for cam, obs in camera_observations.items():
            errs = []
            for obj_id, t_rep, x_obs in obs:
                ls = sorted(self.labels[obj_id], key=lambda l: l.t)
                if len(ls) < 2:
                    continue
                ts = np.array([l.t for l in ls])
                xs = np.array([l.state7[0] for l in ls])
                order = np.argsort(xs)
                # invert x(t) (monotone along direction of travel)
                t_true = np.interp(x_obs, xs[order], ts[order])
                errs.append(t_true - t_rep)
            biases[cam] = float(np.mean(errs)) if errs else 0.0
        ref = biases.get(reference_camera, 0.0)
        return {c: b - ref for c, b in biases.items()}

    def refit_homography(self, im_points: np.ndarray, space_points: np.ndarray) -> np.ndarray:
        """Re-fit a camera homography from accumulated correspondence clicks
        (reference replace_homography, v3:1801)."""
        from playground3d_tpu_torch.geometry.homography import fit_homography

        return fit_homography(im_points, space_points)

    def reprojection_errors(self, obj_id: int, H: np.ndarray, P: np.ndarray) -> np.ndarray:
        """Per-label top+bottom reprojection error analysis (v3:2421-2775):
        state -> im -> state -> im roundtrip pixel error."""
        ls = sorted(self.labels[obj_id], key=lambda l: l.t)
        states = np.stack([l.state7 for l in ls])
        im = G.state_to_im(states, P)
        heights = states[:, 4]
        back = G.im_to_state(im, H, heights)
        repro = G.state_to_im(
            np.concatenate([back, states[:, 6:7]], axis=1), P
        )
        return np.sqrt(((im - repro) ** 2).sum(-1)).mean(-1)

    # -- auto-labeling ---------------------------------------------------------
    def auto_label(
        self, detections_state: np.ndarray, classes: np.ndarray, t: float,
        match_radius_ft: float = 10.0,
    ) -> List[int]:
        """Crop/full-detector-assisted labeling (reference automate, v3:644):
        detections matching an existing object's predicted position update
        it; others create new objects. Returns affected ids."""
        affected = []
        for det, cls in zip(detections_state, classes):
            best_id, best_d = None, match_radius_ft
            for oid, ls in self.labels.items():
                last = max(ls, key=lambda l: l.t)
                pred_x = last.state7[0] + last.state7[5] * last.state7[6] * (t - last.t)
                d = abs(pred_x - det[0]) + abs(last.state7[1] - det[1])
                if d < best_d:
                    best_id, best_d = oid, d
            s7 = np.concatenate([det[:6], [0.0]]) if len(det) == 6 else np.asarray(det)
            if best_id is None:
                affected.append(self.add_box(t, s7, int(cls)))
            else:
                self.add_box(t, s7, int(cls), best_id)
                affected.append(best_id)
        return affected

    # -- persistence ----------------------------------------------------------
    def save(self, path: str) -> None:
        rows = []
        for oid, ls in self.labels.items():
            for l in ls:
                rows.append([oid, l.t, l.class_id] + list(l.state7))
        np.savez(path, rows=np.asarray(rows, np.float64))

    @classmethod
    def load(cls, path: str) -> "AnnotationSession":
        z = np.load(path)
        sess = cls()
        for row in z["rows"]:
            sess.add_box(row[1], row[3:10], int(row[2]), int(row[0]))
        return sess
