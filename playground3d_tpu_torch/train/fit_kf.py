"""Kalman-filter parameter fitting from ground-truth tracklets (numpy copy of
``playground3d_tpu/train/fit_kf.py``).

Re-implementation of the reference's ``fit_filter_3D.py``:
  * Q, mu_Q from one-step constant-velocity prediction residuals on GT
    tracklets (fit_filter_3D.py:242-304)
  * R, mu_R from detector-vs-GT measurement residuals (:306-392)
  * per-class mean size + covariance -> the R3 "size nudge" model (:394-441)
  * mean velocity -> mu_v, and P0 from state residual spread (:444-486)

Inputs are plain arrays (tracklets from any source — the synthetic scene
generator or parsed GT CSVs); output is a dict convertible to
:class:`playground3d_tpu_torch.track.kf.KFParams` via ``params_from_arrays``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from playground3d_tpu_torch.utils.constants import DT_DEFAULT, NUM_CLASSES

STATE = 6  # x,y,l,w,h,v
MEAS = 5


def fit_process_noise(tracklets: Sequence[np.ndarray], dts: Optional[Sequence[np.ndarray]] = None) -> Dict[str, np.ndarray]:
    """Q and mu_Q from one-step prediction residuals.

    tracklets: list of [T,7] state7 arrays ([x,y,l,w,h,dir,v]) sampled at
    uniform dt (DT_DEFAULT unless per-tracklet dts given).
    """
    residuals = []
    for k, tr in enumerate(tracklets):
        tr = np.asarray(tr, np.float64)
        dt = DT_DEFAULT if dts is None else dts[k]
        x = np.concatenate([tr[:, :5], tr[:, 6:7]], axis=1)  # drop dir
        d = tr[:, 5]
        # constant-velocity prediction: x' = x + dir*v*dt
        pred = x[:-1].copy()
        pred[:, 0] = pred[:, 0] + d[:-1] * x[:-1, 5] * dt
        residuals.append(x[1:] - pred)
    r = np.concatenate(residuals, axis=0)
    mu_Q = r.mean(0)
    Q = np.cov(r.T) + np.eye(STATE) * 1e-8
    return {"Q": Q, "mu_Q": mu_Q}


def fit_measurement_noise(
    detections: np.ndarray, gt_states: np.ndarray
) -> Dict[str, np.ndarray]:
    """R and mu_R from matched detector measurements vs GT states
    ([n,5] each: x,y,l,w,h)."""
    r = np.asarray(gt_states, np.float64)[:, :MEAS] - np.asarray(detections, np.float64)[:, :MEAS]
    mu_R = r.mean(0)
    R = np.cov(r.T) + np.eye(MEAS) * 1e-8
    return {"R": R, "mu_R": mu_R}


def fit_class_sizes(class_ids: np.ndarray, sizes: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-class mean [l,w,h] and covariance -> class_size / class_covariance
    and the R3 size-nudge measurement covariance."""
    class_ids = np.asarray(class_ids)
    sizes = np.asarray(sizes, np.float64)
    mean = np.zeros((NUM_CLASSES, 3))
    cov = np.tile(np.eye(3), (NUM_CLASSES, 1, 1))
    for c in range(NUM_CLASSES):
        sel = class_ids == c
        if sel.sum() >= 2:
            mean[c] = sizes[sel].mean(0)
            cov[c] = np.cov(sizes[sel].T) + np.eye(3) * 1e-6
        elif sel.sum() == 1:
            mean[c] = sizes[sel][0]
    R3 = cov.mean(0)
    return {
        "class_size": mean,
        "class_covariance": cov,
        "R3": R3,
        "mu_R3": np.zeros(3),
    }


def fit_velocity_prior(tracklets: Sequence[np.ndarray]) -> Dict[str, np.ndarray]:
    vels = np.concatenate([np.asarray(t)[:, 6] for t in tracklets])
    return {"mu_v": np.array(np.abs(vels).mean())}


def fit_initial_covariance(
    detections: np.ndarray, gt_states: np.ndarray, v_spread: float
) -> Dict[str, np.ndarray]:
    """P0: measurement-error covariance padded with the velocity spread."""
    r = np.asarray(gt_states, np.float64)[:, :MEAS] - np.asarray(detections, np.float64)[:, :MEAS]
    P0 = np.eye(STATE)
    P0[:MEAS, :MEAS] = np.cov(r.T) + np.eye(MEAS) * 1e-6
    P0[5, 5] = v_spread
    return {"P": P0, "P0": P0}


def fit_all(
    tracklets: Sequence[np.ndarray],
    detections: np.ndarray,
    gt_states: np.ndarray,
    class_ids: np.ndarray,
    sizes: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Full fitting pass; merge of the four reference stages. The returned
    dict feeds ``playground3d_tpu_torch.track.kf.params_from_arrays``."""
    out: Dict[str, np.ndarray] = {}
    out.update(fit_process_noise(tracklets))
    meas = fit_measurement_noise(detections, gt_states)
    out.update(meas)
    # crop measurements share R in the absence of a separate crop dataset
    out["R2"] = meas["R"].copy()
    out["mu_R2"] = meas["mu_R"].copy()
    out.update(fit_class_sizes(class_ids, sizes))
    out.update(fit_velocity_prior(tracklets))
    vels = np.concatenate([np.asarray(t)[:, 6] for t in tracklets])
    out.update(fit_initial_covariance(detections, gt_states, float(np.var(vels) + 1.0)))
    return out


def save_kf_params(path: str, params: Dict[str, np.ndarray]) -> None:
    """npz persistence (replaces the reference's kf_params_save2.cpkl pickle,
    fit_filter_3D.py:490-491)."""
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})


def load_kf_params(path: str) -> Dict[str, np.ndarray]:
    z = np.load(path, allow_pickle=False)
    return {k: z[k] for k in z.files}
