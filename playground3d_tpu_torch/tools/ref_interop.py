"""Reference-artifact interop (numpy port of
``playground3d_tpu/tools/ref_interop.py``).

Converters from the reference stack's pickled artifacts into this
framework's npz-backed structures, plus a camera fitter that recovers a
working homography directly from the reference's committed 46-column
tracking CSVs:

* ``registry_from_reference_pickle`` — reads the reference's homography
  pickles (``i24_all_homography.cpkl`` / ``Homography_Wrapper``; structure
  at reference homography.py:336-380 ``add_correspondence`` and :816-827)
  into a :class:`CameraRegistry`. The pickle is loaded with a RESTRICTED
  unpickler: only numpy/torch tensor reconstructors are executed; the
  reference's own classes are materialized as inert attribute shells, so no
  reference code runs.
* ``kf_params_from_reference_pickle`` — reads the fitted filter constants
  (``kf_params_save2.cpkl``, reference fit_filter_3D.py:490-491; key layout
  at util_track/kf.py:71-97) into a :class:`KFParams`.
* ``fit_camera_from_tracking_csv`` — every row of the reference's tracking
  CSVs carries BOTH the 8 image-space corners and the 4 roadway-footprint
  coordinates (columns 11:27 and 27:35, header at
  3D_tracking_results.csv:1). The bottom-corner pairs are exact
  image<->space ground-plane correspondences and the corner structure gives
  all three vanishing points, so a camera's full homography + projection can
  be re-fit from the committed data alone — no pickle required.
"""

from __future__ import annotations

import io
import pickle
from typing import Dict, Optional, Tuple

import numpy as np

from playground3d_tpu_torch import DeviceLike
from playground3d_tpu_torch.evaluation.csv_io import load_i24_csv
from playground3d_tpu_torch.geometry.homography import CameraRegistry
from playground3d_tpu_torch.track.kf import KFParams, default_params

__all__ = [
    "load_reference_pickle",
    "registry_from_reference_pickle",
    "kf_params_from_reference_pickle",
    "fit_camera_from_tracking_csv",
]


class _Opaque:
    """Inert stand-in for reference classes inside pickles: absorbs state
    without executing any reference code."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


_SAFE_ROOTS = ("numpy", "torch", "collections", "builtins", "_codecs", "copyreg")


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _SAFE_ROOTS:
            return super().find_class(module, name)
        # any reference-repo class becomes an inert shell
        return type(name, (_Opaque,), {"__module__": module})


def load_reference_pickle(path: str):
    with open(path, "rb") as f:
        return _RestrictedUnpickler(f).load()


def _np(x) -> np.ndarray:
    """torch tensor / numpy / list -> float64 numpy, squeezing the
    reference's leading unsqueeze(0) batch dims on square matrices."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    a = np.asarray(x, dtype=np.float64)
    while a.ndim >= 3 and a.shape[0] == 1:
        a = a[0]
    return a


def _insert_correspondences(reg: CameraRegistry, hg, bank: str) -> None:
    corr = getattr(hg, "correspondence", None)
    if corr is None and isinstance(hg, dict):
        corr = hg
    assert corr is not None, "not a reference Homography pickle"
    for name, cor in corr.items():
        if isinstance(cor, _Opaque):
            cor = cor.__dict__
        reg._insert(
            name,
            _np(cor["H"]),
            _np(cor["H_inv"]),
            _np(cor["P"]),
            _np(cor["vps"]),
            bank,
        )


def registry_from_reference_pickle(path: str) -> CameraRegistry:
    """Reference homography pickle (Homography or Homography_Wrapper) ->
    CameraRegistry with EB/WB banks."""
    obj = load_reference_pickle(path)
    reg = CameraRegistry()
    if hasattr(obj, "hg1"):  # Homography_Wrapper (homography.py:816-827)
        _insert_correspondences(reg, obj.hg1, "eb")
        _insert_correspondences(reg, obj.hg2, "wb")
    else:
        _insert_correspondences(reg, obj, "both")
    return reg


def kf_params_from_reference_pickle(path: str, device: DeviceLike = None) -> KFParams:
    """Reference ``kf_params*.cpkl`` (fit_filter_3D.py:490-491) -> KFParams
    on ``device`` (the card unless the caller asks for the CPU). Missing
    optional models (R2/R3/mu_v/class stats) keep our defaults."""
    import torch

    init = load_reference_pickle(path)
    if isinstance(init, _Opaque):
        init = init.__dict__
    base = default_params(device=device)

    def take(key, cur):
        if key in init:
            return torch.as_tensor(_np(init[key]), dtype=torch.float32, device=cur.device)
        return cur

    return base._replace(
        F=take("F", base.F),
        H=take("H", base.H),
        R=take("R", base.R),
        mu_R=take("mu_R", base.mu_R).reshape(-1),
        Q=take("Q", base.Q),
        mu_Q=take("mu_Q", base.mu_Q).reshape(-1),
        P0=take("P", base.P0),
        H2=take("H2", base.H2),
        R2=take("R2", base.R2),
        mu_R2=take("mu_R2", base.mu_R2).reshape(-1),
        H3=take("H3", base.H3),
        R3=take("R3", base.R3),
        mu_R3=take("mu_R3", base.mu_R3).reshape(-1),
        mu_v=take("mu_v", base.mu_v).reshape(()),
        class_size=take("class_size", base.class_size),
        class_covariance=take("class_covariance", base.class_covariance),
    )


# ---------------------------------------------------------------------------
# camera re-fit from committed tracking CSVs
# ---------------------------------------------------------------------------


def _ls_intersection(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Least-squares intersection point of lines through (p_i, q_i) [n,2]."""
    d = q - p
    # line i: d_y * x - d_x * y = d_y * p_x - d_x * p_y
    A = np.stack([d[:, 1], -d[:, 0]], axis=1)
    b = d[:, 1] * p[:, 0] - d[:, 0] * p[:, 1]
    norm = np.linalg.norm(A, axis=1, keepdims=True)
    ok = norm[:, 0] > 1e-6
    sol, *_ = np.linalg.lstsq(A[ok] / norm[ok], b[ok] / norm[ok, 0], rcond=None)
    return sol


def fit_camera_from_tracking_csv(
    csv_path: str,
    camera: str,
    max_rows: int = 4000,
    registry: Optional[CameraRegistry] = None,
    name: Optional[str] = None,
) -> CameraRegistry:
    """Fit one camera's homography + projection from a reference 46-column
    tracking CSV and register it (both banks) in a CameraRegistry.

    Uses the bottom-corner image/space pairs as ground-plane
    correspondences, and the box edge/vertical lines for the x/y/z
    vanishing points (reference find_vanishing_point, homography.py:96).
    """
    _, data = load_i24_csv(csv_path)
    im_b, sp, im_t = [], [], []
    n = 0
    for frame in sorted(data.keys()):
        for row in data[frame]:
            if len(row) < 45 or row[36].strip() != camera:
                continue
            try:
                imc = np.array([float(v) for v in row[11:27]], np.float64).reshape(8, 2)
                spc = np.array([float(v) for v in row[27:35]], np.float64).reshape(4, 2)
            except ValueError:
                continue
            if not (np.isfinite(imc).all() and np.isfinite(spc).all()):
                continue
            im_b.append(imc[:4])  # fbr, fbl, bbr, bbl (bottom)
            im_t.append(imc[4:])  # ftr, ftl, btr, btl (top)
            sp.append(spc)  # fbr, fbl, bbr, bbl footprint
            n += 1
            if n >= max_rows:
                break
        if n >= max_rows:
            break
    assert n >= 8, f"not enough usable rows for camera {camera} in {csv_path}"
    im_b = np.concatenate(im_b, axis=0)
    im_t = np.concatenate(im_t, axis=0)
    sp = np.concatenate(sp, axis=0)

    # vanishing points: z from bottom->top verticals; x (length) from
    # fbr->bbr / fbl->bbl edges; y (width) from fbr->fbl / bbr->bbl edges
    ib = im_b.reshape(-1, 4, 2)
    vp_z = _ls_intersection(im_b, im_t)
    vp_x = _ls_intersection(
        np.concatenate([ib[:, 0], ib[:, 1]]), np.concatenate([ib[:, 2], ib[:, 3]])
    )
    vp_y = _ls_intersection(
        np.concatenate([ib[:, 0], ib[:, 2]]), np.concatenate([ib[:, 1], ib[:, 3]])
    )
    vps = np.stack([vp_x, vp_y, vp_z])

    reg = registry if registry is not None else CameraRegistry()
    reg.add_camera(name or camera, im_b, sp, vps)
    return reg
