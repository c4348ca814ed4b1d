"""Homography fitting and the per-camera correspondence registry (port of
``playground3d_tpu/geometry/homography.py``).

Fitting is offline host-side math (normalized DLT via SVD, float64);
applying the transforms is on-device (see
:mod:`playground3d_tpu_torch.geometry.transforms`). :func:`scale_P_z` is a
float32 grid search on the CPU through those transforms, as the JAX
function's is through its own.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["fit_homography", "build_projection", "find_vanishing_point", "scale_P_z", "CameraRegistry"]


def _normalization(points: np.ndarray) -> np.ndarray:
    """Similarity transform that zero-means points and scales mean norm to
    sqrt(2) (Hartley normalization for a numerically stable DLT)."""
    centroid = points.mean(axis=0)
    d = np.sqrt(((points - centroid) ** 2).sum(axis=1)).mean()
    s = np.sqrt(2.0) / max(d, 1e-12)
    return np.array(
        [[s, 0.0, -s * centroid[0]], [0.0, s, -s * centroid[1]], [0.0, 0.0, 1.0]]
    )


def fit_homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares planar homography H with dst ~ H @ src (both [n,2]),
    normalized DLT over all points (``cv2.findHomography`` with method=0)."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    if src.shape[0] < 4:
        raise ValueError("homography fit requires >= 4 correspondences")

    Ts, Td = _normalization(src), _normalization(dst)
    ones = np.ones((src.shape[0], 1))
    s = np.concatenate([src, ones], axis=1) @ Ts.T
    d = np.concatenate([dst, ones], axis=1) @ Td.T

    n = src.shape[0]
    A = np.zeros((2 * n, 9))
    A[0::2, 0:3] = s
    A[0::2, 6:9] = -d[:, 0:1] * s
    A[1::2, 3:6] = s
    A[1::2, 6:9] = -d[:, 1:2] * s

    _, _, vt = np.linalg.svd(A)
    Hn = vt[-1].reshape(3, 3)
    H = np.linalg.inv(Td) @ Hn @ Ts
    return H / H[2, 2]


def build_projection(H_inv: np.ndarray, vp_z: Sequence[float]) -> np.ndarray:
    """3x4 projection P from the space->image homography and the z-axis
    vanishing point (reference homography.py:358-371): columns 0,1,3 are
    H_inv's columns 0,1,2; column 2 is [vp_z_x, vp_z_y, 1] * 0.01."""
    P = np.zeros((3, 4))
    P[:, 0] = H_inv[:, 0]
    P[:, 1] = H_inv[:, 1]
    P[:, 3] = H_inv[:, 2]
    P[:, 2] = np.array([vp_z[0], vp_z[1], 1.0]) * 0.01
    return P


def find_vanishing_point(lines: np.ndarray) -> np.ndarray:
    """Least-squares vanishing point of lines [n,4] = (x0,y0,x1,y1): the
    point with the least sum of squared point-line distances, a 2x2
    normal-equation solve (the reference grid-searches it,
    homography.py:96-154)."""
    lines = np.asarray(lines, dtype=np.float64)
    dx = lines[:, 2] - lines[:, 0]
    dy = lines[:, 3] - lines[:, 1]
    norm2 = dx**2 + dy**2 + 1e-12
    # line: dy*x - dx*y + (dx*y0 - dy*x0) = 0
    a = dy / np.sqrt(norm2)
    b = -dx / np.sqrt(norm2)
    c = (dx * lines[:, 1] - dy * lines[:, 0]) / np.sqrt(norm2)
    A = np.array([[np.sum(a * a), np.sum(a * b)], [np.sum(a * b), np.sum(b * b)]])
    rhs = -np.array([np.sum(a * c), np.sum(b * c)])
    return np.linalg.solve(A, rhs)


def scale_P_z(
    P: np.ndarray,
    boxes_im: np.ndarray,
    heights: np.ndarray,
    H: np.ndarray,
    granularity: float = 1e-6,
    max_scale: float = 10.0,
) -> np.ndarray:
    """The scale C of P's z column with the least mean reprojection error
    (the reference's grid refinement, homography.py:607-666): each
    candidate's error is the mean top plus mean bottom corner pixel distance
    of im -> state (through ``H``) -> im (through P with column 2 times C),
    in float32 over the whole 10-point grid at once; the grid shrinks around
    the best C until its step is below ``granularity``.

    boxes_im: [d,8,2] labeled image boxes; heights: [d] space heights.
    Returns a copy of P with the scaled z column."""
    from playground3d_tpu_torch.geometry import transforms as T

    boxes = torch.as_tensor(np.asarray(boxes_im, np.float32))
    state = T.im_to_state(boxes, torch.as_tensor(np.asarray(H, np.float32)),
                          torch.as_tensor(np.asarray(heights, np.float32)))
    space = T.state_to_space(state)  # [d,8,3]
    P_f = torch.as_tensor(np.asarray(P, np.float32))

    def grid_errors(grid: np.ndarray) -> np.ndarray:
        errs = []
        for C in torch.as_tensor(grid, dtype=torch.float32):
            P_c = P_f.clone()
            P_c[:, 2] = P_c[:, 2] * C
            dist = torch.sqrt(torch.sum((boxes - T.space_to_im(space, P_c)) ** 2, dim=-1))
            errs.append(dist[:, 0:4].mean() + dist[:, 4:8].mean())
        return torch.stack(errs).numpy()

    grid = np.linspace(granularity, max_scale, num=10)
    step = grid[1] - grid[0]
    best_C = grid[0]
    while step > granularity:
        best_C = grid[int(np.argmin(grid_errors(grid)))]
        grid = np.linspace(best_C - step, best_C + step, num=10)
        step = grid[1] - grid[0]

    P_out = P.copy()
    P_out[:, 2] *= best_C
    return P_out


@dataclass
class CameraRegistry:
    """Stacked per-camera correspondences, gatherable by camera index; two
    banks per camera (0 = EB, 1 = WB), as the reference's
    ``Homography_Wrapper`` (homography.py:793-862)."""

    names: List[str] = field(default_factory=list)
    H: Optional[np.ndarray] = None  # [C,2,3,3]
    H_inv: Optional[np.ndarray] = None  # [C,2,3,3]
    P: Optional[np.ndarray] = None  # [C,2,3,4]
    vps: Optional[np.ndarray] = None  # [C,2,3,2]

    def index(self, name: str) -> int:
        return self.names.index(name)

    @property
    def num_cameras(self) -> int:
        return len(self.names)

    def add_camera(
        self,
        name: str,
        corr_pts: np.ndarray,
        space_pts: np.ndarray,
        vps: np.ndarray,
        bank: str = "both",
    ) -> None:
        """Fit and register a correspondence for ``name`` from [n,2]
        image/space point pairs and [3,2] x/y/z vanishing points."""
        Hm = fit_homography(corr_pts, space_pts)
        Hi = fit_homography(space_pts, corr_pts)
        Pm = build_projection(Hi, vps[2])
        self._insert(name, Hm, Hi, Pm, np.asarray(vps, dtype=np.float64), bank)

    def _insert(self, name, Hm, Hi, Pm, vps, bank) -> None:
        if name not in self.names:
            self.names.append(name)
            shapes = (("H", (2, 3, 3)), ("H_inv", (2, 3, 3)), ("P", (2, 3, 4)), ("vps", (2, 3, 2)))
            for attr, shape in shapes:
                cur = getattr(self, attr)
                blank = np.zeros((1,) + shape)
                setattr(self, attr, blank if cur is None else np.concatenate([cur, blank], axis=0))
        c = self.index(name)
        for b in {"eb": [0], "wb": [1], "both": [0, 1]}[bank]:
            self.H[c, b] = Hm
            self.H_inv[c, b] = Hi
            self.P[c, b] = Pm
            self.vps[c, b] = vps

    def set_P(self, name: str, P: np.ndarray, bank: str = "both") -> None:
        for b in {"eb": [0], "wb": [1], "both": [0, 1]}[bank]:
            self.P[self.index(name), b] = P

    def device_arrays(self, dtype=np.float32) -> Dict[str, np.ndarray]:
        """Dense arrays to ship to the device (gathered by camera index and
        EB/WB bank index there)."""
        return {
            "H": self.H.astype(dtype),
            "H_inv": self.H_inv.astype(dtype),
            "P": self.P.astype(dtype),
        }

    # persistence (npz + json manifest; no pickle), the JAX package's format
    def save(self, path: str) -> None:
        np.savez(path, H=self.H, H_inv=self.H_inv, P=self.P, vps=self.vps, names=json.dumps(self.names))

    @classmethod
    def load(cls, path: str) -> "CameraRegistry":
        with np.load(path, allow_pickle=False) as z:
            return cls(names=json.loads(str(z["names"])), H=z["H"], H_inv=z["H_inv"], P=z["P"], vps=z["vps"])
