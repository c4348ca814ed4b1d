# A frozen copy of the port's geometry/homography.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""Homography fitting and the per-camera correspondence registry (port of
``playground3d_tpu/geometry/homography.py``).

Fitting is offline host-side math (normalized DLT via SVD, float64);
applying the transforms is on-device (see
:mod:`cellbench.reference.geometry.transforms`).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["fit_homography", "build_projection", "CameraRegistry"]


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
