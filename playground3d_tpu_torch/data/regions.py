"""Per-camera ignore regions (reference ``ignored_regions/*.csv``; numpy
copy of ``playground3d_tpu/data/regions.py``).

The reference blacks out a per-camera polygon when caching training frames
(corrected_3D_dataset.py:53-63,109: ``cv2.fillPoly(frame, ig, (0,0,0))`` on
the 1080p frame). This module provides the same capability numpy-only, plus
a detection-side filter: a coarse per-camera boolean grid that the
tracker's parse step indexes on the device to drop detections whose box
center falls inside an ignored region.

CSV format (reference ignored_regions/p1c1_ignored.csv:1-4): one ``x,y``
pixel vertex per line, 1080p coordinates.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "load_ignore_polygon",
    "load_ignore_regions",
    "points_in_polygon",
    "polygon_mask",
    "blackout",
    "ignore_grid",
]


def load_ignore_polygon(path: str) -> np.ndarray:
    """One ``x,y`` vertex per line -> [n,2] float64."""
    pts = []
    with open(path) as f:
        for row in csv.reader(f):
            if len(row) >= 2 and row[0].strip():
                pts.append([float(row[0]), float(row[1])])
    return np.asarray(pts, np.float64)


def load_ignore_regions(directory: str, cameras: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    """Load ``<camera>_ignored.csv`` polygons from a directory."""
    out: Dict[str, np.ndarray] = {}
    if not os.path.isdir(directory):
        return out
    for fn in sorted(os.listdir(directory)):
        if not fn.endswith("_ignored.csv"):
            continue
        cam = fn[: -len("_ignored.csv")]
        if cameras is not None and cam not in cameras:
            continue
        poly = load_ignore_polygon(os.path.join(directory, fn))
        if len(poly) >= 3:
            out[cam] = poly
    return out


def points_in_polygon(pts: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Crossing-number point-in-polygon test, vectorized. pts [n,2],
    poly [m,2] -> bool [n]."""
    pts = np.asarray(pts, np.float64)
    poly = np.asarray(poly, np.float64)
    x, y = pts[:, 0, None], pts[:, 1, None]
    x1, y1 = poly[:, 0][None], poly[:, 1][None]
    x2 = np.roll(poly[:, 0], -1)[None]
    y2 = np.roll(poly[:, 1], -1)[None]
    crosses = (y1 <= y) != (y2 <= y)
    denom = np.where(y2 != y1, y2 - y1, 1e-300)
    xint = x1 + (y - y1) * (x2 - x1) / denom
    return ((crosses & (x < xint)).sum(axis=1) % 2).astype(bool)


def polygon_mask(poly: np.ndarray, h: int, w: int) -> np.ndarray:
    """[h,w] bool mask of pixels inside the polygon (pixel centers)."""
    yy, xx = np.mgrid[0:h, 0:w]
    pts = np.stack([xx.ravel() + 0.5, yy.ravel() + 0.5], axis=1)
    return points_in_polygon(pts, poly).reshape(h, w)


def blackout(frame: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Zero the polygon's pixels (reference fillPoly black,
    corrected_3D_dataset.py:109). Returns a copy."""
    out = frame.copy()
    out[polygon_mask(poly, frame.shape[0], frame.shape[1])] = 0
    return out


def ignore_grid(
    polygons: Dict[str, np.ndarray],
    cameras: Sequence[str],
    height: int = 1080,
    width: int = 1920,
    cell: int = 8,
) -> np.ndarray:
    """[C, height//cell, width//cell] bool grid for on-device detection
    filtering: True where the cell center is inside the camera's ignore
    polygon. Cameras without a polygon are all-False."""
    gh, gw = height // cell, width // cell
    grid = np.zeros((len(cameras), gh, gw), bool)
    yy, xx = np.mgrid[0:gh, 0:gw]
    centers = np.stack(
        [(xx.ravel() + 0.5) * cell, (yy.ravel() + 0.5) * cell], axis=1
    )
    for ci, cam in enumerate(cameras):
        poly = polygons.get(cam)
        if poly is not None and len(poly) >= 3:
            grid[ci] = points_in_polygon(centers, poly).reshape(gh, gw)
    return grid
