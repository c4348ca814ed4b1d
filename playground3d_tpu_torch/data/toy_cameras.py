"""Synthetic pole-camera builders: projectors and fitted registries (copy of
``playground3d_tpu/data/toy_cameras.py`` on the port's registry).

Used by tests, the CLI apps, and the bench to construct realistic highway
camera geometry without the I-24 correspondence files. A projector models a
pole camera (long lens, shallow pitch, looking down-road); a registry is fit
from projected ground-plane correspondences exactly as a user would fit one
from labeled points.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from playground3d_tpu_torch.geometry.homography import CameraRegistry


def make_projector(
    cam_x: float,
    cam_y: float = 60.0,
    height: float = 45.0,
    f: float = 2000.0,
    yaw_deg: float = 8.0,
    pitch_deg: float = 12.0,
    cx: float = 960.0,
    cy: float = 540.0,
) -> Callable[[np.ndarray], np.ndarray]:
    """World (road x ft, lane y ft, up = -z) -> image pixels."""
    cam_pos = np.array([cam_x, cam_y, -height])

    def project(pts3: np.ndarray) -> np.ndarray:
        d = pts3 - cam_pos
        yaw = np.deg2rad(yaw_deg)
        pitch = np.deg2rad(pitch_deg)
        Ry = np.array(
            [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]]
        )
        Rx = np.array(
            [[1, 0, 0], [0, np.cos(pitch), -np.sin(pitch)], [0, np.sin(pitch), np.cos(pitch)]]
        )
        cam = np.stack([d[:, 1], -d[:, 2], d[:, 0]], axis=1) @ Ry.T @ Rx.T
        u = f * cam[:, 0] / cam[:, 2] + cx
        v = f * cam[:, 1] / cam[:, 2] + cy
        return np.stack([u, v], axis=1)

    return project


def register_toy_camera(
    reg: CameraRegistry,
    name: str,
    project: Callable,
    x_range: Tuple[float, float],
    seed: int = 7,
    cx: float = 960.0,
    cy: float = 540.0,
) -> None:
    """Fit a correspondence for a synthetic camera over a roadway x-range."""
    rng = np.random.default_rng(seed)
    gx = rng.uniform(x_range[0], x_range[1], size=24)
    gy = rng.uniform(0, 120, size=24)
    space_pts = np.stack([gx, gy], axis=1)
    corr_pts = project(np.concatenate([space_pts, np.zeros((24, 1))], axis=1))
    mid = (x_range[0] + x_range[1]) / 2
    vp_z = project(np.array([[mid + 100, 60.0, -1e7]]))[0]
    vps = np.array([[1e6, cy], [cx, 1e6], vp_z])
    reg.add_camera(name, corr_pts, space_pts, vps)


def register_bench_camera(
    image_hw: Tuple[int, int] = (1080, 1920),
    f: float | None = None,
    yaw_deg: float = 4.0,
    pitch_deg: float = 6.0,
    seed: int = 7,
) -> Tuple[CameraRegistry, Callable[[np.ndarray], np.ndarray]]:
    """The single fitted pole camera shared by the bench/profile/verify
    scripts: 30 ft pole at road-x 250 looking down-road over x in [450, 680],
    principal point at the image center, focal length scaled with width.

    Returns ``(registry, projector)`` with the camera registered as "p1c1".
    The fit is deterministic in ``seed`` so script runs are reproducible.
    """
    h, w = image_hw
    if f is None:
        f = 2000.0 * w / 1920.0
    cx, cy = w / 2.0, h / 2.0
    project = make_projector(
        cam_x=250.0, cam_y=60.0, height=30.0, f=f,
        yaw_deg=yaw_deg, pitch_deg=pitch_deg, cx=cx, cy=cy,
    )
    rng = np.random.default_rng(seed)
    sp = np.stack([rng.uniform(450, 680, 24), rng.uniform(0, 120, 24)], 1)
    im = project(np.concatenate([sp, np.zeros((24, 1))], 1))
    vp_z = project(np.array([[550.0, 60.0, -1e7]]))[0]
    reg = CameraRegistry()
    reg.add_camera("p1c1", im, sp, np.array([[1e6, cy], [cx, 1e6], vp_z]))
    return reg, project


def toy_camera_chain(
    n_cameras: int,
    base_x: float = 350.0,
    span: float = 210.0,
    overlap: float = 80.0,
    seed: int = 7,
) -> Tuple[CameraRegistry, Dict[str, Tuple[float, float]], np.ndarray, Dict[str, Callable]]:
    """A chain of overlapping cameras along the roadway (like p1c1..p1cN).

    Returns (registry, {name: (xmin, xmax)}, centers [N,2], projectors).
    """
    reg = CameraRegistry()
    ranges: Dict[str, Tuple[float, float]] = {}
    projectors: Dict[str, Callable] = {}
    step = span - overlap
    for i in range(n_cameras):
        name = f"p1c{i + 1}"
        lo = base_x + i * step
        hi = lo + span
        ranges[name] = (lo, hi)
        proj = make_projector(cam_x=lo - 30.0)
        register_toy_camera(reg, name, proj, (lo, hi), seed=seed + i)
        projectors[name] = proj
    centers = np.array(
        [[(a + b) / 2.0, 60.0] for a, b in ranges.values()], np.float32
    )
    return reg, ranges, centers, projectors
