"""Synthetic traffic scenes: ground-truth trajectories, oracle detections,
and rendered frames (port of ``playground3d_tpu/data/synthetic.py``).

Substitutes for the I-24 recordings (which ship no video or checkpoints):
constant-velocity vehicles on a virtual roadway, projected through real
camera geometry. Supplies

* GT state trajectories (for evaluator fixtures and KF fitting),
* oracle ``Detections`` (exercises the full fused tracker without a trained
  network — SURVEY.md section 4's "synthetic-video end-to-end smoke test"),
* crude rendered frames (for training smoke tests: vehicles as shaded boxes
  on a textured background).

Everything is numpy on the host; the oracle detections land on ``device``
(the card unless the caller asks for the CPU). Each function draws from the
caller's ``rng`` in the JAX module's order, so a seed gives both packages
the same scene, noise and scores.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from playground3d_tpu_torch import DeviceLike, resolve_device
from playground3d_tpu_torch.evaluation import geometry_np as G
from playground3d_tpu_torch.models.retinanet import Detections
from playground3d_tpu_torch.utils.constants import CLASS_DIMS, IMAGENET_MEAN, IMAGENET_STD


@dataclass
class SyntheticScene:
    """Vehicles with constant-velocity roadway motion.

    Objects enter/exit by x-range clipping: an object is visible at time t
    only while its x is inside ``x_visible``.
    """

    n_objects: int = 8
    seed: int = 0
    x_spawn: Tuple[float, float] = (380.0, 660.0)
    x_visible: Tuple[float, float] = (350.0, 700.0)
    t_span: float = 10.0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n = self.n_objects
        self.classes = rng.integers(0, 4, n)  # sedan..pickup
        dims = CLASS_DIMS[self.classes]
        jitter = rng.uniform(0.9, 1.1, (n, 3))
        self.lwh = dims * jitter
        lanes_eb = np.array([18.0, 30.0, 42.0, 54.0])
        lanes_wb = np.array([66.0, 78.0, 90.0, 102.0])
        self.direction = np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0)
        lane = rng.integers(0, 4, n)
        self.y = np.where(self.direction > 0, lanes_eb[lane], lanes_wb[lane])
        self.x0 = rng.uniform(*self.x_spawn, n)
        self.v = rng.uniform(25.0, 45.0, n)  # ft/s

    def states_at(self, t: float):
        """-> (state7 [m,7], obj_idx [m]) for objects visible at time t."""
        x = self.x0 + self.direction * self.v * t
        vis = (x >= self.x_visible[0]) & (x <= self.x_visible[1])
        idx = np.nonzero(vis)[0]
        s = np.stack(
            [
                x[idx],
                self.y[idx],
                self.lwh[idx, 0],
                self.lwh[idx, 1],
                self.lwh[idx, 2],
                self.direction[idx],
                self.v[idx] ,
            ],
            axis=1,
        )
        return s, idx


def oracle_detections(
    scene: SyntheticScene,
    t: float,
    P: np.ndarray,
    K: int,
    noise_px: float = 0.0,
    drop_prob: float = 0.0,
    rng: Optional[np.random.Generator] = None,
    device: DeviceLike = None,
) -> Detections:
    """Perfect (optionally noisy) detections for the scene at time t,
    shaped like the detector's fixed-capacity output, on ``device``."""
    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    states, _ = scene.states_at(t)
    m = len(states)
    keep = rng.uniform(size=m) >= drop_prob
    states = states[keep]
    m = len(states)

    boxes = np.zeros((K, 20), np.float32)
    scores = np.zeros((K,), np.float32)
    classes = np.zeros((K,), np.int32)
    mask = np.zeros((K,), bool)
    if m > 0:
        space = G.state_to_space(states)
        im = G.space_to_im(space, P)  # [m,8,2]
        im = im + rng.normal(0, noise_px, im.shape)
        boxes[:m, :16] = im.reshape(m, 16)
        hull = np.concatenate([im.min(1), im.max(1)], axis=1)
        boxes[:m, 16:20] = hull
        scores[:m] = rng.uniform(0.7, 0.99, m)
        classes[:m] = scene.classes[scene.states_at(t)[1]][keep][:m]
        mask[:m] = True

    return _detections(scores, classes, boxes, np.zeros((K,), np.int32), mask, dev)


def mc_oracle_detections(
    scene: "SyntheticScene",
    t_per_cam,
    registry,
    cameras,
    ranges,
    K: int,
    rng: Optional[np.random.Generator] = None,
    noise_px: float = 0.5,
    device: DeviceLike = None,
) -> Detections:
    """Oracle detections across overlapping cameras: camera ci sees the
    objects inside its x-range, observed at its own timestamp. Returns a
    fixed-capacity masked ``Detections`` (cam_idx set per camera) on
    ``device``."""
    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    boxes = np.zeros((K, 20), np.float32)
    scores = np.zeros((K,), np.float32)
    classes = np.zeros((K,), np.int32)
    cam_idx = np.zeros((K,), np.int32)
    mask = np.zeros((K,), bool)
    k = 0
    for ci, cam in enumerate(cameras):
        c = registry.index(cam)
        P = registry.P[c, 0]
        states, idx = scene.states_at(t_per_cam[ci])
        if len(states) == 0:
            continue
        lo, hi = ranges[cam]
        vis = (states[:, 0] >= lo) & (states[:, 0] <= hi)
        states, idx = states[vis], idx[vis]
        if len(states) == 0:
            continue
        space = G.state_to_space(states)
        im = G.space_to_im(space, P) + rng.normal(0, noise_px, (len(states), 8, 2))
        for i in range(len(states)):
            if k >= K:
                break
            boxes[k, :16] = im[i].reshape(16)
            boxes[k, 16:18] = im[i].min(0)
            boxes[k, 18:20] = im[i].max(0)
            scores[k] = rng.uniform(0.8, 0.99)
            classes[k] = scene.classes[idx[i]]
            cam_idx[k] = ci
            mask[k] = True
            k += 1
    return _detections(scores, classes, boxes, cam_idx, mask, dev)


def _detections(scores, classes, boxes, cam_idx, mask, dev: torch.device) -> Detections:
    return Detections(*(torch.as_tensor(a, device=dev) for a in (scores, classes, boxes, cam_idx, mask)))


def aimed_regression_bias(P: np.ndarray, state: np.ndarray, image_hw: Tuple[int, int]) -> np.ndarray:
    """[9*12] regression-head bias under which each of the 9 anchors of
    pyramid cell (0, 0) at ``image_hw`` decodes to the image box of one
    vehicle ``state`` [x, y, l, w, h, dir] seen through ``P`` (least squares
    on the decode's corner sign pattern; the 2D box is the corners' hull).

    A detector with zero output convs (the focal-prior initialization)
    emits its biases whatever the image holds; with this bias its boxes
    parse to roadway states, so a random-weight detector drives births,
    matches and updates in tests and smoke runs."""
    from playground3d_tpu_torch.models.anchors import anchors_for_shape
    from playground3d_tpu_torch.models.decode import _SIGNS

    corners = G.state_to_im(np.asarray(state, np.float64)[None], P)[0]  # [8,2]
    A = np.concatenate([np.ones((8, 1)), np.asarray(_SIGNS)], 1)  # corner = c + sl*l + sw*w + sh*h
    anc = anchors_for_shape(tuple(image_hw), (3,))[:9]
    bias = np.zeros((9, 12), np.float32)
    for a in range(9):
        rel = (corners - (anc[a, :2] + anc[a, 2:]) / 2) / (anc[a, 2:] - anc[a, :2])
        bias[a, :8] = np.linalg.lstsq(A, rel, rcond=None)[0].reshape(-1)
        bias[a, 8:10], bias[a, 10:12] = rel.min(0), rel.max(0)
    return bias.reshape(-1)


def render_frame(
    scene: SyntheticScene,
    t: float,
    P: np.ndarray,
    height: int = 1080,
    width: int = 1920,
    rng: Optional[np.random.Generator] = None,
    normalized: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Rasterize the scene: textured background + per-vehicle shaded
    quadrilaterals (side/top/front faces at distinct intensities so the 3D
    structure is learnable). Returns (frame [H,W,3] float32, labels [m,21]).
    """
    rng = rng or np.random.default_rng(int(t * 1000) % (2**31))
    frame = rng.uniform(0.25, 0.45, (height, width, 3)).astype(np.float32)
    # horizontal "road" gradient texture
    frame += (np.linspace(0, 0.15, height)[:, None, None]).astype(np.float32)

    states, idx = scene.states_at(t)
    m = len(states)
    labels = np.zeros((m, 21), np.float32)
    if m > 0:
        space = G.state_to_space(states)
        im = G.space_to_im(space, P)
        order = np.argsort(-states[:, 0])  # far-to-near-ish painter order
        for j in order:
            corners = im[j]
            _fill_faces(frame, corners, base=0.55 + 0.05 * (j % 4))
        labels[:, :16] = im.reshape(m, 16)
        labels[:, 16:18] = im.min(1)
        labels[:, 18:20] = im.max(1)
        labels[:, 20] = scene.classes[idx]
    if normalized:
        frame = (frame - IMAGENET_MEAN) / IMAGENET_STD
    return frame, labels


def _fill_faces(frame: np.ndarray, corners: np.ndarray, base: float) -> None:
    """Fill the three visible faces of the box with distinct shades."""
    faces = [
        ((0, 1, 3, 2), base),  # bottom/ground face
        ((0, 2, 6, 4), base * 0.8),  # right side
        ((0, 1, 5, 4), base * 1.2),  # front
        ((4, 5, 7, 6), base * 1.05),  # top
    ]
    h, w = frame.shape[:2]
    for (a, b, c, d), shade in faces:
        quad = corners[[a, b, c, d]]
        _fill_quad(frame, quad, min(shade, 1.0), h, w)


def _fill_quad(frame, quad, shade, h, w):
    xmin = int(max(0, np.floor(quad[:, 0].min())))
    xmax = int(min(w - 1, np.ceil(quad[:, 0].max())))
    ymin = int(max(0, np.floor(quad[:, 1].min())))
    ymax = int(min(h - 1, np.ceil(quad[:, 1].max())))
    if xmax <= xmin or ymax <= ymin:
        return
    ys, xs = np.mgrid[ymin : ymax + 1, xmin : xmax + 1]
    pts = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float64)
    inside = np.ones(len(pts), bool)
    n = 4
    # winding-consistent half-plane test
    area = 0.0
    for i in range(n):
        a, b = quad[i], quad[(i + 1) % n]
        area += (b[0] - a[0]) * (b[1] + a[1])
    sign = 1.0 if area < 0 else -1.0
    for i in range(n):
        a, b = quad[i], quad[(i + 1) % n]
        cross = (b[0] - a[0]) * (pts[:, 1] - a[1]) - (b[1] - a[1]) * (pts[:, 0] - a[0])
        inside &= sign * cross >= 0
    sel = inside.reshape(ys.shape)
    frame[ymin : ymax + 1, xmin : xmax + 1][sel] = shade
