"""Host-side (numpy, float64) twins of the core geometry transforms (copy
of ``playground3d_tpu/evaluation/geometry_np.py``).

The evaluator and CSV tooling run offline on the host; numpy float64 keeps
them device-independent and exact.
"""

from __future__ import annotations

import numpy as np

from playground3d_tpu_torch.utils.constants import EB_WB_Y_SPLIT_FT


def state_to_space(state: np.ndarray) -> np.ndarray:
    """[d,s>=6] -> [d,8,3] (see geometry.transforms.state_to_space)."""
    state = np.atleast_2d(np.asarray(state, dtype=np.float64))
    x, y, l, w, h, d = (state[:, i] for i in range(6))
    x_front, x_back = x + d * l, x
    y_right, y_left = y - d * w / 2.0, y + d * w / 2.0
    zeros = np.zeros_like(x)
    z_top = -h
    xs = np.stack([x_front, x_front, x_back, x_back, x_front, x_front, x_back, x_back], 1)
    ys = np.stack([y_right, y_left, y_right, y_left, y_right, y_left, y_right, y_left], 1)
    zs = np.stack([zeros, zeros, zeros, zeros, z_top, z_top, z_top, z_top], 1)
    return np.stack([xs, ys, zs], axis=2)


def space_to_state(points: np.ndarray) -> np.ndarray:
    """[d,8,3] -> [d,6]."""
    p = np.asarray(points, dtype=np.float64)
    x = (p[:, 2, 0] + p[:, 3, 0]) / 2.0
    y = p[:, 0:4, 1].mean(1)
    fmb = ((p[:, 0, 0] + p[:, 1, 0]) - (p[:, 2, 0] + p[:, 3, 0])) / 2.0
    length = np.abs(fmb)
    width = np.abs(((p[:, 0, 1] + p[:, 2, 1]) - (p[:, 1, 1] + p[:, 3, 1])) / 2.0)
    height = np.abs(p[:, 0:4, 2] - p[:, 4:8, 2]).mean(1)
    return np.stack([x, y, length, width, height, np.sign(fmb)], axis=1)


def space_to_im(points: np.ndarray, P: np.ndarray) -> np.ndarray:
    """[d,m,3] + [3,4] -> [d,m,2]."""
    pts = np.asarray(points, dtype=np.float64)
    homo = np.concatenate([pts, np.ones(pts.shape[:-1] + (1,))], axis=-1)
    out = homo @ np.asarray(P, dtype=np.float64).T
    return out[..., :2] / out[..., 2:3]


def im_to_space(points: np.ndarray, H: np.ndarray, heights: np.ndarray) -> np.ndarray:
    """[d,8,2] + [3,3] + [d] -> [d,8,3]."""
    pts = np.asarray(points, dtype=np.float64)
    homo = np.concatenate([pts, np.ones(pts.shape[:-1] + (1,))], axis=-1)
    out = homo @ np.asarray(H, dtype=np.float64).T
    flat = out[..., :2] / out[..., 2:3]
    d = pts.shape[0]
    z = np.zeros((d, 8, 1))
    z[:, 4:8, 0] = np.asarray(heights, dtype=np.float64)[:, None]
    return np.concatenate([flat, z], axis=2)


def im_to_state(points, H, heights):
    return space_to_state(im_to_space(points, H, heights))


def state_to_im(state, P):
    return space_to_im(state_to_space(state), P)


def state_to_im_banked(state, P_eb, P_wb):
    """[n,>=6] states -> [n,8,2] through the EB/WB dual-correspondence bank.

    THE host-side twin of pipeline.camera_bank.state_to_im_banked: bank
    selection is by roadway position (y > 60 ft = WB side, reference
    homography.py:849-856), NOT by direction sign — a westbound vehicle on
    the eastbound side must project through the EB correspondence. Shared by
    the overlay writer and the annotator front-ends so every consumer draws
    boxes exactly where the tracker observes them."""
    state = np.asarray(state)
    if len(state) == 0:
        return np.zeros((0, 8, 2), np.float64)
    space = state_to_space(state[:, :6])
    use_wb = state[:, 1] > EB_WB_Y_SPLIT_FT
    im_eb = space_to_im(space, P_eb)
    im_wb = space_to_im(space, P_wb)
    return np.where(use_wb[:, None, None], im_wb, im_eb)


def height_from_template(template_boxes, template_space_heights, boxes):
    """See geometry.transforms.height_from_template (sum of |dx|+|dy|)."""
    t_top = template_boxes[:, 4:8, :].mean(1)
    t_bot = template_boxes[:, 0:4, :].mean(1)
    t_im_h = np.abs(t_top - t_bot).sum(1)
    ratio = t_im_h / template_space_heights
    b_top = boxes[:, 4:8, :].mean(1)
    b_bot = boxes[:, 0:4, :].mean(1)
    return np.abs(b_top - b_bot).sum(1) / ratio


def footprint_xyxy(space_boxes: np.ndarray) -> np.ndarray:
    """[d,8,3] -> [d,4] ground-plane hull."""
    bottom = space_boxes[:, 0:4, :2]
    return np.concatenate([bottom.min(1), bottom.max(1)], axis=1)


def iou_xyxy(a: np.ndarray, b: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """[n,4] x [m,4] -> [n,m] (vectorizes the evaluator's double loop,
    mot_evaluator.py:219-222)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iw = np.clip(np.minimum(a[:, None, 2], b[None, :, 2]) - np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    ih = np.clip(np.minimum(a[:, None, 3], b[None, :, 3]) - np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = iw * ih
    return inter / (area_a[:, None] + area_b[None, :] - inter + eps)
