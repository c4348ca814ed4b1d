# A frozen copy of the port's geometry/transforms.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""Coordinate transforms image <-> space (roadway plane) <-> state, on
tensors (port of ``playground3d_tpu/geometry/transforms.py``).

Shape-polymorphic over a leading object dimension ``d``; per-object camera
matrices are ``[d,3,3]`` / ``[d,3,4]``, a shared camera ``[3,3]`` /
``[3,4]``. The matmuls run in full float32: the package turns TF32 off
(``cellbench.reference/__init__.py``), matching the JAX package's
``Precision.HIGHEST`` on ~1e3-magnitude pixel and roadway coordinates.
"""

from __future__ import annotations

import torch

__all__ = [
    "space_to_state",
    "state_to_space",
    "im_to_space",
    "space_to_im",
    "im_to_state",
    "state_to_im",
    "height_from_template",
    "select_eb_wb",
    "space_footprint_xyxy",
    "im_hull_xyxy",
]


def space_to_state(points: torch.Tensor) -> torch.Tensor:
    """[d,8,3] space corners -> [d,6] state [x,y,l,w,h,dir]
    (reference homography.py:274-303)."""
    p = points
    x = (p[:, 2, 0] + p[:, 3, 0]) / 2.0
    y = (p[:, 0, 1] + p[:, 1, 1] + p[:, 2, 1] + p[:, 3, 1]) / 4.0
    front_minus_back = ((p[:, 0, 0] + p[:, 1, 0]) - (p[:, 2, 0] + p[:, 3, 0])) / 2.0
    length = torch.abs(front_minus_back)
    width = torch.abs(((p[:, 0, 1] + p[:, 2, 1]) - (p[:, 1, 1] + p[:, 3, 1])) / 2.0)
    height = torch.mean(torch.abs(p[:, 0:4, 2] - p[:, 4:8, 2]), dim=1)
    direction = torch.sign(front_minus_back)
    return torch.stack([x, y, length, width, height, direction], dim=1)


def state_to_space(state: torch.Tensor) -> torch.Tensor:
    """[d,s>=6] state [x,y,l,w,h,dir,(v)] -> [d,8,3] space corners, order
    fbr,fbl,bbr,bbl,ftr,ftl,btr,btl; top corners at z = -h
    (reference homography.py:305-320)."""
    x, y, l, w, h, d = (state[:, i] for i in range(6))
    x_front = x + d * l
    x_back = x
    y_right = y - d * w / 2.0
    y_left = y + d * w / 2.0
    zeros = torch.zeros_like(x)
    z_top = -h

    xs = torch.stack([x_front, x_front, x_back, x_back, x_front, x_front, x_back, x_back], 1)
    ys = torch.stack([y_right, y_left, y_right, y_left, y_right, y_left, y_right, y_left], 1)
    zs = torch.stack([zeros, zeros, zeros, zeros, z_top, z_top, z_top, z_top], 1)
    return torch.stack([xs, ys, zs], dim=2)


def _apply_h(points_xy: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """3x3 planar homography on [d,m,2] points; ``H`` [3,3] or [d,3,3]."""
    ones = torch.ones(points_xy.shape[:-1] + (1,), dtype=points_xy.dtype, device=points_xy.device)
    homo = torch.cat([points_xy, ones], dim=-1)  # [d,m,3]
    if H.ndim == 2:
        out = torch.einsum("dmj,kj->dmk", homo, H)
    else:
        out = torch.einsum("dmj,dkj->dmk", homo, H)
    return out[..., :2] / out[..., 2:3]


def im_to_space(points: torch.Tensor, H: torch.Tensor, heights: torch.Tensor) -> torch.Tensor:
    """[d,8,2] image corners + heights [d] -> [d,8,3] space corners. All 8
    points go through the ground-plane homography; only the top corners'
    z carries the height (reference homography.py:404-429)."""
    flat = _apply_h(points, H)
    d = points.shape[0]
    z = torch.zeros((d, 8), dtype=flat.dtype, device=flat.device)
    z[:, 4:8] = heights[:, None].to(flat.dtype)
    return torch.cat([flat, z[..., None]], dim=2)


def space_to_im(points: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """[d,m,3] space points -> [d,m,2] pixels via ``P`` [3,4] or [d,3,4]
    (reference homography.py:438-476)."""
    ones = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype, device=points.device)
    homo = torch.cat([points, ones], dim=-1)  # [d,m,4]
    if P.ndim == 2:
        out = torch.einsum("dmj,kj->dmk", homo, P)
    else:
        out = torch.einsum("dmj,dkj->dmk", homo, P)
    return out[..., :2] / out[..., 2:3]


def height_from_template(
    template_boxes: torch.Tensor,
    template_space_heights: torch.Tensor,
    boxes: torch.Tensor,
) -> torch.Tensor:
    """Space heights from image-pixel heights by the template proportion;
    pixel height is the sum of |dx| and |dy| (reference
    homography.py:519-551)."""
    t_top = torch.mean(template_boxes[:, 4:8, :], dim=1)
    t_bot = torch.mean(template_boxes[:, 0:4, :], dim=1)
    t_im_h = torch.sum(torch.sqrt((t_top - t_bot) ** 2), dim=1)
    ratio = t_im_h / template_space_heights

    b_top = torch.mean(boxes[:, 4:8, :], dim=1)
    b_bot = torch.mean(boxes[:, 0:4, :], dim=1)
    b_im_h = torch.sum(torch.sqrt((b_top - b_bot) ** 2), dim=1)
    return b_im_h / ratio


def space_footprint_xyxy(space_boxes: torch.Tensor) -> torch.Tensor:
    """[d,8,3] space corners -> [d,4] ground footprint over the bottom
    corners (xmin,ymin,xmax,ymax)."""
    bottom = space_boxes[:, 0:4, :2]
    return torch.cat([bottom.amin(dim=1), bottom.amax(dim=1)], dim=1)


def im_hull_xyxy(im_boxes: torch.Tensor) -> torch.Tensor:
    """[d,8,2] image corners -> [d,4] 2D hull (xmin,ymin,xmax,ymax)."""
    return torch.cat([im_boxes.amin(dim=1), im_boxes.amax(dim=1)], dim=1)
