# A frozen copy of the port's ops/iou.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""Batched IoU primitives (port of ``playground3d_tpu/ops/iou.py``)."""

from __future__ import annotations

import torch

__all__ = ["pairwise_iou", "elementwise_iou"]


def pairwise_iou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """[n,4] x [m,4] xyxy boxes -> [n,m] IoU; intersection clamped at 0,
    union at eps (reference losses.py:5-22)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iw = torch.minimum(a[:, None, 2], b[None, :, 2]) - torch.maximum(a[:, None, 0], b[None, :, 0])
    ih = torch.minimum(a[:, None, 3], b[None, :, 3]) - torch.maximum(a[:, None, 1], b[None, :, 1])
    inter = torch.clamp(iw, min=0.0) * torch.clamp(ih, min=0.0)
    union = torch.clamp(area_a[:, None] + area_b[None, :] - inter, min=eps)
    return inter / union


def elementwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[...,4] x [...,4] xyxy boxes -> [...] IoU, broadcasting
    (reference ``md_iou``, MC3D_crop_tracker.py:1030-1049)."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    iw = torch.clamp(torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]), min=0.0)
    ih = torch.clamp(torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]), min=0.0)
    inter = iw * ih
    union = area_a + area_b - inter
    return inter / torch.where(union > 0, union, torch.ones_like(union))
