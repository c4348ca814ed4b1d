"""Masked fixed-capacity non-maximum suppression (port of
``playground3d_tpu/ops/nms.py``).

Greedy score-ordered NMS as the fixed point of
``keep[i] <- not any_j (beats[j, i] and keep[j])`` from all-true, with
``beats[j, i] = (score_j > score_i, or equal and j < i) and IoU > thr``.
The JAX package runs it in a ``while_loop``; here it is a host loop that
reads one flag from the device per round (counted in
:class:`~playground3d_tpu_torch.ops.topk.HostSyncs`).
"""

from __future__ import annotations

from typing import Optional

import torch

from playground3d_tpu_torch.ops.iou import pairwise_iou
from playground3d_tpu_torch.ops.topk import HostSyncs, top_k

__all__ = ["nms", "batched_nms"]

NEG_INF = -1e30


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    mask: torch.Tensor,
    iou_threshold: float,
    max_keep: int = 100,
    n_iter: Optional[int] = None,
):
    """boxes [N,4] xyxy; scores [N]; mask [N] -> (keep_idx [max_keep]
    int32, keep_mask [max_keep] bool), kept indices in decreasing-score
    order (lower index first on ties), 0-padded where keep_mask is False."""
    n = boxes.shape[0]
    if n_iter is None:
        n_iter = n
    dev = boxes.device

    s = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    iou = pairwise_iou(boxes, boxes)
    ar = torch.arange(n, device=dev)
    order_j = s[:, None] > s[None, :]
    tie = (s[:, None] == s[None, :]) & (ar[:, None] < ar[None, :])
    beats = (order_j | tie) & (iou > iou_threshold) & mask[:, None] & mask[None, :]

    keep, prev, i = mask, ~mask, 0
    while i < n_iter and HostSyncs.read(torch.any(keep != prev), "nms"):
        keep, prev = ~torch.any(beats & keep[:, None], dim=0) & mask, keep
        i += 1

    rank_scores = torch.where(keep, s, torch.full_like(s, NEG_INF))
    top_s, top_i = top_k(rank_scores, min(max_keep, n))
    keep_mask = top_s > NEG_INF / 2
    keep_idx = torch.where(keep_mask, top_i, torch.zeros_like(top_i)).to(torch.int32)
    if max_keep > n:
        pad = max_keep - n
        keep_idx = torch.cat([keep_idx, torch.zeros((pad,), dtype=torch.int32, device=dev)])
        keep_mask = torch.cat([keep_mask, torch.zeros((pad,), dtype=torch.bool, device=dev)])
    return keep_idx, keep_mask


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    groups: torch.Tensor,
    mask: torch.Tensor,
    iou_threshold: float,
    max_keep: int = 100,
    n_iter: Optional[int] = None,
):
    """Per-group NMS by coordinate offsets: boxes are shifted to a
    non-negative origin and offset by group * span, so groups never overlap
    even with negative coordinates (reference model.py:49-56)."""
    zero = torch.zeros_like(boxes)
    valid = torch.where(mask[:, None], boxes, zero)
    max_c = torch.max(valid)
    min_c = torch.min(valid)
    span = max_c - min_c + 1.0
    offset = groups.to(boxes.dtype) * span
    shifted = (boxes - min_c) + offset[:, None]
    return nms(shifted, scores, mask, iou_threshold, max_keep=max_keep, n_iter=n_iter)
