# A frozen copy of the port's ops/nms.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""Masked fixed-capacity non-maximum suppression (port of
``playground3d_tpu/ops/nms.py``).

Greedy score-ordered NMS as the fixed point of
``keep[i] <- not any_j (beats[j, i] and keep[j])`` from all-true, with
``beats[j, i] = (score_j > score_i, or equal and j < i) and IoU > thr``.
The JAX package runs it in a ``while_loop`` on the device. Here
:func:`nms` launches the hand-written kernels of ``csrc/nms.cu`` for tensors
on the card (up to :data:`SMEM_MAX_BOXES` boxes one launch of a thread-block
cluster, the beats table in shared memory; above it the beats bits by a grid,
then the loop and the compaction in one block; no host read either way; its
rounds go to :class:`~cellbench.reference.ops.topk.DeviceRounds`), and
runs :func:`nms_plain`, a host loop that reads one flag a round (counted in
:class:`~cellbench.reference.ops.topk.HostSyncs`), for tensors on the
CPU. The two agree bit for bit. :func:`batched_nms` hands its groups to the
kernel, which shifts the boxes as :func:`group_shift` does.
"""

from __future__ import annotations

from typing import Optional

import torch

from cellbench.reference.ops.iou import pairwise_iou
from cellbench.reference.ops.topk import HostSyncs, top_k


NEG_INF = -1e30

# The kernels' layout constants (csrc/nms.cu holds the same values).


# -fmad=false is belt and braces: the source rounds every float op explicitly


def nms_plain(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    mask: torch.Tensor,
    iou_threshold: float,
    max_keep: int = 100,
    n_iter: Optional[int] = None,
):
    """The plain version: the JAX function's ops, its ``while_loop`` as a
    host loop reading one flag a round. Any device."""
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
    order (lower index first on ties), 0-padded where keep_mask is False.
    The CUDA kernel for tensors on the card, the plain version for tensors
    on the CPU."""
    return nms_plain(boxes, scores, mask, iou_threshold, max_keep, n_iter)


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
    even with negative coordinates (reference model.py:49-56). On the card
    the kernel does the shift (one launch with the suppression); on the CPU
    :func:`group_shift`'s tensor ops, then :func:`nms_plain`."""
    return nms(group_shift(boxes, groups, mask), scores, mask, iou_threshold, max_keep=max_keep, n_iter=n_iter)


def group_shift(boxes: torch.Tensor, groups: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``batched_nms``'s boxes: shifted to a non-negative origin, then
    offset by group * (coordinate span + 1)."""
    zero = torch.zeros_like(boxes)
    valid = torch.where(mask[:, None], boxes, zero)
    max_c = torch.max(valid)
    min_c = torch.min(valid)
    span = max_c - min_c + 1.0
    offset = groups.to(boxes.dtype) * span
    return (boxes - min_c) + offset[:, None]
