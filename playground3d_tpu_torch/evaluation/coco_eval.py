"""COCO-style mAP evaluation, pycocotools-free (copy of
``playground3d_tpu/evaluation/coco_eval.py``).

Functionality-parity with the reference's ``coco_eval.py``
(pytorch_retinanet_detector_directional/retinanet/coco_eval.py:6-84, a thin
pycocotools wrapper): the standard COCOeval bbox protocol — greedy
score-ordered matching per (image, class) at each IoU threshold in
0.50:0.05:0.95, 101-point interpolated AP, averaged over classes and
thresholds. Returns AP, AP50, AP75 and per-class APs.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from playground3d_tpu_torch.evaluation.geometry_np import iou_xyxy

__all__ = ["coco_map"]

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def _ap_101(scores: np.ndarray, matched: np.ndarray, n_gt: int) -> np.ndarray:
    """[T] AP over IoU thresholds via 101-point interpolation.
    ``matched`` is [n_det, T] bool in score-sorted order."""
    if n_gt == 0:
        return np.full(matched.shape[1], np.nan)
    if len(scores) == 0:
        return np.zeros(matched.shape[1])
    tp = np.cumsum(matched, axis=0)
    fp = np.cumsum(~matched, axis=0)
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, 1e-12)
    aps = np.zeros(matched.shape[1])
    for t in range(matched.shape[1]):
        # precision envelope (monotone non-increasing), sampled at 101 recalls
        pr = precision[:, t].copy()
        for i in range(len(pr) - 1, 0, -1):
            pr[i - 1] = max(pr[i - 1], pr[i])
        idx = np.searchsorted(recall[:, t], RECALL_POINTS, side="left")
        aps[t] = np.mean(np.where(idx < len(pr), pr[np.minimum(idx, len(pr) - 1)], 0.0))
    return aps


def coco_map(
    detections: Sequence[Tuple[int, int, float, np.ndarray]],
    ground_truth: Sequence[Tuple[int, int, np.ndarray]],
    num_classes: int,
    max_dets: int = 100,
) -> Dict[str, float]:
    """COCO bbox mAP.

    detections: (image_id, class_id, score, box_xyxy)
    ground_truth: (image_id, class_id, box_xyxy)
    Returns {"AP", "AP50", "AP75", "per_class": {cls: AP}}.
    """
    gt_by = defaultdict(list)
    for img, cls, box in ground_truth:
        gt_by[(img, cls)].append(np.asarray(box, np.float64))
    det_by = defaultdict(list)
    for img, cls, score, box in detections:
        det_by[(img, cls)].append((float(score), np.asarray(box, np.float64)))

    T = len(IOU_THRESHOLDS)
    per_class: Dict[int, float] = {}
    ap_grid: List[np.ndarray] = []
    for cls in range(num_classes):
        cls_scores: List[float] = []
        cls_matched: List[np.ndarray] = []
        n_gt = 0
        images = {img for (img, c) in list(gt_by) + list(det_by) if c == cls}
        for img in images:
            gts = gt_by.get((img, cls), [])
            n_gt += len(gts)
            dets = sorted(det_by.get((img, cls), []), key=lambda d: -d[0])[:max_dets]
            if not dets:
                continue
            gt_arr = np.stack(gts) if gts else np.zeros((0, 4))
            taken = np.zeros((len(gts), T), bool)
            for score, box in dets:
                m = np.zeros(T, bool)
                if len(gts):
                    ious = iou_xyxy(box[None], gt_arr)[0]
                    for t, thr in enumerate(IOU_THRESHOLDS):
                        order = np.argsort(-ious)
                        for j in order:
                            if ious[j] >= thr and not taken[j, t]:
                                taken[j, t] = True
                                m[t] = True
                                break
                cls_scores.append(score)
                cls_matched.append(m)
        if not cls_scores and n_gt == 0:
            continue  # class absent entirely: excluded from the mean (COCO)
        order = np.argsort(-np.asarray(cls_scores)) if cls_scores else np.array([], int)
        matched = (
            np.stack(cls_matched)[order] if cls_matched else np.zeros((0, T), bool)
        )
        scores = np.asarray(cls_scores)[order] if cls_scores else np.array([])
        aps = _ap_101(scores, matched, n_gt)
        ap_grid.append(aps)
        per_class[cls] = float(np.nanmean(aps))

    if not ap_grid:
        return {"AP": 0.0, "AP50": 0.0, "AP75": 0.0, "per_class": {}}
    grid = np.stack(ap_grid)  # [classes, T]
    mean_t = np.nanmean(grid, axis=0)
    return {
        "AP": float(np.nanmean(mean_t)),
        "AP50": float(mean_t[0]),
        "AP75": float(mean_t[IOU_THRESHOLDS.tolist().index(0.75)]),
        "per_class": per_class,
    }
