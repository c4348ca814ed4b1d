"""Per-class average-precision evaluation for 2D detections (copy of
``playground3d_tpu/evaluation/ap.py``).

Standard detector eval utility mirroring the reference's vendored
``csv_eval.py`` (pytorch_retinanet_detector_directional/retinanet/
csv_eval.py:11-243): per-class AP at an IoU threshold with the
all-point-interpolated precision/recall integral (``_compute_ap``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from playground3d_tpu_torch.evaluation.geometry_np import iou_xyxy


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """All-point interpolated AP (reference csv_eval.py:38-63)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def evaluate_detections(
    detections: Sequence[Tuple[int, int, float, np.ndarray]],
    ground_truth: Sequence[Tuple[int, int, np.ndarray]],
    num_classes: int,
    iou_threshold: float = 0.5,
) -> Dict[int, float]:
    """AP per class.

    detections: (frame, class_id, score, box_xyxy) tuples
    ground_truth: (frame, class_id, box_xyxy) tuples
    (reference csv_eval.py:156-243 ``evaluate``)
    """
    aps: Dict[int, float] = {}
    for c in range(num_classes):
        dets = [d for d in detections if d[1] == c]
        gts = [g for g in ground_truth if g[1] == c]
        n_gt = len(gts)
        if n_gt == 0:
            aps[c] = float("nan")
            continue
        dets.sort(key=lambda d: -d[2])
        gt_by_frame: Dict[int, List[np.ndarray]] = {}
        used_by_frame: Dict[int, List[bool]] = {}
        for f, _, box in gts:
            gt_by_frame.setdefault(f, []).append(box)
            used_by_frame.setdefault(f, []).append(False)

        tp = np.zeros(len(dets))
        fp = np.zeros(len(dets))
        for i, (f, _, score, box) in enumerate(dets):
            cand = gt_by_frame.get(f, [])
            if not cand:
                fp[i] = 1
                continue
            ious = iou_xyxy(box[None], np.stack(cand))[0]
            j = int(np.argmax(ious))
            if ious[j] >= iou_threshold and not used_by_frame[f][j]:
                tp[i] = 1
                used_by_frame[f][j] = True
            else:
                fp[i] = 1
        ctp = np.cumsum(tp)
        cfp = np.cumsum(fp)
        recall = ctp / n_gt
        precision = ctp / np.maximum(ctp + cfp, 1e-9)
        aps[c] = compute_ap(recall, precision)
    return aps


def mean_ap(aps: Dict[int, float]) -> float:
    vals = [v for v in aps.values() if not np.isnan(v)]
    return float(np.mean(vals)) if vals else float("nan")
