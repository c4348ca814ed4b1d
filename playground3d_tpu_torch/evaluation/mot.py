"""MOT evaluator: frame-by-frame GT<->prediction matching and metrics (copy
of ``playground3d_tpu/evaluation/mot.py``).

Re-implementation of the reference ``MOT_Evaluator`` (mot_evaluator.py) with
the per-frame O(n^2) python IoU loops vectorized. Consumes two CSVs in the
46-column schema plus a camera correspondence; produces the same metric set:
TP/FP/FN (+edge-case and @0.2 variants), recall/precision/FAR,
fragmentations, ID switches, MOTA variants, state precision (ft), and
image-space top/bottom pixel error, plus the class confusion matrix.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from playground3d_tpu_torch.evaluation import geometry_np as G
from playground3d_tpu_torch.evaluation.csv_io import (
    COL_CLASS,
    COL_ID,
    COL_IM_CORNERS,
    COL_SPEED,
    load_i24_csv,
    parse_state_row,
)
from playground3d_tpu_torch.ops.assignment import assign_hungarian
from playground3d_tpu_torch.utils.constants import (
    CLASS_IDS,
    FRAME_HEIGHT,
    FRAME_WIDTH,
    NUM_CLASSES,
    class_heights_for,
)

METRIC_UNITS = {
    "Match IOU": "",
    "Pre-threshold IOU": "",
    "Width precision": "ft",
    "Height precision": "ft",
    "Length precision": "ft",
    "Velocity precision": "ft/s",
    "X precision": "ft",
    "Y precision": "ft",
    "Bottom im precision": "px",
    "Top im precision": "px",
}


@dataclass
class MOTAccumulator:
    TP: int = 0
    FP: int = 0
    FN: int = 0
    FP_edge: int = 0
    FP_02: int = 0
    FN_02: int = 0
    pre_thresh_iou: List[float] = field(default_factory=list)
    match_iou: List[float] = field(default_factory=list)
    state_err: List[np.ndarray] = field(default_factory=list)
    im_bot_err: List[float] = field(default_factory=list)
    im_top_err: List[float] = field(default_factory=list)
    confusion: np.ndarray = field(
        default_factory=lambda: np.zeros((NUM_CLASSES + 2, NUM_CLASSES + 2), int)
    )
    ids: Dict[int, List[int]] = field(default_factory=dict)
    gt_ids: set = field(default_factory=set)
    pred_ids: set = field(default_factory=set)


class MOTEvaluator:
    """Evaluate a prediction CSV against ground truth.

    Parameters mirror the reference (mot_evaluator.py:40-47): ``match_iou``
    threshold and ``cutoff_frame``. The camera geometry comes as
    (H [3,3] im->space, P [3,4] space->im) for the evaluated camera.
    """

    def __init__(
        self,
        gt_path: str,
        pred_path: str,
        H: np.ndarray,
        P: np.ndarray,
        match_iou: float = 0.0,
        cutoff_frame: int = 10000,
        camera: Optional[str] = None,
        pred_from_image: bool = False,
    ):
        """``pred_from_image``: derive prediction states from their IMAGE
        corners through this evaluator's homography (the same path GT
        takes) instead of trusting the CSV's state columns. Image space is
        shared across artifacts, so this scores a tracker CSV produced
        under a DIFFERENT roadway-frame fit in the GT's frame — the
        common-frame re-score for the reference's committed CSVs
        (docs/REF_PARITY.md)."""
        self.H = np.asarray(H, np.float64)
        self.P = np.asarray(P, np.float64)
        self.match_iou = match_iou
        self.cutoff_frame = cutoff_frame
        _, self.gt = load_i24_csv(gt_path)
        _, self.pred = load_i24_csv(pred_path)
        if camera is not None:
            # evaluate a single camera's rows (column 36; multi-camera GT
            # files interleave cameras per frame)
            def keep(d):
                out = {}
                for f, rows in d.items():
                    rows = [r for r in rows if len(r) > 36 and r[36].strip() == camera]
                    if rows:
                        out[f] = rows
                return out

            self.gt = keep(self.gt)
            self.pred = keep(self.pred)
        self.pred_from_image = pred_from_image
        self.m = MOTAccumulator()
        self.metrics: Optional[dict] = None

    # -- helpers -------------------------------------------------------------
    def _gt_frame(self, rows):
        """GT rows -> (state7 [n,7], space [n,8,3], im [n,8,2], ids, classes)
        with the reference's two-pass height refinement
        (mot_evaluator.py:168-175)."""
        im, ids, classes, vels = [], [], [], []
        for box in rows:
            im.append(np.array(box[COL_IM_CORNERS], dtype=np.float64))
            ids.append(int(box[COL_ID]))
            classes.append(box[COL_CLASS])
            v = box[COL_SPEED]
            vels.append(float(v) if len(v) > 0 else 0.0)
        im = np.stack(im).reshape(-1, 8, 2)
        heights = class_heights_for(classes).astype(np.float64)
        state = G.im_to_state(im, self.H, heights)
        repro = G.state_to_im(state, self.P)
        refined = G.height_from_template(repro, heights, im)
        state = G.im_to_state(im, self.H, refined)
        space = G.state_to_space(state)
        state7 = np.concatenate([state, np.array(vels)[:, None]], axis=1)
        return state7, space, im, ids, classes

    def _pred_frame(self, rows):
        if self.pred_from_image:
            # _gt_frame already carries the CSV's velocity column through to
            # state7[:, 6] (with the empty-field guard), so nothing more to do
            return self._gt_frame(rows)
        state7 = np.stack([parse_state_row(r) for r in rows])
        space = G.state_to_space(state7)
        im = G.state_to_im(state7, self.P)
        ids = [int(r[COL_ID]) for r in rows]
        classes = [r[COL_CLASS] for r in rows]
        return state7, space, im, ids, classes

    # -- main ----------------------------------------------------------------
    def evaluate(self) -> dict:
        m = self.m
        for f_idx in range(self.cutoff_frame):
            gt_rows = self.gt.get(f_idx)
            pred_rows = self.pred.get(f_idx)
            if gt_rows is None:
                if pred_rows is not None:
                    m.FP += len(pred_rows)
                    for r in pred_rows:
                        m.pred_ids.add(int(r[COL_ID]))
                continue
            if pred_rows is None:
                m.FN += len(gt_rows)
                for r in gt_rows:
                    m.gt_ids.add(int(r[COL_ID]))
                continue

            gt_state, gt_space, gt_im, gt_ids, gt_classes = self._gt_frame(gt_rows)
            pr_state, pr_space, pr_im, pr_ids, pr_classes = self._pred_frame(pred_rows)

            first = G.footprint_xyxy(gt_space)
            second = G.footprint_xyxy(pr_space)
            ious = G.iou_xyxy(first, second)

            col_of_row = assign_hungarian(ious, maximize=True)
            matches = []
            matched_cols = set()
            for a in range(len(first)):
                b = col_of_row[a]
                if b < 0:
                    continue
                iou = ious[a, b]
                m.pre_thresh_iou.append(iou)
                matched_cols.add(int(b))
                if iou >= self.match_iou:
                    matches.append((a, int(b)))
                    m.match_iou.append(iou)

            # edge-case FPs: unmatched preds partially out of frame
            # (mot_evaluator.py:282-291)
            for i in range(len(pr_im)):
                if i not in matched_cols:
                    obj = pr_im[i]
                    if (
                        obj[0, 0] < 0 or obj[2, 0] < 0
                        or obj[0, 0] > FRAME_WIDTH or obj[2, 0] > FRAME_WIDTH
                    ):
                        m.FP_edge += 1
                    elif (
                        obj[0, 1] < 0 or obj[2, 1] < 0
                        or obj[0, 1] > FRAME_HEIGHT or obj[2, 1] > FRAME_HEIGHT
                    ):
                        m.FP_edge += 1

            m.TP += len(matches)
            m.FP += max(0, len(pr_state) - len(matches))
            m.FN += max(0, len(gt_state) - len(matches))
            n_assigned = int((col_of_row >= 0).sum())
            m.FP_02 += max(0, len(pr_state) - n_assigned)
            m.FN_02 += max(0, len(gt_state) - n_assigned)

            for a, b in matches:
                err = np.clip(np.abs(pr_state[b] - gt_state[a]), 0, 500)
                m.state_err.append(err)
                bot = np.clip(
                    np.sqrt(((pr_im[b, 0:4] - gt_im[a, 0:4]) ** 2).sum(1)).mean(), 0, 500
                )
                top = np.clip(
                    np.sqrt(((pr_im[b, 4:8] - gt_im[a, 4:8]) ** 2).sum(1)).mean(), 0, 500
                )
                m.im_bot_err.append(bot)
                m.im_top_err.append(top)

                gt_cls = CLASS_IDS.get(gt_classes[a], 5)
                pr_cls = CLASS_IDS.get(pr_classes[b], 5)
                m.confusion[gt_cls, pr_cls] += 1

                gt_id, pred_id = gt_ids[a], pr_ids[b]
                hist = m.ids.setdefault(gt_id, [])
                if len(hist) == 0 or hist[-1] != pred_id:
                    hist.append(pred_id)
                m.pred_ids.add(pred_id)
                m.gt_ids.add(gt_id)

        return self._finalize()

    def _finalize(self) -> dict:
        m = self.m
        metrics = {
            "iou_threshold": self.match_iou,
            "True unique objects": len(m.gt_ids),
            "Predicted unique objects": len(m.pred_ids),
            "TP": m.TP,
            "FP": m.FP,
            "FN": m.FN,
            "FP edge-case": m.FP_edge,
            "FP @ 0.2": m.FP_02,
            "FN @ 0.2": m.FN_02,
        }
        tp = max(m.TP, 1)
        metrics["Recall"] = m.TP / max(m.TP + m.FN, 1)
        metrics["Precision"] = m.TP / max(m.TP + m.FP, 1)
        metrics["False Alarm Rate"] = m.FP / tp

        frag = sum(len(v) - 1 for v in m.ids.values())
        metrics["Fragmentations"] = frag

        # ID switches: a pred id appearing in >1 GT id history
        # (mot_evaluator.py:366-376)
        count = 0
        for pred_id in m.pred_ids:
            uses = sum(1 for hist in m.ids.values() if pred_id in hist)
            if uses > 1:
                count += uses - 1
        metrics["ID switches"] = count

        metrics["MOTA"] = 1 - (m.FN + frag + count + m.FP) / tp
        metrics["MOTA edge-case"] = 1 - (m.FN + frag + count + m.FP - m.FP_edge) / tp
        metrics["MOTA @ 0.2"] = 1 - (m.FN_02 + frag + count + m.FP_02) / tp

        def mean_std(vals):
            if len(vals) == 0:
                return (float("nan"), float("nan"))
            arr = np.asarray(vals)
            return (float(arr.mean()), float(arr.std()))

        metrics["Pre-threshold IOU"] = mean_std(m.pre_thresh_iou)
        metrics["Match IOU"] = mean_std(m.match_iou)
        if m.state_err:
            se = np.stack(m.state_err)
            mean, std = se.mean(0), se.std(0)
            metrics["Width precision"] = (mean[3], std[3])
            metrics["Height precision"] = (mean[4], std[4])
            metrics["Length precision"] = (mean[2], std[2])
            metrics["Velocity precision"] = (mean[6], std[6])
            metrics["X precision"] = (mean[0], std[0])
            metrics["Y precision"] = (mean[1], std[1])
        metrics["Bottom im precision"] = mean_std(m.im_bot_err)
        metrics["Top im precision"] = mean_std(m.im_top_err)

        self.metrics = metrics
        self.confusion = m.confusion
        return metrics

    def print_metrics(self) -> None:
        assert self.metrics is not None
        for name, val in self.metrics.items():
            unit = METRIC_UNITS.get(name)
            if isinstance(val, tuple):
                print(f"{name:<30}: {val[0]:.2f}{unit} avg., {val[1]:.2f}{unit} st.dev.")
            else:
                print(f"{name:<30}: {val:.3f}")
        print("Class confusion matrix:")
        print(self.confusion)
