"""COCO-format detection dataset loader (numpy copy of
``playground3d_tpu/data/coco.py``).

Functionality-parity with the reference's vendored ``CocoDataset``
(pytorch_retinanet_detector_directional/dataloader.py:23-124) without
pycocotools: reads the standard COCO annotation JSON (images / annotations /
categories), maps category ids to a dense 0..K-1 label space sorted by
category id, and serves (image [H,W,3] float32 in [0,1],
annotations [n,5] = x1,y1,x2,y2,label) samples. Boxes arrive in COCO
xywh and are converted to xyxy (dataloader.py:106-113); degenerate
boxes (w/h < 1 px) are dropped (dataloader.py:98-100).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["CocoDataset"]


class CocoDataset:
    def __init__(self, root_dir: str, ann_file: str, images_dir: Optional[str] = None):
        """root_dir/ann_file: COCO annotation JSON; images load from
        ``images_dir`` (default: root_dir)."""
        with open(os.path.join(root_dir, ann_file)) as f:
            coco = json.load(f)
        self.images_dir = images_dir or root_dir

        cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
        self.cat_to_label: Dict[int, int] = {c["id"]: i for i, c in enumerate(cats)}
        self.label_to_name: List[str] = [c["name"] for c in cats]
        self.images: List[dict] = coco.get("images", [])
        self._by_image: Dict[int, List[dict]] = {im["id"]: [] for im in self.images}
        for ann in coco.get("annotations", []):
            if ann.get("iscrowd", 0):
                continue
            if ann["image_id"] in self._by_image:
                self._by_image[ann["image_id"]].append(ann)

    def __len__(self) -> int:
        return len(self.images)

    @property
    def num_classes(self) -> int:
        return len(self.label_to_name)

    def annotations(self, idx: int) -> np.ndarray:
        """[n,5] x1,y1,x2,y2,label for image idx (xywh -> xyxy; sub-pixel
        boxes dropped, reference dataloader.py:90-113)."""
        im = self.images[idx]
        rows = []
        for ann in self._by_image[im["id"]]:
            x, y, w, h = ann["bbox"]
            if w < 1 or h < 1:
                continue
            rows.append([x, y, x + w, y + h, self.cat_to_label[ann["category_id"]]])
        if not rows:
            return np.zeros((0, 5), np.float32)
        return np.asarray(rows, np.float32)

    def load_image(self, idx: int) -> np.ndarray:
        from PIL import Image

        path = os.path.join(self.images_dir, self.images[idx]["file_name"])
        with Image.open(path) as img:
            arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
        return arr

    def sample(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.load_image(idx), self.annotations(idx)

    def iter_samples(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for i in range(len(self)):
            yield self.sample(i)
