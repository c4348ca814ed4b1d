"""CSV-annotation detection dataset (2D; numpy copy of
``playground3d_tpu/data/csv_dataset.py``), parity with the reference's
``CSVDataset`` (pytorch_retinanet_detector_directional/retinanet/
dataloader.py:126-300) and its Resizer/Augmenter transforms (:339-398).

Annotation format (one box per line):  path,x1,y1,x2,y2,class_name
Class-map format:                       class_name,id
Empty boxes ("path,,,,,") mark negative images.

Images load from .png (stdlib codec) or .npy; resize is aspect-preserving
to [min_side, max_side] with /32 padding (Resizer parity); augmentation is
horizontal flip (Augmenter parity).
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import numpy as np

from playground3d_tpu_torch.utils.constants import IMAGENET_MEAN, IMAGENET_STD

MAX_OBJS_2D = 64


def load_class_map(path: str) -> Dict[str, int]:
    out = {}
    with open(path) as f:
        for row in csv.reader(f):
            if len(row) >= 2 and row[0]:
                out[row[0]] = int(row[1])
    return out


def load_annotations(path: str) -> Dict[str, List[Tuple[float, float, float, float, str]]]:
    """path -> [(x1,y1,x2,y2,class), ...]; negatives map to []."""
    out: Dict[str, list] = defaultdict(list)
    with open(path) as f:
        for row in csv.reader(f):
            if not row:
                continue
            img = row[0]
            if len(row) < 6 or row[1] == "":
                out[img]  # register negative image
                continue
            x1, y1, x2, y2 = map(float, row[1:5])
            if x2 <= x1 or y2 <= y1:
                raise ValueError(f"degenerate box in {path}: {row}")
            out[img].append((x1, y1, x2, y2, row[5]))
    return dict(out)


def resize_keep_aspect(
    img: np.ndarray, min_side: int = 608, max_side: int = 1024
) -> Tuple[np.ndarray, float]:
    """Aspect-preserving resize with /32 zero-padding (reference
    Resizer, dataloader.py:339-372). Returns (padded image, scale)."""
    h, w = img.shape[:2]
    scale = min_side / min(h, w)
    if max(h, w) * scale > max_side:
        scale = max_side / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    yi = np.clip((np.arange(nh) / scale).astype(int), 0, h - 1)
    xi = np.clip((np.arange(nw) / scale).astype(int), 0, w - 1)
    resized = img[yi][:, xi]
    ph = (nh + 31) // 32 * 32
    pw = (nw + 31) // 32 * 32
    out = np.zeros((ph, pw, img.shape[2]), img.dtype)
    out[:nh, :nw] = resized
    return out, scale


class CSVDetectionDataset:
    """Yields (image [H,W,3] normalized f32, annotations [MAX,5] xyxy+class,
    -1 padded) batches for the 2D detector."""

    def __init__(
        self,
        annotations_csv: str,
        class_map_csv: str,
        root: str = "",
        min_side: int = 608,
        max_side: int = 1024,
        augment: bool = True,
        seed: int = 0,
    ):
        self.root = root
        self.annotations = load_annotations(annotations_csv)
        self.class_map = load_class_map(class_map_csv)
        self.paths = sorted(self.annotations.keys())
        self.min_side, self.max_side = min_side, max_side
        self.augment = augment
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def num_classes(self) -> int:
        return max(self.class_map.values()) + 1

    def _load_image(self, path: str) -> np.ndarray:
        full = os.path.join(self.root, path)
        if full.endswith(".npy"):
            img = np.load(full)
        else:
            from playground3d_tpu_torch.data.video import read_png

            img = read_png(full)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        return img

    def sample(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        path = self.paths[idx]
        img = self._load_image(path)
        img, scale = resize_keep_aspect(img, self.min_side, self.max_side)
        ann = np.full((MAX_OBJS_2D, 5), -1.0, np.float32)
        boxes = self.annotations[path]
        for i, (x1, y1, x2, y2, cname) in enumerate(boxes[:MAX_OBJS_2D]):
            ann[i] = [x1 * scale, y1 * scale, x2 * scale, y2 * scale, self.class_map[cname]]
        if self.augment and self.rng.uniform() < 0.5:
            w = img.shape[1]
            img = img[:, ::-1].copy()
            valid = ann[:, 4] >= 0
            x1 = ann[valid, 0].copy()
            ann[valid, 0] = w - 1 - ann[valid, 2]
            ann[valid, 2] = w - 1 - x1
        img = (img - IMAGENET_MEAN) / IMAGENET_STD
        return img.astype(np.float32), ann

    def batches(self, batch_size: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Aspect-ratio-grouped batches (AspectRatioBasedSampler parity:
        images with similar shape batch together so padding stays small)."""
        order = sorted(range(len(self)), key=lambda i: self.paths[i])
        while True:
            self.rng.shuffle(order)
            for k in range(0, len(order) - batch_size + 1, batch_size):
                samples = [self.sample(i) for i in order[k : k + batch_size]]
                hmax = max(s[0].shape[0] for s in samples)
                wmax = max(s[0].shape[1] for s in samples)
                imgs = np.zeros((batch_size, hmax, wmax, 3), np.float32)
                anns = np.stack([s[1] for s in samples])
                for b, (img, _) in enumerate(samples):
                    imgs[b, : img.shape[0], : img.shape[1]] = img
                yield imgs, anns
