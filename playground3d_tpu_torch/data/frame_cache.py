"""Frame-cache builder: real recordings + corrected label CSVs -> training
shards (numpy copy of ``playground3d_tpu/data/frame_cache.py``).

The reference's ``cache_corrected_frames`` (corrected_3D_dataset.py:24-128)
walks per-camera label CSVs, decodes the matching video, resizes to 1080p,
blacks out the camera's ignore polygon, and writes per-frame PNGs + label
lists up to each sequence's last hand-corrected frame. This module does the
same against this framework's structures: any :class:`FrameSource`-style
decode (y4m/cv2/PyAV/ffmpeg via ``VideoFrameSource``), ignore blackout via
:mod:`playground3d_tpu_torch.data.regions`, and output as the .npz shards that
the JAX package's ``CachedDetectionDataset`` trains from
(labels are the 21-value rows: 16 corner px + 4 2D-box px + class).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from playground3d_tpu_torch.data.dataset import MAX_OBJS, pad_labels
from playground3d_tpu_torch.evaluation.csv_io import load_i24_csv
from playground3d_tpu_torch.utils.constants import CLASS_NAMES

__all__ = ["labels_by_frame_from_csv", "cache_corrected_frames"]

_NAME_TO_ID = {n: i for i, n in enumerate(CLASS_NAMES)}


def labels_by_frame_from_csv(csv_path: str, camera: Optional[str] = None) -> Dict[int, np.ndarray]:
    """46-column label CSV -> {frame: [m,21] labels} (16 image corners +
    4-value 2D box + class id; reference corrected_3D_dataset.py:66-100)."""
    _, data = load_i24_csv(csv_path)
    out: Dict[int, np.ndarray] = {}
    for frame, rows in data.items():
        labs = []
        for row in rows:
            if camera is not None and len(row) > 36 and row[36].strip() != camera:
                continue
            try:
                corners = [float(v) for v in row[11:27]]
                bbox = [float(v) for v in row[4:8]]
            except (ValueError, IndexError):
                continue
            cls = _NAME_TO_ID.get(row[3].strip(), 0)
            labs.append(corners + bbox + [float(cls)])
        if labs:
            out[int(frame)] = np.asarray(labs, np.float32)
    return out


def cache_corrected_frames(
    sources: Dict[str, Iterable],
    label_csvs: Dict[str, str],
    output_dir: str,
    last_corrected_frame: Optional[Dict[str, int]] = None,
    skip_frames: int = 0,
    ignore_polygons: Optional[Dict[str, np.ndarray]] = None,
    shard_size: int = 64,
    resize_hw: Optional[Tuple[int, int]] = None,
) -> List[str]:
    """Build training shards from decoded frames + corrected labels.

    sources: camera -> frame iterable yielding (frame [H,W,3] float, t)
        (e.g. ``VideoFrameSource``; pass ``normalized=False`` sources when
        frames should be stored as raw uint8)
    label_csvs: camera -> corrected label CSV path
    last_corrected_frame: camera -> last frame with corrected labels
        (frames beyond it are skipped; -1 = skip camera entirely, matching
        reference corrected_3D_dataset.py:45-49)
    skip_frames: keep every (skip_frames+1)-th frame (reference default 29:
        one frame per second at 30 fps)
    ignore_polygons: camera -> [n,2] polygon to black out
    Returns the shard paths written.
    """
    from playground3d_tpu_torch.data.regions import polygon_mask

    os.makedirs(output_dir, exist_ok=True)
    shard_paths: List[str] = []
    buf_frames: List[np.ndarray] = []
    buf_labels: List[np.ndarray] = []

    def flush():
        if not buf_frames:
            return
        path = os.path.join(output_dir, f"shard_{len(shard_paths):04d}.npz")
        np.savez_compressed(
            path,
            frames=np.stack(buf_frames),
            labels=np.stack(buf_labels),
        )
        shard_paths.append(path)
        buf_frames.clear()
        buf_labels.clear()

    for camera, source in sources.items():
        stop = (last_corrected_frame or {}).get(camera)
        if stop is not None and stop < 0:
            continue
        labels = labels_by_frame_from_csv(label_csvs[camera], camera=camera)
        mask = None
        poly = (ignore_polygons or {}).get(camera)
        for frame_num, item in enumerate(source):
            frame = item[0] if isinstance(item, tuple) else item
            if stop is not None and frame_num > stop:
                break
            if skip_frames and frame_num % (skip_frames + 1) != 0:
                continue
            frame = np.asarray(frame)
            if resize_hw is not None and frame.shape[:2] != tuple(resize_hw):
                from playground3d_tpu_torch.data.video import resize_frame

                frame = resize_frame(frame, tuple(resize_hw))
            if poly is not None:
                if mask is None or mask.shape != frame.shape[:2]:
                    mask = polygon_mask(poly, frame.shape[0], frame.shape[1])
                frame = frame.copy()
                frame[mask] = 0
            if frame.dtype != np.uint8:
                frame = (np.clip(frame, 0.0, 1.0) * 255.0).astype(np.uint8)
            labs = labels.get(frame_num, np.zeros((0, 21), np.float32))
            buf_frames.append(frame)
            buf_labels.append(pad_labels(labs[:MAX_OBJS]))
            if len(buf_frames) >= shard_size:
                flush()
    flush()
    return shard_paths
