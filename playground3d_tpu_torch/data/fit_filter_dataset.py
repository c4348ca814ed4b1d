"""Filtering dataset: per-object tracklet windows for KF parameter fitting
(numpy copy of ``playground3d_tpu/data/fit_filter_dataset.py``).

Parity with the reference's ``i24_fit_filter_dataset.Filtering_Dataset``
(i24_fit_filter_dataset.py:164-527): labels grouped into per-(camera,object)
tracklets (:270-284), served as fixed-length windows (:286-304,
min_length=9) — optionally WITH the corresponding frames, which the
measurement-noise fit needs (detector-vs-GT residuals require running the
detector on real frames, reference fit_filter_3D.py:306-392).

Frames come from any lookup ``(camera, frame_number) -> [H,W,3]`` — a frame
cache directory, decoded video, or synthetic renderer.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from playground3d_tpu_torch.evaluation.csv_io import load_i24_csv, parse_state_row

__all__ = ["FilteringDataset"]


class FilteringDataset:
    def __init__(
        self,
        csv_path: str,
        min_length: int = 9,
        camera: Optional[str] = None,
        frame_lookup: Optional[Callable[[str, int], np.ndarray]] = None,
    ):
        """csv_path: 46-column tracking/label CSV. Windows are served per
        (camera, object) tracklet with at least ``min_length`` labels."""
        _, data = load_i24_csv(csv_path)
        tracks: Dict[Tuple[str, int], List[Tuple[int, float, np.ndarray]]] = {}
        for frame in sorted(data.keys()):
            for row in data[frame]:
                cam = row[36].strip() if len(row) > 36 else ""
                if camera is not None and cam != camera:
                    continue
                try:
                    oid = int(float(row[2]))
                    t = float(row[1])
                    s7 = parse_state_row(row)
                except (ValueError, IndexError):
                    continue
                tracks.setdefault((cam, oid), []).append((int(frame), t, s7))

        self.min_length = min_length
        self.frame_lookup = frame_lookup
        self.tracklets = []
        for (cam, oid), rows in sorted(tracks.items()):
            rows.sort(key=lambda r: r[1])
            if len(rows) >= min_length:
                self.tracklets.append(
                    {
                        "camera": cam,
                        "obj_id": oid,
                        "frames": np.array([r[0] for r in rows], np.int64),
                        "times": np.array([r[1] for r in rows], np.float64),
                        "states": np.stack([r[2] for r in rows]),
                    }
                )

    def __len__(self) -> int:
        return len(self.tracklets)

    def window(
        self, idx: int, start: int = 0, length: Optional[int] = None,
        with_images: bool = False,
    ) -> dict:
        """One tracklet window: states [L,7], times [L], frame numbers [L],
        camera, obj_id — plus images [L,H,W,3] when ``with_images`` (needs a
        frame_lookup; reference __getitem__ :286-304)."""
        tr = self.tracklets[idx]
        L = length if length is not None else self.min_length
        L = min(L, len(tr["times"]) - start)
        out = {
            "camera": tr["camera"],
            "obj_id": tr["obj_id"],
            "frames": tr["frames"][start : start + L],
            "times": tr["times"][start : start + L],
            "states": tr["states"][start : start + L],
        }
        if with_images:
            assert self.frame_lookup is not None, "no frame_lookup attached"
            out["images"] = np.stack(
                [self.frame_lookup(tr["camera"], int(f)) for f in out["frames"]]
            )
        return out

    def windows(self, length: Optional[int] = None, with_images: bool = False):
        """All maximal non-overlapping windows across tracklets."""
        L = length if length is not None else self.min_length
        for i, tr in enumerate(self.tracklets):
            for start in range(0, len(tr["times"]) - L + 1, L):
                yield self.window(i, start, L, with_images)
