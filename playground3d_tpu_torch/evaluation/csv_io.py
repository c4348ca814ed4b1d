"""The canonical 46-column tracking CSV schema (copy of
``playground3d_tpu/evaluation/csv_io.py``).

Reader/writer for the I-24 tracking output format produced by the reference
trackers (reference minimal_3D_track.py:786-832 header,
MC3D_crop_tracker.py:1333-1380) and consumed by the evaluator and datareader.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DATA_HEADER = [
    "Frame #", "Timestamp", "Object ID", "Object class",
    "BBox xmin", "BBox ymin", "BBox xmax", "BBox ymax",
    "vel_x", "vel_y", "Generation method",
    # 16 image-space 3D box corners (cols 11-26)
    "fbrx", "fbry", "fblx", "fbly", "bbrx", "bbry", "bblx", "bbly",
    "ftrx", "ftry", "ftlx", "ftly", "btrx", "btry", "btlx", "btly",
    # 8 roadway-plane footprint coords (cols 27-34)
    "fbr_x", "fbr_y", "fbl_x", "fbl_y", "bbr_x", "bbr_y", "bbl_x", "bbl_y",
    "direction", "camera", "acceleration", "speed",
    "veh rear x", "veh center y", "theta", "width", "length", "height",
]

# column indices used by consumers
COL_FRAME = 0
COL_TIMESTAMP = 1
COL_ID = 2
COL_CLASS = 3
COL_IM_CORNERS = slice(11, 27)
COL_SPACE = slice(27, 35)
COL_DIRECTION = 35
COL_CAMERA = 36
COL_SPEED = 38
COL_X = 39
COL_Y = 40
COL_THETA = 41
COL_WIDTH = 42
COL_LENGTH = 43
COL_HEIGHT = 44


def load_i24_csv(path: str) -> Tuple[List[str], Dict[int, List[List[str]]]]:
    """Parse a tracking CSV into (headers, {frame -> [row, ...]}).

    Mirrors the reference's ``load_i24_csv`` (homography.py:750-791): header
    lines pass through until the row starting with "Frame #"; rows with an
    unparseable/absent frame number are keyed by insertion order of their
    frame column value.
    """
    rows = []
    with open(path, "r") as f:
        for row in csv.reader(f):
            rows.append(row)

    headers: List[str] = []
    data: Dict[int, List[List[str]]] = {}
    in_headers = True
    for row in rows:
        if in_headers:
            headers = row
            if len(row) > 0 and row[0] == "Frame #":
                in_headers = False
            continue
        if len(row) == 0:
            continue
        try:
            frame_idx = int(row[0])
        except ValueError:
            continue  # MC tracker writes "-" for frame; those rows are
            # time-indexed and handled by the datareader instead
        data.setdefault(frame_idx, []).append(row)
    return headers, data


def load_i24_csv_by_time(path: str):
    """Parse a time-indexed MC-tracker CSV: returns list of
    (timestamp, id, class, state7 [x,y,l,w,h,dir,v]) tuples."""
    out = []
    with open(path, "r") as f:
        reader = csv.reader(f)
        in_headers = True
        for row in reader:
            if in_headers:
                if len(row) > 0 and row[0] == "Frame #":
                    in_headers = False
                continue
            if len(row) < 45:
                continue
            state = np.array(
                [row[COL_X], row[COL_Y], row[COL_LENGTH], row[COL_WIDTH],
                 row[COL_HEIGHT], row[COL_DIRECTION], row[COL_SPEED]],
                dtype=np.float64,
            )
            out.append((float(row[COL_TIMESTAMP]), int(row[COL_ID]), row[COL_CLASS], state))
    return out


@dataclass
class TrackRecord:
    """One output row in object/state form."""

    frame: Optional[int]  # None -> written as "-" (MC tracker style)
    timestamp: float
    obj_id: int
    class_name: str
    state7: np.ndarray  # [7] x,y,l,w,h,dir,v
    im_corners: np.ndarray  # [8,2]
    space_footprint: np.ndarray  # [4,2] bottom corners x,y
    camera: str
    gen: str = "3D Detector"
    ts_bias: Optional[list] = None


def write_results_csv(path: str, records: Sequence[TrackRecord], ts_bias_cameras=None) -> None:
    """Write tracking rows in the 46-column schema
    (reference minimal_3D_track.py:756-915, MC3D_crop_tracker.py:1318-1453).
    """
    header = list(DATA_HEADER)
    if ts_bias_cameras is not None:
        header.append("ts_bias for cameras {}".format(ts_bias_cameras))
    with open(path, "w", newline="") as f:
        out = csv.writer(f, delimiter=",")
        out.writerow(header)
        for r in records:
            s = r.state7
            bbox3d = r.im_corners.reshape(-1)
            minx, maxx = float(r.im_corners[:, 0].min()), float(r.im_corners[:, 0].max())
            miny, maxy = float(r.im_corners[:, 1].min()), float(r.im_corners[:, 1].max())
            row = [
                r.frame if r.frame is not None else "-",
                repr(float(r.timestamp)),
                r.obj_id,
                r.class_name,
                minx, miny, maxx, maxy,
                0, 0,
                r.gen,
            ]
            row += [float(v) for v in bbox3d]
            row += [float(v) for v in r.space_footprint.reshape(-1)]
            row += [
                float(s[5]),
                r.camera,
                0,
                float(s[6]),
                float(s[0]),
                float(s[1]),
                float(np.pi / 2.0 if s[5] == -1 else 0.0),
                float(s[3]),
                float(s[2]),
                float(s[4]),
            ]
            if r.ts_bias is not None:
                row.append(r.ts_bias)
            out.writerow(row)


def parse_state_row(row: List[str]) -> np.ndarray:
    """Extract the 7-value state from a CSV row (the evaluator's read,
    mot_evaluator.py:186-193, including the missing-height fix)."""
    if len(row) == 44:  # missing-height-column fix parity
        row = row + ["2"]
    return np.array(
        [row[COL_X], row[COL_Y], row[COL_LENGTH], row[COL_WIDTH], row[COL_HEIGHT],
         row[COL_DIRECTION], row[COL_SPEED]],
        dtype=np.float64,
    )  # [x, y, l, w, h, dir, v]
