# A frozen copy of the port's utils/config.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""Tracker and detector configuration (copy of
``playground3d_tpu/utils/config.py``).

Field names, defaults and meanings are the JAX package's; see that module
for the long-form notes on each extension knob.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class TrackerConfig:
    """Tracker hyperparameters (reference MC3D_crop_tracker.py:62-87 and
    KIOU defaults minimal_3D_track.py:32-46)."""

    sigma_d: float = 0.1  # min detection confidence
    sigma_c: float = 0.1  # min crop-detection confidence
    sigma_min: float = 0.5  # min confidence for object persistence
    f_init: int = 5  # frames before an object is permanent
    phi_nms_space: float = 0.2  # roadway-plane NMS IoU during parsing
    phi_nms_im: float = 0.3  # image-space NMS IoU during parsing
    phi_match: float = 0.1  # required IoU for detection -> track match
    phi_over: float = 0.1  # post-update track overlap pruning IoU
    w_conf: float = 0.5  # crop best-box weight: (1-W)*IoU + W*conf
    cd_max: int = 50  # top-k crop candidates per object
    f_max: int = 5  # frames-since-last-detection before death
    cs: int = 112  # crop size
    crop_expand: float = 1.25  # square crop expansion ratio (b)
    det_step: int = 1  # full-frame detection every d frames
    skip_step: int = 1  # crop re-detection every s frames
    crop_slots: int = 0  # crop branch: max live slots cropped per step (0 = all)
    max_size: Tuple[float, float, float] = (100.0, 15.0, 15.0)  # L,W,H ft
    x_range: Tuple[float, float] = (0.0, 2000.0)
    y_range: Tuple[float, float] = (-10.0, 120.0)  # anomaly bounds on y
    v_max: float = 150.0  # |speed| bound ft/s
    match_iou_nms: float = 0.5  # detector-internal NMS IoU
    matching_cutoff: float = 0.95  # single-cam KIOU match distance cutoff
    det_conf_cutoff: float = 0.3  # single-cam KIOU confidence cutoff
    fsld_max: int = 3  # single-cam KIOU death counter
    iou_cutoff: float = 0.1  # single-cam overlap pruning
    ts_alpha: float = 0.05  # clock-bias EMA rate
    estimate_ts_bias: bool = True
    merge_dist_ft: float = 0.0  # same-direction duplicate merge radius (0 = off)
    size_nudge: bool = False  # crop-branch class-size KF nudge (model 3)
    crop_conf_gate: bool = False  # skip crop KF updates below sigma_c
    ghost_frames: int = 0  # ghost re-id window in detect frames (0 = off)
    ghost_r_ft: float = 15.0
    tentative_age: int = 0  # first failed attempt while age <= this kills

    # capacities (fixed shapes on device)
    max_tracks: int = 128
    max_dets: int = 128
    pre_topk: int = 4096
    # the JAX package's TPU-only approximate top-k; the port is exact
    approx_topk: bool = False
    det_min_level: int = 3  # lowest pyramid level the detector runs heads on
