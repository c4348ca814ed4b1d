"""Single-camera 3D tracker (port of ``playground3d_tpu/pipeline/single_cam.py``,
reference ``KIOU_Tracker``, minimal_3D_track.py).

The per-frame pipeline - detect, parse to roadway state, associate
(roadway-IoU auction), Kalman update, births/deaths/pruning, snapshot - runs
on the device over fixed-capacity tensors; the host loop only stages frames
and drains one snapshot a frame, in one device->host read.

Detection is pluggable: the real RetinaNet (float or int8-quantized, conv7
or s2d stem; the int8 convs run ``csrc/qconv.cu`` on the card), or any
callable producing :class:`~playground3d_tpu_torch.models.retinanet.Detections`
(tests inject an oracle detector so the tracker logic runs without trained
weights). The JAX clip's ``lax.scan`` is a host loop here.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from playground3d_tpu_torch import DeviceLike, resolve_device
from playground3d_tpu_torch.evaluation import geometry_np as G
from playground3d_tpu_torch.evaluation.csv_io import TrackRecord, write_results_csv
from playground3d_tpu_torch.models.retinanet import Detections, RetinaNet, detect_multiframe
from playground3d_tpu_torch.ops.topk import HostSyncs
from playground3d_tpu_torch.pipeline.camera_bank import CameraBank, bank_from_registry
from playground3d_tpu_torch.pipeline.tracker_state import (
    Snapshot,
    TrackState,
    associate_and_update,
    init_track_state,
    lifecycle,
    pack_snapshot,
    parse_detections,
    snapshot,
    stack_snapshots,
    unpack_snapshot,
)
from playground3d_tpu_torch.track.kf import KFParams, default_params
from playground3d_tpu_torch.utils.config import TrackerConfig
from playground3d_tpu_torch.utils.constants import CLASS_NAMES
from playground3d_tpu_torch.utils.profiling import StageTimers


def _track_tail(state: TrackState, det: Detections, bank: CameraBank, cam_times: torch.Tensor,
                kfp: KFParams, cfg: TrackerConfig):
    parsed = parse_detections(det, bank, cam_times, cfg)
    t_ref = torch.mean(cam_times)
    state, _, _ = associate_and_update(state, parsed, t_ref, kfp, cfg)
    state = lifecycle(state, t_ref, kfp, cfg)
    return state, snapshot(state, t_ref, kfp, cfg)


def make_track_step(bank: CameraBank, kfp: KFParams, cfg: TrackerConfig):
    """(state, detections, cam_times) -> (state', snapshot)."""

    @torch.no_grad()
    def step(state: TrackState, det: Detections, cam_times: torch.Tensor):
        return _track_tail(state, det, bank, cam_times, kfp, cfg)

    return step


def make_full_step(
    det_model: RetinaNet,
    bank: CameraBank,
    kfp: KFParams,
    cfg: TrackerConfig,
    stem: str = "conv7",
):
    """(state, frames [C,H,W,3] or s2d-packed [C,H/4,W/4,48], cam_times [C])
    -> (state', snapshot): detector + tracker in one call."""
    if det_model.stem != stem:
        raise ValueError(f"make_full_step: stem={stem!r} but the detector was built with {det_model.stem!r}")

    @torch.no_grad()
    def step(state: TrackState, frames: torch.Tensor, cam_times: torch.Tensor):
        det = detect_multiframe(
            det_model, frames, pre_topk=cfg.pre_topk, max_dets=cfg.max_dets,
            approx_topk=cfg.approx_topk, min_level=cfg.det_min_level,
        )
        return _track_tail(state, det, bank, cam_times, kfp, cfg)

    return step


def make_clip_step(
    det_model: RetinaNet,
    bank: CameraBank,
    kfp: KFParams,
    cfg: TrackerConfig,
    stem: str = "conv7",
):
    """(state, frames [T,C,H,W,ch], cam_times [T,C]) -> (state', snapshots
    stacked over T): :func:`make_full_step` frame by frame, the port of the
    JAX clip's ``lax.scan``."""
    step = make_full_step(det_model, bank, kfp, cfg, stem=stem)

    @torch.no_grad()
    def clip(state: TrackState, frames: torch.Tensor, cam_times: torch.Tensor):
        snaps = []
        for t in range(frames.shape[0]):
            state, snap = step(state, frames[t], cam_times[t])
            snaps.append(snap)
        return state, stack_snapshots(snaps)

    return clip


class SingleCameraTracker:
    """Host loop: stages frames, drains snapshots, writes the 46-col CSV.

    Parameters
    ----------
    registry : CameraRegistry with the camera's correspondence
    camera : camera name (e.g. "p1c1")
    cfg : TrackerConfig
    kf_params : KFParams (defaults mirror the reference)
    det_model : the detector (already on ``device``), when ``detect_fn`` is None
    detect_fn : None to use ``det_model``; otherwise a callable
        (frames [1,H,W,3] on ``device``) -> Detections
    stem : the detector's stem, checked against ``det_model``
    on_frame : called (frame_num, frames [1,H,W,3], snap, None) after each frame
    device : where the tracker runs (the card unless the caller asks for the CPU)
    """

    def __init__(
        self,
        registry,
        camera: str,
        cfg: Optional[TrackerConfig] = None,
        kf_params: Optional[KFParams] = None,
        det_model: Optional[RetinaNet] = None,
        detect_fn: Optional[Callable] = None,
        stem: str = "conv7",
        on_frame: Optional[Callable] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.registry = registry
        self.camera = camera
        self.cam_idx = registry.index(camera)
        self.cfg = cfg = cfg if cfg is not None else TrackerConfig()
        self.kfp = kf_params if kf_params is not None else default_params(device=self.device)
        self.bank = bank_from_registry(registry, device=self.device)

        if detect_fn is not None:
            self._detect = detect_fn
            self._step = make_track_step(self.bank, self.kfp, cfg)
            self._fused = False
        else:
            if det_model is None:
                raise ValueError("SingleCameraTracker needs det_model or detect_fn")
            if det_model.stem != stem:
                raise ValueError(
                    f"SingleCameraTracker: stem={stem!r} but the detector was built with {det_model.stem!r}"
                )
            self._full = make_full_step(det_model, self.bank, self.kfp, cfg, stem=stem)
            self._fused = True

        self.state = init_track_state(cfg.max_tracks, self.device)
        self.epoch: Optional[float] = None
        self.rows: List[tuple] = []  # (frame, t_abs, ids, states7, classes)
        self.timers = StageTimers(["detect+track", "stage", "drain"])
        self.on_frame = on_frame

    @torch.no_grad()
    def process_frame(self, frame: np.ndarray, t_abs: float, frame_num: int) -> Snapshot:
        """frame [H,W,3] float32 (normalized) or uint8, or s2d-packed
        [H/4,W/4,48] for an s2d detector; t_abs float64 UNIX seconds."""
        if self.epoch is None:
            self.epoch = float(t_abs)
        t_off = np.float32(t_abs - self.epoch)
        cam_times = torch.tensor([t_off], device=self.device)

        with self.timers("stage"):
            frames = torch.as_tensor(np.asarray(frame)[None]).to(self.device)

        with self.timers("detect+track"):
            if self._fused:
                self.state, snap = self._full(self.state, frames, cam_times)
            else:
                det = self._detect(frames)
                self.state, snap = self._step(self.state, det, cam_times)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        with self.timers("drain"):
            # one read (pack_snapshot: every field exact in float64)
            states, ids, classes, mask, t = unpack_snapshot(HostSyncs.fetch(pack_snapshot(snap)))
            self.rows.append((frame_num, float(self.epoch + float(t)), ids[mask], states[mask], classes[mask]))
        if self.on_frame is not None:
            self.on_frame(frame_num, np.asarray(frame)[None], snap, None)
        return snap

    def track(self, frames: Iterable[Tuple[np.ndarray, float]], cutoff: int = 10**9):
        start = time.time()
        n = 0
        for frame_num, (frame, t_abs) in enumerate(frames):
            if frame_num >= cutoff:
                break
            self.process_frame(frame, t_abs, frame_num)
            n += 1
        wall = time.time() - start
        return {"frames": n, "fps": n / max(wall, 1e-9), **self.timers.totals()}

    # -- output --------------------------------------------------------------
    def records(self) -> List[TrackRecord]:
        c = self.cam_idx
        out = []
        for frame_num, t_abs, ids, states, classes in self.rows:
            if len(ids) == 0:
                continue
            space = G.state_to_space(states)
            use_wb = states[:, 1] > 60.0
            im_eb = G.space_to_im(space, self.registry.P[c, 0])
            im_wb = G.space_to_im(space, self.registry.P[c, 1])
            im = np.where(use_wb[:, None, None], im_wb, im_eb)
            for i in range(len(ids)):
                out.append(
                    TrackRecord(
                        frame=frame_num,
                        timestamp=t_abs,
                        obj_id=int(ids[i]),
                        class_name=CLASS_NAMES[int(classes[i])],
                        state7=states[i],
                        im_corners=im[i],
                        space_footprint=space[i, 0:4, :2],
                        camera=self.camera,
                    )
                )
        return out

    def write_results_csv(self, path: str) -> None:
        write_results_csv(path, self.records())
