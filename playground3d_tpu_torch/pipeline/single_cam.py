"""Single-camera 3D tracker (port of ``playground3d_tpu/pipeline/single_cam.py``,
reference ``KIOU_Tracker``, minimal_3D_track.py).

The per-frame pipeline - detect, parse to roadway state, associate
(roadway-IoU auction), Kalman update, births/deaths/pruning, snapshot - runs
on the device over fixed-capacity tensors; the host loop only stages frames
and drains one snapshot a frame, in one device->host read. The JAX package
compiles the detector's step into one program (``jax.jit``); here it runs
over static buffers (:class:`_StepGraph`) and, on the card, is one CUDA
graph, a frame one replay.

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
from playground3d_tpu_torch.pipeline.graphs import StaticGraphs, clone_state, copy_into, state_leaves
from playground3d_tpu_torch.pipeline.tracker_state import (
    Snapshot,
    TrackState,
    associate_and_update,
    init_track_state,
    lifecycle,
    pack_snapshot,
    parse_detections,
    snapshot,
    unpack_snapshot,
)
from playground3d_tpu_torch.track.kf import KFParams, default_params
from playground3d_tpu_torch.utils.config import TrackerConfig
from playground3d_tpu_torch.utils.constants import CLASS_NAMES
from playground3d_tpu_torch.utils.profiling import Spans


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


class _StepGraph:
    """A detector step (:func:`make_full_step`) over static buffers: the
    tracker state, one frame [C,...], its camera times [C], the snapshot
    and the snapshot packed for one read (:func:`pack_snapshot`). The step
    reads the buffers and writes its new state back into them; on the card
    it is captured once as a CUDA graph (:class:`StaticGraphs`), and a frame
    is: copy the frame and times in, one replay. On the CPU the same
    buffers and write-backs run without capture."""

    def __init__(self, step: Callable, device: torch.device):
        self.step = step
        self.programs = StaticGraphs(device)
        self.state = self.frame = self.cam_times = self.snap = self.packed = None

    def run(self, state: TrackState, frame: torch.Tensor, cam_times: torch.Tensor) -> None:
        """One frame from ``state`` (copied in unless it is this graph's own
        :attr:`state`); ``frame`` and ``cam_times`` are copied in without
        blocking (from pinned host memory or the device)."""
        dev = self.programs.device
        if self.state is None:
            self.state = clone_state(state)
            self.frame = torch.empty(frame.shape, dtype=frame.dtype, device=dev)
            self.cam_times = torch.empty(cam_times.shape, dtype=cam_times.dtype, device=dev)
        elif state is not self.state:
            copy_into(state_leaves(self.state), state_leaves(state))
        self.frame.copy_(frame, non_blocking=True)
        self.cam_times.copy_(cam_times, non_blocking=True)
        self.programs.run("step", self._body)

    def _body(self, write_back: bool):
        st, snap = self.step(self.state, self.frame, self.cam_times)
        packed = pack_snapshot(snap)  # before the state is written: the snapshot may alias the input state
        if write_back:
            copy_into(state_leaves(self.state), state_leaves(st))
            # on the card the capture's outputs: every replay rewrites them in place
            self.snap, self.packed = snap, packed


def make_clip_step(
    det_model: RetinaNet,
    bank: CameraBank,
    kfp: KFParams,
    cfg: TrackerConfig,
    stem: str = "conv7",
):
    """(state, frames [T,C,H,W,ch], cam_times [T,C]) -> (state', snapshots
    stacked over T): :func:`make_full_step` frame by frame, the port of the
    JAX clip's ``lax.scan``. Each frame is a run of the step over static
    buffers (:class:`_StepGraph`: one CUDA graph replay on the card)."""
    step = make_full_step(det_model, bank, kfp, cfg, stem=stem)
    runners: dict = {}  # (device, frame shape, dtype) -> _StepGraph

    @torch.no_grad()
    def clip(state: TrackState, frames: torch.Tensor, cam_times: torch.Tensor):
        key = (frames.device, tuple(frames.shape[1:]), frames.dtype)
        runner = runners.get(key)
        if runner is None:
            runner = runners[key] = _StepGraph(step, frames.device)
        out = None
        for t in range(frames.shape[0]):
            runner.run(state, frames[t], cam_times[t])
            state = runner.state
            if out is None:
                out = Snapshot(*(torch.empty((frames.shape[0],) + tuple(x.shape), dtype=x.dtype, device=x.device)
                                 for x in runner.snap))
            for dst, src in zip(out, runner.snap):
                dst[t].copy_(src)
        return clone_state(runner.state), out

    clip.runners = runners
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
        (frames [1,H,W,3] on ``device``) -> Detections, run eagerly
    stem : the detector's stem, checked against ``det_model``
    on_frame : called (frame_num, frames [1,H,W,3], snap, None) after each frame
    device : where the tracker runs (the card unless the caller asks for the CPU)
    graphs : with ``det_model``, run the step over static buffers
        (:class:`_StepGraph`: one CUDA graph replay a frame on the card; the
        tracker's :attr:`state` is then those buffers); False: eagerly
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
        graphs: bool = True,
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
        self._graph = _StepGraph(self._full, self.device) if self._fused and graphs else None
        self._pinned: dict = {}  # (shape, dtype) -> pinned host buffer the card copies from

        self.state = init_track_state(cfg.max_tracks, self.device)
        self.epoch: Optional[float] = None
        self.rows: List[tuple] = []  # (frame, t_abs, ids, states7, classes)
        # host seconds a span (:class:`Spans`): staging a frame, its step, its read
        self.spans = Spans(("detect+track", "stage", "drain"))
        self.timers = self.spans.totals
        self.on_frame = on_frame

    @torch.no_grad()
    def process_frame(self, frame: np.ndarray, t_abs: float, frame_num: int) -> Snapshot:
        """frame [H,W,3] float32 (normalized) or uint8, or s2d-packed
        [H/4,W/4,48] for an s2d detector; t_abs float64 UNIX seconds."""
        if self.epoch is None:
            self.epoch = float(t_abs)
        t_off = np.float32(t_abs - self.epoch)

        with self.spans("stage", frame_num):
            frames = self._stage(np.asarray(frame)[None])
            cam_times = self._stage(np.asarray([t_off], np.float32))

        with self.spans("detect+track", frame_num):
            if self._graph is not None:
                self._graph.run(self.state, frames, cam_times)
                self.state, packed = self._graph.state, self._graph.packed
                snap = Snapshot(*(x.clone() for x in self._graph.snap))  # the buffers change at the next frame
            else:
                frames = frames.to(self.device, non_blocking=True)
                cam_times = cam_times.to(self.device, non_blocking=True)
                if self._fused:
                    self.state, snap = self._full(self.state, frames, cam_times)
                else:
                    det = self._detect(frames)
                    self.state, snap = self._step(self.state, det, cam_times)
                packed = pack_snapshot(snap)
            if self.device.type == "cuda":
                # the step's time, as the JAX tracker blocks on it here: one
                # event wait a frame, which the sync-debug mode does not flag;
                # it also ends the frame's copy out of :meth:`_stage`'s buffer
                done = torch.cuda.Event()
                done.record()
                done.synchronize()

        with self.spans("drain", frame_num):
            # one read (pack_snapshot: every field exact in float64)
            states, ids, classes, mask, t = unpack_snapshot(HostSyncs.fetch(packed))
            self.rows.append((frame_num, float(self.epoch + float(t)), ids[mask], states[mask], classes[mask]))
        if self.on_frame is not None:
            self.on_frame(frame_num, np.asarray(frame)[None], snap, None)
        return snap

    def _stage(self, arr: np.ndarray) -> torch.Tensor:
        """A host array as a tensor the device copies from without blocking:
        on the card, in a pinned buffer kept a shape (the last frame's copy
        from it is over: each frame waits for its step before the next)."""
        host = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return host
        key = (tuple(host.shape), host.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        return buf.copy_(host)

    def track(self, frames: Iterable[Tuple[np.ndarray, float]], cutoff: int = 10**9):
        start = time.perf_counter()
        n = 0
        for frame_num, (frame, t_abs) in enumerate(frames):
            if frame_num >= cutoff:
                break
            self.process_frame(frame, t_abs, frame_num)
            n += 1
        wall = time.perf_counter() - start
        return {"frames": n, "fps": n / max(wall, 1e-9), **self.timers}

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
