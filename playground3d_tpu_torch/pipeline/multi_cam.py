"""Multi-camera crop tracker (port of ``playground3d_tpu/pipeline/multi_cam.py``,
reference ``MC_Crop_Tracker``, MC3D_crop_tracker.py).

Tracks live in the shared roadway frame across N cameras: full-frame
detection every ``det_step`` frames, crop re-detection every ``skip_step``
frames in between, a passthrough snapshot otherwise, continuous-time
Kalman rolls against per-camera clocks and online clock-bias estimation.

The JAX package runs a clip as one ``lax.scan`` with a 3-way ``lax.switch``;
here it is a host loop that picks the branch from the global frame index
(the host knows it, so picking costs no device read) and, on the card,
replays that branch as one CUDA graph. Nothing inside a clip reads the
device: the NMS and auction loops run in their own kernels, and
:meth:`MultiCameraTracker.track_clips` reads each clip's results once,
three clips later.

Two frame transports, chosen by the detector's stem: ``"s2d"`` frames are
space-to-depth packed ``[C,H/4,W/4,48]`` (uint8 or float; raw ``[C,H,W,3]``
frames are packed on the device, and planar YUV420 bytes are converted
there by :func:`yuv420_flat_to_s2d`) and the crop branch crops them with
:func:`~playground3d_tpu_torch.ops.crop_mxu.crop_and_resize_s2d`; ``"conv7"``
frames are raw NHWC and are cropped with
:func:`~playground3d_tpu_torch.ops.roi_align.crop_and_resize`. Both crops
are hand-written CUDA kernels on the card.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from playground3d_tpu_torch import DeviceLike, resolve_device
from playground3d_tpu_torch.evaluation import geometry_np as G
from playground3d_tpu_torch.evaluation.csv_io import TrackRecord, write_results_csv
from playground3d_tpu_torch.geometry import transforms as T
from playground3d_tpu_torch.models.resnet import space_to_depth
from playground3d_tpu_torch.models.retinanet import (
    Candidates,
    Detections,
    RetinaNet,
    detect_multiframe,
    frame_anchors,
    frames_candidates,
    gather_candidates,
    image_candidates,
    imagenet_mean_std,
    localize,
    merge_candidates,
)
from playground3d_tpu_torch.ops.crop_mxu import crop_and_resize_s2d, max_crop_span_s2d
from playground3d_tpu_torch.ops.iou import elementwise_iou, pairwise_iou
from playground3d_tpu_torch.ops.roi_align import crop_and_resize
from playground3d_tpu_torch.ops.topk import HostSyncs, top_k
from playground3d_tpu_torch.ops.yuv420 import yuv420_flat_to_s2d
from playground3d_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    canonical_device,
    replicate,
    shard_batch,
    shard_devices,
)
from playground3d_tpu_torch.pipeline.camera_bank import (
    CameraBank,
    bank_from_registry,
    im_to_state_refined,
    state_to_im_banked,
)
from playground3d_tpu_torch.pipeline.graphs import StaticGraphs, clone_state, copy_into, state_leaves
from playground3d_tpu_torch.pipeline.tracker_state import (
    ParsedDetections,
    Snapshot,
    TrackState,
    associate_and_update,
    init_track_state,
    lifecycle,
    pack_snapshot,
    parse_detections_pre,
    snapshot,
    space_nms_parsed,
    stack_snapshots,
    unpack_snapshot,
)
from playground3d_tpu_torch.track.kf import KFParams, default_params, kf_predict, kf_update, kf_view
from playground3d_tpu_torch.utils.config import TrackerConfig, camera_centers, tracking_x_range
from playground3d_tpu_torch.utils.constants import (
    CLASS_HEIGHTS,
    CLASS_NAMES,
    NUM_CLASSES,
)
from playground3d_tpu_torch.utils.profiling import Spans


# ---------------------------------------------------------------------------
# online clock-bias estimation (MC3D_crop_tracker.py:237-316)
# ---------------------------------------------------------------------------


def estimate_ts_bias(
    parsed: ParsedDetections,
    state: TrackState,
    ts_bias: torch.Tensor,  # [C]
    kfp: KFParams,
    cfg: TrackerConfig,
) -> torch.Tensor:
    """EMA update of per-camera clock bias from cross-camera detection pairs
    whose roadway footprints overlap: the x-offset over the direction's mean
    tracked speed is an observed dt, compared with the camera-clock dt.
    Camera 0 is the reference; each camera takes the mean of its pairs."""
    C = ts_bias.shape[0]
    dev = ts_bias.device
    live = state.kf.mask
    v = state.kf.x[:, 5]
    d = state.kf.d
    eb = live & (d > 0)
    wb = live & (d < 0)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def mean_speed(sel):
        mean = torch.sum(torch.where(sel, v, zero)) / torch.clamp(torch.sum(sel), min=1)
        return torch.where(torch.any(sel), mean, kfp.mu_v)

    eb_speed, wb_speed = mean_speed(eb), mean_speed(wb)

    fp = T.space_footprint_xyxy(T.state_to_space(parsed.state))
    iou = pairwise_iou(fp, fp)
    cam = parsed.cam_idx.long()
    valid_pair = (
        parsed.mask[:, None] & parsed.mask[None, :]
        & (cam[:, None] != cam[None, :]) & (iou > cfg.phi_nms_space)
    )
    dx = parsed.state[None, :, 0] - parsed.state[:, None, 0]  # x_j - x_i
    x_vel = torch.where(parsed.state[:, 5] > 0, eb_speed, -wb_speed)
    x_vel = torch.where(
        torch.abs(x_vel) > 1.0, x_vel, torch.sign(x_vel) * 1.0 + (x_vel == 0).to(torch.float32)
    )
    dt_obs = dx / x_vel[:, None]
    raw_times = parsed.times - ts_bias[cam]
    dt_expected = raw_times[None, :] - raw_times[:, None]
    time_error = dt_obs - dt_expected
    target = -time_error + ts_bias[cam][None, :]
    w = valid_pair.to(torch.float32)
    num = torch.zeros((C,), dtype=torch.float32, device=dev).index_add(0, cam, torch.sum(w * target, dim=1))
    den = torch.zeros((C,), dtype=torch.float32, device=dev).index_add(0, cam, torch.sum(w, dim=1))
    mean_target = num / torch.clamp(den, min=1.0)
    has_update = (den > 0) & (torch.arange(C, device=dev) != 0)
    return torch.where(
        has_update, (1 - cfg.ts_alpha) * ts_bias + cfg.ts_alpha * mean_target, ts_bias
    )


# ---------------------------------------------------------------------------
# crop re-detection branch (MC3D_crop_tracker.py:1146-1254)
# ---------------------------------------------------------------------------


def select_crop_slots(
    live: torch.Tensor, fsld: torch.Tensor, age: torch.Tensor, K: int
) -> torch.Tensor:
    """Stale-first crop schedule: the K live slots longest without a
    detection (fsld), oldest first on ties, lower slot first after that."""
    pri = torch.where(
        live,
        fsld.to(torch.float32) * 1024.0 + torch.clamp(age, max=1023).to(torch.float32),
        torch.full_like(fsld, -1, dtype=torch.float32),
    )
    return top_k(pri, K)[1]


def _normalize_crops(crops: torch.Tensor) -> torch.Tensor:
    mean, std = imagenet_mean_std(1, crops.device)
    return (crops / 255.0 - mean) / std


def make_crop_step(
    crop_model: RetinaNet,
    bank: CameraBank,
    centers: torch.Tensor,  # [C,2] camera view centres in roadway coords
    kfp: KFParams,
    cfg: TrackerConfig,
    stem: str = "conv7",
    frame_stem: str = "conv7",
):
    """(state, frames, cam_times [C], ts_bias [C]) -> (state', snapshot).
    ``frames`` is [C,H,W,3] when ``frame_stem == "conv7"`` or s2d-packed
    [C,H/4,W/4,48] (uint8 or float) when ``frame_stem == "s2d"``; ``stem`` is
    the crop net's own stem and decides the layout the crops are made in.
    For each of the ``cfg.crop_slots`` stalest live slots (all slots when
    0): nearest camera, roll to its clock, project, crop, re-detect, pick
    the best candidate by (1-W)*IoU + W*conf, Kalman-update."""
    for name, value in (("stem", stem), ("frame_stem", frame_stem)):
        if value not in ("conv7", "s2d"):
            raise ValueError(f"make_crop_step: {name} must be 'conv7' or 's2d', got {value!r}")
    if crop_model.stem != stem:
        raise ValueError(f"make_crop_step: stem={stem!r} but the crop net was built with {crop_model.stem!r}")
    cs = cfg.cs
    class_heights = torch.as_tensor(CLASS_HEIGHTS, device=centers.device)

    @torch.no_grad()
    def step(state: TrackState, frames: torch.Tensor, cam_times: torch.Tensor, ts_bias: torch.Tensor):
        N = state.ids.shape[0]
        dev = state.ids.device
        live = state.kf.mask
        K = cfg.crop_slots if (cfg.crop_slots and cfg.crop_slots < N) else N
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        t_mean = torch.mean(cam_times)

        pre = kf_view(state.kf, torch.where(live, t_mean - state.t_off, zero), kfp)
        if K < N:
            sel = select_crop_slots(live, state.fsld, state.age, K)
        else:
            sel = torch.arange(N, device=dev)
        live_k = live[sel]

        # nearest camera per selected object (MC3D:1156-1164)
        pre_k = pre[sel]
        d2 = (pre_k[:, 0:1] - centers[None, :, 0]) ** 2 + (pre_k[:, 1:2] - centers[None, :, 1]) ** 2
        cam_k = torch.argmin(d2, dim=1)

        # roll each selected object to its camera's bias-corrected clock;
        # unselected slots keep dt = 0 (identity predict)
        obj_t = cam_times[cam_k] + ts_bias[cam_k]
        dt_k = torch.where(live_k, obj_t - state.t_off[sel], zero)
        dt = torch.zeros((N,), dtype=torch.float32, device=dev).index_put((sel,), dt_k)
        kf1 = kf_predict(state.kf, dt, kfp)
        t_off = state.t_off.index_put((sel,), torch.where(live_k, obj_t, state.t_off[sel]))

        state6_k = torch.cat([kf1.x[sel, :5], kf1.d[sel, None]], dim=1)
        im_objs = state_to_im_banked(bank, state6_k, cam_k)  # [K,8,2]

        # square crop boxes, expanded (MC3D get_crop_boxes:920-945)
        hull = T.im_hull_xyxy(im_objs)
        w = hull[:, 2] - hull[:, 0]
        h = hull[:, 3] - hull[:, 1]
        scale = torch.maximum(w, h) * cfg.crop_expand
        if frame_stem == "s2d":
            # the s2d crop cannot represent a box beyond its coarsest window
            # (992 px at the defaults): clamp before the box is built, so the
            # crop-to-frame mapping below matches the pixels really cropped
            scale = torch.clamp(scale, max=max_crop_span_s2d())
        cx = (hull[:, 0] + hull[:, 2]) / 2
        cy = (hull[:, 1] + hull[:, 3]) / 2
        crop_boxes = torch.stack(
            [cx - scale / 2, cy - scale / 2, cx + scale / 2, cy + scale / 2], dim=1
        )

        if frame_stem == "s2d":
            crops = crop_and_resize_s2d(
                frames, crop_boxes, cam_k.to(torch.int32), out_size=cs,
                layout="s2d" if stem == "s2d" else "hwc",
                normalize=frames.dtype == torch.uint8,
            )
        else:
            # uint8 frames are cropped in place (the kernel converts in
            # registers) and normalized here, as the JAX branch normalizes
            crops = crop_and_resize(frames, crop_boxes, cam_k.to(torch.int32), out_size=cs)
            if frames.dtype == torch.uint8:
                crops = _normalize_crops(crops)

        reg_boxes, cls = localize(crop_model, crops)
        confs = torch.amax(cls, dim=2)
        classes = torch.argmax(cls, dim=2)

        top_conf, top_idx = top_k(confs, cfg.cd_max)  # [K,cd]
        rows = torch.arange(K, device=dev)[:, None]
        cand = reg_boxes[rows, top_idx]  # [K,cd,20]
        cand_cls = classes[rows, top_idx]

        # local crop coords -> global frame coords (MC3D local_to_global:948-971)
        corners = cand[:, :, :16].reshape(K, cfg.cd_max, 8, 2)
        corners = corners * (scale / cs)[:, None, None, None]
        corners = corners + crop_boxes[:, None, None, 0:2]

        flat = corners.reshape(K * cfg.cd_max, 8, 2)
        flat_cam = cam_k[:, None].expand(K, cfg.cd_max).reshape(-1)  # repeat_interleave, no host read
        heights = class_heights[cand_cls.reshape(-1)]
        cand_state = im_to_state_refined(bank, flat, flat_cam, heights).reshape(K, cfg.cd_max, 6)

        # best box per object: (1-W)*IoU(footprint, a-priori) + W*conf
        apri_fp = T.space_footprint_xyxy(T.state_to_space(state6_k))
        cand_fp = T.space_footprint_xyxy(
            T.state_to_space(cand_state.reshape(K * cfg.cd_max, 6))
        ).reshape(K, cfg.cd_max, 4)
        ious = elementwise_iou(cand_fp, apri_fp[:, None, :])
        score = (1 - cfg.w_conf) * ious + cfg.w_conf * top_conf
        best = torch.argmax(score, dim=1)
        rows_k = torch.arange(K, device=dev)
        best_state = cand_state[rows_k, best]
        best_conf = top_conf[rows_k, best]
        best_cls = cand_cls[rows_k, best]

        # crop measurement update (model 2), scattered back to the pool
        meas = torch.zeros((N, 5), dtype=torch.float32, device=dev).index_put(
            (sel,), best_state[:, :5].to(torch.float32)
        )
        no = torch.zeros((N,), dtype=torch.bool, device=dev)
        upd = no.index_put((sel,), live_k)
        good = no.index_put((sel,), live_k & (best_conf >= cfg.sigma_c))
        kf_upd = (upd & good) if cfg.crop_conf_gate else upd
        kf2 = kf_update(kf1, meas, kf_upd, kfp, measurement_idx=2)

        if cfg.size_nudge:
            # class-size nudge (model 3) toward the voted class's mean size
            voted = torch.argmax(state.cls_votes, dim=1)
            kf2 = kf_update(kf2, kfp.class_size[voted], kf_upd, kfp, measurement_idx=3)

        izero = torch.zeros_like(state.fsld)
        fsld = torch.where(good, izero, state.fsld + (live & ~good).to(torch.int32))
        misses = torch.where(good, izero, state.misses + (upd & ~good).to(torch.int32))
        good_k = live_k & (best_conf >= cfg.sigma_c)
        one_hot = Fn.one_hot(best_cls, NUM_CLASSES).to(torch.float32)
        votes = state.cls_votes.index_put(
            (sel,), torch.where(good_k[:, None], one_hot, zero), accumulate=True
        )
        conf_sum = state.conf_sum.index_put(
            (sel,), torch.where(live_k, best_conf, zero), accumulate=True
        )
        conf_cnt = state.conf_cnt.index_put((sel,), live_k.to(torch.float32), accumulate=True)

        new_state = state._replace(
            kf=kf2, fsld=fsld, misses=misses, age=state.age + live.to(torch.int32),
            cls_votes=votes, conf_sum=conf_sum, conf_cnt=conf_cnt, t_off=t_off,
        )
        new_state = lifecycle(new_state, t_mean, kfp, cfg)
        return new_state, snapshot(new_state, t_mean, kfp, cfg)

    return step


def _detect_tail(state, pre, ts_bias, cam_times, kfp, cfg):
    """Shared tail of the detect branch: clock bias, roadway NMS,
    association, lifecycle, snapshot."""
    ts_bias2 = estimate_ts_bias(pre, state, ts_bias, kfp, cfg) if cfg.estimate_ts_bias else ts_bias
    parsed = space_nms_parsed(pre, cfg)
    t_ref = torch.mean(cam_times)
    state, _, _ = associate_and_update(state, parsed, t_ref, kfp, cfg)
    state = lifecycle(state, t_ref, kfp, cfg)
    return state, snapshot(state, t_ref, kfp, cfg), ts_bias2


def make_mc_detect_step(det_model: RetinaNet, bank: CameraBank, kfp: KFParams, cfg: TrackerConfig):
    """(state, frames [C,H,W,3], cam_times [C], ts_bias [C]) ->
    (state', snapshot, ts_bias'): the full-frame detection branch with
    clock-bias estimation (MC3D track() detect branch :1068-1139)."""

    @torch.no_grad()
    def step(state: TrackState, frames: torch.Tensor, cam_times: torch.Tensor, ts_bias: torch.Tensor):
        det = detect_multiframe(
            det_model, frames, pre_topk=cfg.pre_topk, max_dets=cfg.max_dets,
            approx_topk=cfg.approx_topk, min_level=cfg.det_min_level,
        )
        pre = parse_detections_pre(det, bank, cam_times + ts_bias, cfg)
        return _detect_tail(state, pre, ts_bias, cam_times, kfp, cfg)

    return step


def make_mc_detect_step_from_detections(bank: CameraBank, kfp: KFParams, cfg: TrackerConfig):
    """Detect-branch step taking precomputed :class:`Detections`."""

    @torch.no_grad()
    def step(state: TrackState, det: Detections, cam_times: torch.Tensor, ts_bias: torch.Tensor):
        pre = parse_detections_pre(det, bank, cam_times + ts_bias, cfg)
        return _detect_tail(state, pre, ts_bias, cam_times, kfp, cfg)

    return step


def _leaves(x) -> tuple:
    return (x,) if isinstance(x, torch.Tensor) else tuple(x)


def _parts_like(parts: list, device: torch.device):
    """An empty buffer on ``device`` for ``parts`` (tensors, or named
    tuples of them) concatenated on their leading dimension."""
    first = parts[0]
    leaves = [torch.empty((sum(_leaves(p)[i].shape[0] for p in parts),) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=device) for i, t in enumerate(_leaves(first))]
    return leaves[0] if isinstance(first, torch.Tensor) else type(first)(*leaves)


def _copy_parts(dst, parts: list) -> None:
    """Copy ``parts`` one after another into ``dst``'s leading dimension
    (from any device: a copy between cards waits for both cards' streams)."""
    off = 0
    for p in parts:
        n = _leaves(p)[0].shape[0]
        for d, x in zip(_leaves(dst), _leaves(p)):
            d[off:off + n].copy_(x)
        off += n


def _concat(parts: list, device: torch.device):
    """``parts`` concatenated on ``device`` (the eager counterpart of a
    static buffer filled by :func:`_copy_parts`)."""
    if not isinstance(parts[0], torch.Tensor):
        return gather_candidates(parts, device)
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts])


def _run_branches(branches: dict, names: List[str], state: TrackState, ts_bias: torch.Tensor,
                  inputs: Callable[[int, str], object], cam_times: torch.Tensor):
    """Frame ``li`` of ``names`` through branch ``names[li]``, which reads
    ``inputs(li, name)``; -> (state', ts_bias', snapshots stacked over the
    frames)."""
    st, tb, snaps = state, ts_bias, []
    for li, name in enumerate(names):
        st, tb, snap = branches[name](st, tb, inputs(li, name), cam_times[li])
        snaps.append(snap)
    return st, tb, stack_snapshots(snaps)


class _BranchGraphs:
    """The clip's branches over one set of static buffers: the tracker
    state, ``ts_bias``, each branch's own input (a frame of all cameras, or
    a frame's candidates), the camera times and the snapshot.
    Each branch reads the buffers and writes its new state, bias and
    snapshot back into them, so a frame is: copy its inputs in, run the
    branch (one CUDA graph replay on the card, :class:`StaticGraphs`), copy
    the snapshot out. An input is given as a list of parts (the camera
    shards' frames or candidates, on their own devices), gathered into
    one buffer on this device, the parts one after another."""

    def __init__(self, branches: dict, device: torch.device):
        self.branches = branches  # name -> fn(state, ts_bias, input, cam_times) -> (state, ts_bias, snap)
        self.programs = StaticGraphs(device)
        self.state = self.ts_bias = self.cam_times = self.snap = None
        self.inputs: dict = {}  # branch name -> its static input: a tensor or a named tuple of them

    def load(self, state: TrackState, ts_bias: torch.Tensor, cam_times: torch.Tensor):
        """Copy a clip's starting state and bias in (allocating the buffers
        at the first clip)."""
        if self.state is None:
            self.state, self.ts_bias = clone_state(state), ts_bias.clone()
            self.cam_times = torch.empty_like(cam_times)
            like = self.branches["passthrough"](self.state, self.ts_bias, None, cam_times)[2]
            self.snap = Snapshot(*(torch.empty_like(x) for x in like))
            return
        copy_into(state_leaves(self.state), state_leaves(state))
        self.ts_bias.copy_(ts_bias)

    def run(self, name: str, parts: Optional[list], cam_times: torch.Tensor) -> None:
        """One frame through branch ``name``: ``parts`` is its input, a list
        of tensors or of named tuples of them to concatenate (None for a
        branch that reads none)."""
        self.cam_times.copy_(cam_times)
        if parts is not None:
            if name not in self.inputs:
                self.inputs[name] = _parts_like(parts, self.programs.device)
            _copy_parts(self.inputs[name], parts)
        self.programs.run(name, lambda write_back: self._body(name, write_back))

    def _body(self, name: str, write_back: bool):
        st, tb, snap = self.branches[name](self.state, self.ts_bias, self.inputs.get(name), self.cam_times)
        if write_back:
            copy_into(state_leaves(self.state), state_leaves(st))
            self.ts_bias.copy_(tb)
            copy_into(self.snap, snap)


class _ShardDetect:
    """One camera shard's half of the clip's detect branch, on the shard's
    device: its cameras' frame (``"frame"``) or the clip's detect frames
    (``"batched"``) copied into a static buffer, then the shard's detector
    and its top-k candidates (one CUDA graph a program on the card), left
    in buffers that every run rewrites, for the lead device to gather."""

    def __init__(self, model: RetinaNet, device: torch.device, first_image: int, cfg: TrackerConfig):
        self.model, self.first = model, first_image
        self.kw = dict(pre_topk=cfg.pre_topk, min_level=cfg.det_min_level)
        self.programs = StaticGraphs(device)
        self.frames: dict = {}
        self.out: dict = {}  # program -> its Candidates ([k] or, batched, [J,k] each)

    def run(self, name: str, frames: torch.Tensor) -> Candidates:
        if name not in self.frames:
            self.frames[name] = torch.empty_like(frames)
        self.frames[name].copy_(frames)
        self.programs.run(name, lambda write_back: self._body(name, write_back))
        return self.out[name]

    def _body(self, name: str, write_back: bool):
        fn = frames_candidates if name == "batched" else image_candidates
        out = fn(self.model, self.frames[name], first_image=self.first, **self.kw)
        if write_back:
            self.out[name] = out


class _UnrolledClip:
    """``unroll``: the clip's T frames, each through the branch its
    clip-local index picks, as ONE program over static ``[T,C,...]`` frame,
    ``[T,C]`` camera-time and ``[T]`` snapshot buffers and the state and
    bias: on the card one CUDA graph, so a clip is one replay."""

    def __init__(self, branches: dict, schedule: List[str], device: torch.device):
        self.branches, self.schedule = branches, schedule  # schedule: the branch of each clip-local frame
        self.programs = StaticGraphs(device)
        self.state = self.ts_bias = self.frames = self.cam_times = self.snaps = None

    def run(self, state: TrackState, ts_bias: torch.Tensor, frames: torch.Tensor, cam_times: torch.Tensor):
        if self.state is None:
            self.state, self.ts_bias = clone_state(state), ts_bias.clone()
            self.frames, self.cam_times = frames.clone(), cam_times.clone()
        else:
            copy_into(state_leaves(self.state), state_leaves(state))
            copy_into((self.ts_bias, self.frames, self.cam_times), (ts_bias, frames, cam_times))
        self.programs.run("clip", self._body)

    def _body(self, write_back: bool):
        # the snapshots are stacked before the state is written: a snapshot may alias the input state
        st, tb, stacked = _run_branches(self.branches, self.schedule, self.state, self.ts_bias,
                                        lambda li, name: self.frames[li], self.cam_times)
        if write_back:
            copy_into(state_leaves(self.state), state_leaves(st))
            self.ts_bias.copy_(tb)
            self.snaps = stacked  # on the card the capture's outputs: every replay rewrites them in place


def make_mc_clip_step(
    det_model: RetinaNet,
    bank: CameraBank,
    centers: torch.Tensor,
    kfp: KFParams,
    cfg: TrackerConfig,
    crop_model: Optional[RetinaNet] = None,
    stem: str = "s2d",
    crop_stem: str = "s2d",
    graphs: bool = True,
    batch_detects: bool = False,
    unroll: bool = False,
    mesh: Optional[Mesh] = None,
):
    """(state, ts_bias, frames [T,C,...], cam_times [T,C], frame0 int) ->
    (state', ts_bias', snapshots stacked over T): frame ``i`` (global index
    ``frame0 + i``) takes the detect branch when ``i % det_step == 0``, the
    crop branch when ``i % skip_step == 0``, a passthrough snapshot
    otherwise (the reference's cadence loop, MC3D_crop_tracker.py:1051-1254).

    As in the JAX clip, the branch follows the global frame index and the
    clock-bias update of a detect frame applies to the frames after it.
    ``stem`` is the detector's stem and the frames' transport ("s2d":
    packed [T,C,H/4,W/4,48]; "conv7": raw [T,C,H,W,3]), ``crop_stem`` the
    crop net's.

    The JAX clip is one program: a ``lax.scan`` over a ``lax.switch`` of the
    three branches. Here the host picks the branch from the frame index (no
    device read) and runs it over static buffers (:class:`_BranchGraphs`):
    on the card it replays that branch's CUDA graph, so no host read
    happens inside the clip; on the CPU it runs the same buffers and
    write-backs without capture. ``graphs=False`` runs the branch functions
    eagerly instead, on any device (the reference the graphs are held
    to).

    The frames' camera axis is split over the camera shards of ``mesh``
    (JAX's camera-sharded clip); without one, the frames' device is the one
    shard. ``frames`` is one tensor ``[T,C,...]`` (split and copied) or,
    with a mesh, one ``[T,C/n,...]`` tensor a mesh device, on it (as
    :meth:`MultiCameraTracker.track_clips` stages them). Each shard runs
    the detector (a replica a mesh device) over its cameras and takes their
    top-k (:func:`image_candidates`; one program :class:`_ShardDetect` of
    its own); only those candidates move to the lead device
    ``mesh.devices[0]``, which holds the state, the bias, the crop net and
    every branch, merges them (:func:`merge_candidates`) and parses. The
    crop branch gathers the crop frame's cameras to the lead. On the card
    each device's programs are CUDA graphs of its own, and the copies
    between devices run between replays. The cameras must divide over the
    mesh.

    The JAX clip's two variants (both need ``frame0 % det_step == 0``, and
    raise ``ValueError`` otherwise):

    * ``batch_detects``: the detector and top-k of the clip's detect frames
      ``frames[::det_step]`` run before the branches, as one detector
      forward over ``ceil(T/det_step)`` frames of a shard's cameras
      (:func:`frames_candidates`, a program of its own); the top-k pool, the
      merge and the NMS stay per frame.
    * ``unroll``: a straight-line clip, each frame's branch picked from its
      clip-local index (so with a crop net ``frame0 % skip_step == 0`` is
      needed too), the detect branch whole (:func:`make_mc_detect_step`).
      On the card the whole clip is ONE CUDA graph per frame shape, dtype
      and T: a clip is one replay. As in JAX, ``batch_detects`` has no
      effect with it, and a ``mesh`` raises ``ValueError``.
    """
    if det_model.stem != stem:
        raise ValueError(f"make_mc_clip_step: stem={stem!r} but the detector was built with {det_model.stem!r}")
    if unroll and mesh is not None:
        raise ValueError(
            "make_mc_clip_step: unroll=True is not supported together with a mesh (the sharded clip is the "
            "three-branch clip); pass unroll=False"
        )
    detect_step = make_mc_detect_step(det_model, bank, kfp, cfg)
    parsed_step = make_mc_detect_step_from_detections(bank, kfp, cfg)
    crop_step = (
        make_crop_step(crop_model, bank, centers, kfp, cfg, stem=crop_stem, frame_stem=stem)
        if crop_model is not None else None
    )
    d, s = cfg.det_step, cfg.skip_step

    def check_aligned(frame0: int) -> None:
        # batch_detects pairs the hoisted detections with clip-local detect
        # frames and the unrolled clip branches on the clip-local index
        if frame0 % d != 0:
            raise ValueError(
                f"clip frame0={frame0} must be a multiple of det_step={d} for the "
                "batch_detects/unroll clip variants (clip-local cadence)"
            )
        if unroll and crop_step is not None and frame0 % s != 0:
            raise ValueError(
                f"clip frame0={frame0} must be a multiple of skip_step={s} for the "
                "unrolled clip's crop cadence"
            )

    def b_detect(st, tb, f, t):
        st2, snap, tb2 = detect_step(st, f, t, tb)
        return st2, tb2, snap

    def b_parsed(st, tb, det, t):
        st2, snap, tb2 = parsed_step(st, det, t, tb)
        return st2, tb2, snap

    def b_crop(st, tb, f, t):
        st2, snap = crop_step(st, f, t, tb)
        return st2, tb, snap

    def b_skip(st, tb, f, t):
        return st, tb, snapshot(st, torch.mean(t), kfp, cfg)

    branches = {"detect": b_detect, "crop": b_crop if crop_step is not None else b_skip, "passthrough": b_skip}
    runners: dict = {}  # (lead device, frame shape, dtype[, T or J]) -> _BranchGraphs or _UnrolledClip
    shard_runners: dict = {}  # the same keys -> a _ShardDetect a camera shard
    replicas = replicate(mesh, det_model) if mesh is not None else None

    def which(i: int) -> str:
        if i % d == 0:
            return "detect"
        return "crop" if crop_step is not None and i % s == 0 else "passthrough"

    def camera_shards(frames):
        """(the mesh, its camera shards of ``frames``, a detector a shard);
        without a mesh, the frames' device alone."""
        if mesh is None:
            if not isinstance(frames, torch.Tensor):
                raise ValueError("make_mc_clip_step: frames given as camera shards need a mesh")
            return Mesh((frames.device,)), [frames], (det_model,)
        if isinstance(frames, torch.Tensor):
            return mesh, list(shard_batch(mesh, frames, dim=1)), replicas
        shards = list(frames)
        shard_devices(mesh, shards, "make_mc_clip_step")
        if len({tuple(x.shape) for x in shards}) != 1:
            raise ValueError(f"make_mc_clip_step: camera shards of shapes {[tuple(x.shape) for x in shards]}")
        return mesh, shards, replicas

    def unrolled(state, ts_bias, frames: torch.Tensor, cam_times: torch.Tensor):
        # the unrolled clip's branches follow the clip-local index (equal to
        # the global cadence once frame0 is aligned)
        names = [which(li) for li in range(frames.shape[0])]
        if not graphs:
            return _run_branches(branches, names, state, ts_bias, lambda li, name: frames[li], cam_times)
        key = (frames.device, tuple(frames.shape[1:]), frames.dtype, frames.shape[0])
        runner = runners.get(key)
        if runner is None:
            runner = runners[key] = _UnrolledClip(branches, names, frames.device)
        runner.run(state, ts_bias, frames, cam_times)
        return clone_state(runner.state), runner.ts_bias.clone(), Snapshot(*(x.clone() for x in runner.snaps))

    @torch.no_grad()
    def clip(state: TrackState, ts_bias: torch.Tensor, frames, cam_times: torch.Tensor, frame0: int):
        frame0 = int(frame0)
        if batch_detects or unroll:
            check_aligned(frame0)
        if unroll:
            return unrolled(state, ts_bias, frames, cam_times)
        m, shards, models = camera_shards(frames)
        T_len, lead = shards[0].shape[0], m.lead
        firsts = np.cumsum([0] + [x.shape[1] for x in shards]).tolist()
        names = [which(frame0 + li) for li in range(T_len)]
        anchors = frame_anchors(shards[0][0], stem, cfg.det_min_level)  # shard 0 lies on the lead

        def b_merged(st, tb, cands, t):
            det = merge_candidates(cands, anchors, firsts[-1], m.size, pre_topk=cfg.pre_topk, max_dets=cfg.max_dets)
            return b_parsed(st, tb, det, t)

        def gathered(li: int, name: str, frame_cands: Callable[[int], Candidates], hoisted):
            """What frame ``li``'s branch gathers on the lead: each shard's
            cameras of the frame (crop), or each shard's candidates
            (detect; batched, the clip's detect frame ``li // d``)."""
            if name == "passthrough":
                return None
            if name == "crop":
                return [x[li] for x in shards]
            if hoisted is not None:
                return [Candidates(*(x[li // d] for x in c)) for c in hoisted]
            return [frame_cands(i) for i in range(m.size)]

        if not graphs:
            kw = dict(pre_topk=cfg.pre_topk, min_level=cfg.det_min_level)
            hoisted = ([frames_candidates(md, x[::d], first_image=f, **kw) for md, x, f in zip(models, shards, firsts)]
                       if batch_detects else None)

            def inputs(li, name):
                parts = gathered(li, name, lambda i: image_candidates(models[i], shards[i][li], first_image=firsts[i],
                                                                      **kw), hoisted)
                return None if parts is None else _concat(parts, lead)

            return _run_branches(dict(branches, detect=b_merged), names, state, ts_bias, inputs, cam_times)

        key = (lead, tuple(shards[0].shape[1:]), shards[0].dtype) + ((len(range(0, T_len, d)),) if batch_detects else ())
        runner = runners.get(key)
        if runner is None:
            # b_merged's anchors and camera offsets follow from the key alone
            runner = runners[key] = _BranchGraphs(dict(branches, detect=b_merged), lead)
            shard_runners[key] = [_ShardDetect(md, x.device, f, cfg) for md, x, f in zip(models, shards, firsts)]
        sds = shard_runners[key]
        runner.load(state, ts_bias, cam_times[0])
        hoisted = [sd.run("batched", x[::d]) for sd, x in zip(sds, shards)] if batch_detects else None
        out = Snapshot(*(torch.empty((T_len,) + tuple(x.shape), dtype=x.dtype, device=x.device)
                         for x in runner.snap))
        for li, name in enumerate(names):
            runner.run(name, gathered(li, name, lambda i: sds[i].run("frame", shards[i][li]), hoisted), cam_times[li])
            for dst, src in zip(out, runner.snap):
                dst[li].copy_(src)
        return clone_state(runner.state), runner.ts_bias.clone(), out

    clip.runners = runners
    clip.shard_runners = shard_runners
    return clip


class MultiCameraTracker:
    """Host driver for N-camera tracking with crop re-detection.

    ``sources`` are per-camera iterators of (frame [H,W,3], t_abs). The
    models must already sit on ``device`` (the card unless the caller asks
    for the CPU); frames are shipped there as they arrive. ``graphs`` is
    :func:`make_mc_clip_step`'s (True: each branch a CUDA graph on the
    card; False: eager).

    ``ignore_polygons`` ({camera: [n,2] polygon in ``image_hw`` pixels,
    reference ignored_regions/*.csv) become the bank's ignore grid, made on
    the device before any branch is captured: detections whose box centre
    falls in a camera's region are dropped at parse time. ``on_frame``, if
    given, is called as ``on_frame(frame_num, frames [C,...], snapshot,
    ts_bias [C])`` after each :meth:`process` step (the reference's overlay
    loop, MC3D:733-917); the clip loop :meth:`track_clips` does not call
    it."""

    def __init__(
        self,
        registry,
        cameras: Sequence[str],
        cfg: Optional[TrackerConfig] = None,
        kf_params: Optional[KFParams] = None,
        det_model: Optional[RetinaNet] = None,
        crop_model: Optional[RetinaNet] = None,
        detect_fn: Optional[Callable] = None,
        centers: Optional[np.ndarray] = None,
        stem: str = "conv7",
        crop_stem: str = "conv7",
        device: DeviceLike = None,
        graphs: bool = True,
        ignore_polygons=None,
        image_hw: Tuple[int, int] = (1080, 1920),
        on_frame: Optional[Callable] = None,
    ):
        self.device = resolve_device(device)
        self.graphs = graphs  # make_mc_clip_step's: True = CUDA graphs on the card
        self.stem, self.crop_stem = stem, crop_stem
        self.registry = registry
        self.cameras = list(cameras)
        if cfg is None:
            try:
                x_range = tracking_x_range(self.cameras)
            except KeyError:
                x_range = (0.0, 2000.0)
            cfg = TrackerConfig(x_range=x_range)
        self.cfg = cfg
        self.kfp = kf_params if kf_params is not None else default_params(device=self.device)
        self.bank = bank_from_registry(
            registry, ignore_polygons=ignore_polygons, image_hw=image_hw, device=self.device
        )
        if centers is None:
            centers = np.asarray(camera_centers(self.cameras), np.float32)
        self.centers = torch.as_tensor(np.asarray(centers, np.float32), device=self.device)

        self.detect_fn = detect_fn
        if detect_fn is None:
            if det_model is None:
                raise ValueError("MultiCameraTracker needs det_model or detect_fn")
            if det_model.stem != stem:
                raise ValueError(
                    f"MultiCameraTracker: stem={stem!r} but the detector was built with {det_model.stem!r}"
                )
            self._detect_step = make_mc_detect_step(det_model, self.bank, self.kfp, cfg)
        else:
            self._parsed_step = make_mc_detect_step_from_detections(self.bank, self.kfp, cfg)
        self._det_model = det_model
        self._crop_model = crop_model
        self._clip = None
        self._mesh_clips: dict = {}  # mesh -> its camera-sharded clip
        self._crop_step = (
            make_crop_step(crop_model, self.bank, self.centers, self.kfp, cfg,
                           stem=crop_stem, frame_stem=stem)
            if crop_model is not None else None
        )

        self.state = init_track_state(cfg.max_tracks, self.device)
        self.ts_bias = torch.zeros((len(self.cameras),), dtype=torch.float32, device=self.device)
        self.epoch: Optional[float] = None
        self.rows: List[tuple] = []
        self.ts_bias_log: List[np.ndarray] = []
        # host seconds a span (:class:`Spans`): ``process`` enqueues a branch
        # ("detect", "crop") and reads a frame back ("drain"); for
        # :meth:`track_clips`' spans see its docstring
        self.spans = Spans(("source", "stack", "stage", "put_wait", "get_wait", "enqueue", "drain", "drain_wait",
                            "track_clips", "detect", "crop"))
        self.timers = self.spans.totals
        self.on_frame = on_frame

    def _append_row(self, frame_num, t_off, ids, mask, states, classes, bias):
        self.rows.append(
            (frame_num, float(self.epoch + float(t_off)), ids[mask], states[mask], classes[mask])
        )
        self.ts_bias_log.append(bias)

    @torch.no_grad()
    def process(self, frames: np.ndarray, times: Sequence[float], frame_num: int) -> Snapshot:
        """One frame of all cameras: frames [C,H,W,3]; times per camera."""
        if self.epoch is None:
            self.epoch = float(min(times))
        cam_times = torch.as_tensor(
            np.asarray([t - self.epoch for t in times], np.float32), device=self.device
        )
        frames_t = torch.as_tensor(np.asarray(frames), device=self.device)
        if self.stem == "s2d" and frames_t.shape[-1] == 3:
            frames_t = space_to_depth(frames_t, 4)  # raw frames are packed on the device

        if frame_num % self.cfg.det_step == 0:
            with self.spans("detect", frame_num):
                if self.detect_fn is None:
                    self.state, snap, self.ts_bias = self._detect_step(
                        self.state, frames_t, cam_times, self.ts_bias
                    )
                else:
                    det = self.detect_fn(frames_t, frame_num)
                    self.state, snap, self.ts_bias = self._parsed_step(
                        self.state, det, cam_times, self.ts_bias
                    )
        elif self._crop_step is not None and frame_num % self.cfg.skip_step == 0:
            with self.spans("crop", frame_num):
                self.state, snap = self._crop_step(self.state, frames_t, cam_times, self.ts_bias)
        else:
            with self.spans("drain", frame_num):
                snap = snapshot(self.state, torch.mean(cam_times), self.kfp, self.cfg)

        with self.spans("drain", frame_num):
            bias = self.ts_bias.cpu().numpy()
            self._append_row(
                frame_num, snap.t.cpu(), snap.ids.cpu().numpy(), snap.raw_mask.cpu().numpy(),
                snap.states7.cpu().numpy(), snap.classes.cpu().numpy(), bias,
            )
        if self.on_frame is not None:
            self.on_frame(frame_num, frames, snap, bias)
        return snap

    def _synced_frames(self, sources: List[Iterable], cutoff: int, sync_ms: float, clip_len: int = 1):
        """Yield (frames [C,H,W,3], times [C]); cameras lagging the latest
        timestamp by >= sync_ms skip frames (MC3D time_sync_cameras:219-235).
        Spans: "source" (the pulls, skips included) and "stack", each of the
        clip of ``clip_len`` frames the frame falls in."""
        iters = [iter(s) for s in sources]
        for k in range(cutoff):
            clip = k - k % clip_len
            with self.spans("source", clip):
                try:
                    cur = [next(it) for it in iters]
                    latest = max(c[1] for c in cur)
                    for i in range(len(iters)):
                        while latest - cur[i][1] >= sync_ms / 1000.0:
                            cur[i] = next(iters[i])
                except StopIteration:
                    return
            with self.spans("stack", clip):
                frames = np.stack([c[0] for c in cur])
            yield frames, [c[1] for c in cur]

    def track(self, sources: List[Iterable], cutoff: int = 10**9, sync_ms: float = 20.0,
              per_frame: bool = False, clip_len: int = 24, mesh: Optional[Mesh] = None,
              yuv_hw: Optional[Tuple[int, int]] = None):
        """Track all sources to exhaustion: the clip loop
        (:meth:`track_clips`, camera-sharded over ``mesh`` when one is given)
        when the detector is available, else (or with ``per_frame=True``)
        one :meth:`process` per frame."""
        if not per_frame and self.detect_fn is None:
            return self.track_clips(sources, clip_len=clip_len, cutoff=cutoff, sync_ms=sync_ms, mesh=mesh,
                                    yuv_hw=yuv_hw)
        start = time.perf_counter()
        n = 0
        for frame_num, (frames, times) in enumerate(self._synced_frames(sources, cutoff, sync_ms)):
            self.process(frames, times, frame_num)
            n += 1
        wall = time.perf_counter() - start
        return {"frames": n, "fps": n / max(wall, 1e-9), **self.timers}

    def _clip_fn(self, mesh: Optional[Mesh] = None):
        """The clip step (one a mesh, camera-sharded over it); a mesh's lead
        device must be the tracker's."""
        if mesh is not None:
            if mesh.lead != canonical_device(self.device):
                raise ValueError(f"the mesh's lead device {mesh.lead} is not the tracker's {self.device}")
            if mesh not in self._mesh_clips:
                self._mesh_clips[mesh] = make_mc_clip_step(
                    self._det_model, self.bank, self.centers, self.kfp, self.cfg, crop_model=self._crop_model,
                    stem=self.stem, crop_stem=self.crop_stem, graphs=self.graphs, mesh=mesh,
                )
            return self._mesh_clips[mesh]
        if self._clip is None:
            self._clip = make_mc_clip_step(
                self._det_model, self.bank, self.centers, self.kfp, self.cfg,
                crop_model=self._crop_model, stem=self.stem, crop_stem=self.crop_stem, graphs=self.graphs,
            )
        return self._clip

    @torch.no_grad()
    def track_clips(self, sources: List[Iterable], clip_len: int = 24, cutoff: int = 10**9,
                    sync_ms: float = 20.0, mesh: Optional[Mesh] = None,
                    yuv_hw: Optional[Tuple[int, int]] = None):
        """Clip host loop (JAX ``track_clips``): one clip step per
        ``clip_len`` frames; a background thread reads the next clip into
        pinned host memory and stages it on a side stream (the copy to the
        card and the s2d packing or YUV conversion) while the current clip
        runs, and the clip's stream waits for it by an event. The host never
        waits inside a clip: each clip's results are packed into one tensor
        and fetched with one read, drained with a lag of 3 clips.

        With a ``mesh`` (its lead device the tracker's) the clip is
        camera-sharded (:func:`make_mc_clip_step`): each mesh device's
        cameras are staged on it, through pinned memory of their own and a
        side stream of that device, where the YUV conversion runs too.

        ``yuv_hw``: the frames' (H, W) when the sources emit flat planar
        YUV420 bytes; colour conversion and s2d packing then run on the
        device (:func:`yuv420_flat_to_s2d`), which halves the bytes copied
        to it. Needs ``stem="s2d"``.

        Spans (:class:`Spans`; their host seconds add to :attr:`timers`):
        the call ("track_clips"); the producer's "source", "stack", "stage"
        and "put_wait"; the consumer's "get_wait", "enqueue" (each graph's
        "replay.<name>" inside it) and "drain" (its wait for the read
        "drain_wait"). A call that starts while a ``torch.profiler`` runs
        records them whole in ``Spans.log``, each with the first frame index
        of its clip, and times each replay on the device."""
        if self.detect_fn is not None or self._det_model is None:
            raise ValueError("track_clips needs det_model (not a detect_fn)")
        if yuv_hw is not None and self.stem != "s2d":
            raise ValueError(
                "track_clips(yuv_hw=...) requires stem='s2d' (the on-device YUV conversion "
                f"emits s2d-packed frames); this tracker has stem={self.stem!r}"
            )
        with Spans.recorded_if_profiled(), self.spans("track_clips") as root:
            n, wall = self._clip_loop(sources, clip_len, cutoff, sync_ms, mesh, yuv_hw, root)
        return {"frames": n, "fps": n / max(wall, 1e-9), **self.timers}

    def _clip_loop(self, sources, clip_len, cutoff, sync_ms, mesh, yuv_hw, root) -> Tuple[int, float]:
        """:meth:`track_clips`' loop, inside its span ``root`` (None unless
        recording) -> (frames read back, host seconds)."""
        clip = self._clip_fn(mesh)
        on_card = self.device.type == "cuda"
        # (device, its cameras) of each shard; without a mesh, one shard of every camera
        shards = ([(self.device, slice(None))] if mesh is None
                  else list(zip(mesh.devices, batch_sharding(mesh, len(self.cameras)))))
        stage_streams = [torch.cuda.Stream(dev) if on_card else None for dev, _ in shards]
        q: queue.Queue = queue.Queue(maxsize=2)
        done = object()
        producer_err: list = []

        def stage(bufs: List[torch.Tensor], times: List[List[float]]):
            """A clip's frames, [T,C,...] a shard in (pinned) host memory ->
            the device tensors the clip takes and the events they are ready
            at (the camera times go to the tracker's device)."""
            tt = torch.as_tensor(np.asarray(times, np.float32))
            fts, readies = [], []
            for (dev, _), stream, buf in zip(shards, stage_streams, bufs):
                with torch.cuda.stream(stream) if on_card else contextlib.nullcontext():
                    ft = buf.to(dev, non_blocking=True)
                    if not fts:
                        tt = tt.pin_memory().to(self.device, non_blocking=True) if on_card else tt
                    if yuv_hw is not None and ft.ndim == 3:
                        ft = yuv420_flat_to_s2d(ft, (int(yuv_hw[0]), int(yuv_hw[1])))
                    elif self.stem == "s2d" and ft.shape[-1] == 3:
                        t, c = ft.shape[:2]
                        ft = space_to_depth(ft.reshape((t * c,) + tuple(ft.shape[2:])), 4)
                        ft = ft.reshape((t, c) + tuple(ft.shape[1:]))
                    if on_card:
                        readies.append(torch.cuda.Event())
                        readies[-1].record(stream)
                fts.append(ft)
            return fts, tt, readies

        def producer():
            bufs, times = None, []
            frame0 = 0
            try:
                with Spans.within(root):
                    for frames, ts in self._synced_frames(sources, cutoff, sync_ms, clip_len):
                        if self.epoch is None:
                            self.epoch = float(min(ts))
                        with self.spans("stage", frame0):
                            host = torch.from_numpy(frames)
                            if bufs is None:
                                bufs = [torch.empty((clip_len,) + tuple(host[cams].shape), dtype=host.dtype,
                                                    pin_memory=on_card) for _, cams in shards]
                            for buf, (_, cams) in zip(bufs, shards):
                                buf[len(times)].copy_(host[cams])
                            times.append([t - self.epoch for t in ts])
                            staged = stage(bufs, times) if len(times) == clip_len else None
                        if staged is not None:
                            with self.spans("put_wait", frame0):
                                q.put((staged, frame0))
                            frame0 += clip_len
                            bufs, times = None, []
                    if times:
                        with self.spans("stage", frame0):
                            staged = stage([buf[:len(times)] for buf in bufs], times)
                        with self.spans("put_wait", frame0):
                            q.put((staged, frame0))
            except BaseException as e:  # noqa: BLE001 - re-raised on the consumer side
                producer_err.append(e)
            finally:
                q.put(done)

        thread = threading.Thread(target=producer, name="track_clips producer", daemon=True)
        thread.start()
        start = time.perf_counter()
        n = 0
        drain_lag = 3  # clips in flight before the oldest is read back (JAX's drain_lag)
        pending: list = []  # (read, frame0, rows' shape, staged inputs held until their clip is read)

        def drain_one():
            nonlocal n
            read, frame0, shape, _ = pending.pop(0)
            with self.spans("drain", frame0):
                with self.spans("drain_wait", frame0):
                    packed = read()
                Spans.settle(frame0)  # the clip's replays are over: read their device times
                rows = packed[:-len(self.cameras)].reshape(shape)
                bias = packed[-len(self.cameras):].astype(np.float32)
                states, ids, classes, mask, ts = unpack_snapshot(rows)
                for k in range(shape[0]):
                    self._append_row(frame0 + k, ts[k], ids[k], mask[k], states[k], classes[k], bias)
                n += shape[0]

        while True:
            with self.spans("get_wait") as waited:
                item = q.get()
            if item is done:
                break
            (fts, tt, readies), frame0 = item
            if waited is not None:
                waited.clip = frame0
            with self.spans("enqueue", frame0):
                for (dev, _), ready in zip(shards, readies):
                    torch.cuda.current_stream(dev).wait_event(ready)
                self.state, self.ts_bias, snaps = clip(self.state, self.ts_bias,
                                                       fts if mesh is not None else fts[0], tt, frame0)
                # one read a clip: its snapshots [T, N, 11] and the bias it returned
                rows = pack_snapshot(snaps)
                read = HostSyncs.fetch_later(torch.cat([rows.reshape(-1), self.ts_bias.to(torch.float64)]))
                pending.append((read, frame0, tuple(rows.shape), (fts, tt)))
            while len(pending) > drain_lag:
                drain_one()
        while pending:
            drain_one()
        thread.join(timeout=10)
        if producer_err:
            raise producer_err[0]
        return n, time.perf_counter() - start

    # -- output --------------------------------------------------------------
    def records(self, camera: Optional[str] = None) -> List[TrackRecord]:
        """The rows as CSV records in ``camera``'s image (the first camera by
        default), each with the clock biases of its frame."""
        cam = camera or self.cameras[0]
        c = self.registry.index(cam)
        out = []
        for k, (frame_num, t_abs, ids, states, classes) in enumerate(self.rows):
            if len(ids) == 0:
                continue
            im = G.state_to_im_banked(states, self.registry.P[c, 0], self.registry.P[c, 1])
            space = G.state_to_space(states)
            bias = list(np.round(self.ts_bias_log[k], 6)) if self.ts_bias_log else None
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
                        camera=cam,
                        ts_bias=bias,
                    )
                )
        return out

    def write_results_csv(self, path: str, camera: Optional[str] = None) -> None:
        write_results_csv(path, self.records(camera), ts_bias_cameras=self.cameras)
